// Left-right consistency check (cv2's LR rule) of both SGBM paths.
//
// Replaces the kernel body stereo_vision_tpu/stereo/lr_pallas.py::_lr_kernel
// in both of its forms:
//   lr_fail_pallas_packed (hier assembly)  -> lr_fail_kernel: the WTA's
//     packed (cost, winner) map and the 16x fixed-point disparity d16 of the
//     valid columns x >= ndisp, min_disparity 0;
//   lr_fail_pallas (exact path)            -> lr_fail_unpacked_kernel: the
//     int32 minS and best maps (best without min_disparity) and the float32
//     disparity (with it) of the columns x >= min_x, any min_disparity >= 0.
// Both compute the mask of pixels cv2's LR rule invalidates:
//
//   disp2[x2] = the disparity (best + mindisp) of the least packed value
//     (cost * 2048 + best + mindisp, so ties go to the smaller disparity)
//     among the valid left pixels x = x2 + best + mindisp: cv2's projection
//     of the left disparities onto the right view; empty -> -1024;
//   the pixel fails where both lookups disp2[x - floor(d)] and
//     disp2[x - ceil(d)] hold a disparity >= mindisp that differs from the
//     lookup's own by more than max_diff (lookups outside the frame, or with
//     a shift outside [mindisp - 1, mindisp + ndisp], read -1024 and pass).
//
// The TPU kernel transposes 128-row blocks so that its shifts become
// sublane slices and selects the lookups in two stages; here disp2 is built
// in shared memory with atomicMin (a min, so the order of the threads does
// not matter) and every pixel then reads its two lookups by a direct index:
// the packed form a warp a row (lr_fail_kernel), the unpacked form a block a
// row (lr_fail_unpacked_kernel), both from 16-byte words. Bounds on an H100
// (bytes: each map read once, the mask written once): hier4x3 full res, 32
// frames of 720 rows, 1152 valid columns: 233 MB, ~70 us at 3.35 TB/s;
// exact8, 4 frames, three maps in: 43 MB, ~13 us.

#include "common.cuh"

namespace {

constexpr int kSentinel = 1 << 30;
constexpr int kOob = -(1 << 10);

// The packed form (#10), a warp a (frame, row). Replaces
// lr_pallas.py:261 lr_fail_pallas_packed -> _lr_kernel:30.
//
// What bounds it on an H100: bytes. It reads the pack and d16 maps once
// and writes the mask once: at hier4x3's full level (32 frames of 720 rows,
// 1152 valid columns) 9 bytes a pixel, 233 MB, 0.071 ms at 3.35 TB/s. The
// first design (one block of 256 threads a row: 23,040 blocks, two block
// barriers and ~10 KB each) ran at half of that.
//
// Design: a warp takes a row, with the row's disp2 in its own slice of
// shared memory, so that __syncwarp alone orders the phases and a block
// holds as many rows as its shared memory allows (kLrWarps at most); the
// warps persist and walk rows, and load the first kLrAhead words a lane of
// the next row's two maps during this row's lookups. The warp reads the
// maps as 16-byte words of 4 pixels (where Wv % 4 != 0 a row's first and
// last words hold pixels of its neighbours, which it skips, and a word past
// the maps' end is read a value at a time), the rest of a row kLrAhead
// words a lane at a time, a batch's loads issued before its work; the
// atomicMin scatter, then the lookups write 4 results a lane as one 32-bit
// store (single bytes where a word crosses a row's edge). atomicMin is a
// minimum, so the order of the scatters does not matter.
constexpr int kLrWarps = 8;
constexpr int kLrAhead = 2;  // words a lane of each map loaded ahead, and a batch after them
// Blocks an SM holds at least: registers held to 64 a thread, as many warps
// (rows) at once as 5 KB rows of shared memory leave room for.
constexpr int kLrBlocks = 4;

// The unpacked form (#9): words a thread of each map in a batch, and the
// most threads a row.
constexpr int kLrRowWords = 2;
constexpr int kLrRowThreads = 256;



// Word i (4 elements) of a row whose first element sits `off` (0-3) past a
// 16-byte boundary at m; `tail` elements of the flat map from that boundary
// on, so that a word past the map's end is read a value at a time.
__device__ __forceinline__ int4 load_word(const int* __restrict__ m, int i, long long tail) {
  if (4LL * i + 4 <= tail) return __ldg(reinterpret_cast<const int4*>(m) + i);
  int v[4] = {0, 0, 0, 0};
  for (int j = 0; j < 4 && 4LL * i + j < tail; ++j) v[j] = __ldg(m + 4 * i + j);
  return make_int4(v[0], v[1], v[2], v[3]);
}

// A row's place in the flat (rows, Wv) maps: its first element sits `off`
// (0-3) past the 16-byte word at `first`; nw words hold its pixels, and
// `tail` elements run from `first` to the maps' end.
struct LrRow {
  long long first, tail;
  int off, nw;
  __device__ __forceinline__ LrRow(int row, int rows, int Wv, bool aligned) {
    const long long e0 = (long long)row * Wv;
    off = aligned ? 0 : (int)(e0 & 3);
    first = e0 - off;
    nw = (off + Wv + 3) >> 2;
    tail = (long long)rows * Wv - first;
  }
};

// kAligned: Wv % 4 == 0, so that every row starts on 16 bytes and holds
// whole words (every main path: Wv = 1152). Persistent warps: warp w takes
// rows w, w + nwarps, ...; the first kLrAhead words a lane of the next
// row's maps are loaded during this row's lookups.
template <bool kAligned>
__global__ void __launch_bounds__(kLrWarps * 32, kLrBlocks)
lr_fail_kernel(const int* __restrict__ pack, const int* __restrict__ d16, uint8_t* __restrict__ fail, int rows, int W,
               int Wv, int ndisp, int max_diff, int WS) {
  extern __shared__ __align__(16) int lr_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x >> 5);
  int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp: only __syncwarp below
  int* disp2 = lr_smem + (size_t)warp * WS;  // [WS >= W], WS % 4 == 0

  int4 pnext[kLrAhead], dnext[kLrAhead];
  auto prefetch = [&](int r) {
    const LrRow g(r, rows, Wv, kAligned);
#pragma unroll
    for (int u = 0; u < kLrAhead; ++u) {
      const int i = lane + 32 * u;
      if (i < g.nw) {
        pnext[u] = load_word(pack + g.first, i, g.tail);
        dnext[u] = load_word(d16 + g.first, i, g.tail);
      }
    }
  };
  prefetch(row);
  for (; row < rows; row += nwarps) {
    const LrRow g(row, rows, Wv, kAligned);
    const int off = g.off, nw = g.nw;
    const int* pk = pack + g.first;
    const int* dd = d16 + g.first;
    for (int i = lane; i < WS / 4; i += 32)
      reinterpret_cast<int4*>(disp2)[i] = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
    __syncwarp();

    auto scatter = [&](int i, int4 pw) {
      const int pv[4] = {pw.x, pw.y, pw.z, pw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xv = 4 * i + e - off;  // the pixel's column in the valid region
        if (!kAligned && (xv < 0 || xv >= Wv)) continue;  // a neighbouring row's pixel
        const int p = pv[e], d = p & 2047, x2 = xv + ndisp - d;
        if (d < ndisp && x2 >= 0 && x2 < W) atomicMin(&disp2[x2], p);
      }
    };
#pragma unroll
    for (int u = 0; u < kLrAhead; ++u)
      if (lane + 32 * u < nw) scatter(lane + 32 * u, pnext[u]);
    // The rest of the row kLrAhead words a lane at a time, each batch's
    // loads issued before its scatter.
    for (int base = 32 * kLrAhead; base < nw; base += 32 * kLrAhead) {
      int4 pw[kLrAhead];
#pragma unroll
      for (int u = 0; u < kLrAhead; ++u)
        if (base + lane + 32 * u < nw) pw[u] = load_word(pk, base + lane + 32 * u, g.tail);
#pragma unroll
      for (int u = 0; u < kLrAhead; ++u)
        if (base + lane + 32 * u < nw) scatter(base + lane + 32 * u, pw[u]);
    }
    int4 dcur[kLrAhead];
#pragma unroll
    for (int u = 0; u < kLrAhead; ++u) dcur[u] = dnext[u];
    if (row + nwarps < rows) prefetch(row + nwarps);
    __syncwarp();

    auto lookups = [&](int i, int4 dv) {
      const int vv[4] = {dv.x, dv.y, dv.z, dv.w};
      unsigned r = 0;  // byte e: element e's verdict
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v16 = vv[e];
        const int df = v16 >> 4, dc = (v16 + 15) >> 4;  // floor and ceil of v16 / 16
        const int x = 4 * i + e - off + ndisp;
        bool both = true;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int sh = k ? dc : df;
          const int c = x - sh;
          int v = kOob;
          if (sh >= -1 && sh <= ndisp && c >= 0 && c < W) {
            const int q = disp2[c];
            v = q >= kSentinel ? kOob : (q & 2047);
          }
          both &= v >= 0 && abs(v - sh) > max_diff;
        }
        r |= (both ? 1u : 0u) << (8 * e);
      }
      uint8_t* out = fail + g.first + 4 * i;
      if (kAligned || (4 * i - off >= 0 && 4 * i + 4 - off <= Wv)) {
        *reinterpret_cast<unsigned*>(out) = r;
      } else {
        for (int j = 0; j < 4; ++j)
          if (4 * i + j - off >= 0 && 4 * i + j - off < Wv) out[j] = (r >> (8 * j)) & 1;
      }
    };
#pragma unroll
    for (int u = 0; u < kLrAhead; ++u)
      if (lane + 32 * u < nw) lookups(lane + 32 * u, dcur[u]);
    for (int base = 32 * kLrAhead; base < nw; base += 32 * kLrAhead) {
      int4 dw[kLrAhead];
#pragma unroll
      for (int u = 0; u < kLrAhead; ++u)
        if (base + lane + 32 * u < nw) dw[u] = load_word(dd, base + lane + 32 * u, g.tail);
#pragma unroll
      for (int u = 0; u < kLrAhead; ++u)
        if (base + lane + 32 * u < nw) lookups(base + lane + 32 * u, dw[u]);
    }
    __syncwarp();  // every lookup has read disp2 before the next row resets it
  }
}

// The unpacked form (#9), a block a (frame, row). Replaces
// lr_pallas.py:195 lr_fail_pallas:137 -> _lr_kernel:30.
//
// What bounds it on an H100: bytes. It reads the minS, best and disparity
// maps once and writes the mask once, 13 bytes a pixel: at exact8 (4 frames
// of 720 rows, 1152 valid columns) 43 MB, 0.013 ms at 3.35 TB/s. The first
// design (256 threads a row, a value a thread at a time) made two global
// round trips a row one after the other, split by block barriers (minS and
// best for the scatter, then the disparity for the lookups), and reached
// 0.39 of that.
//
// Design: every load of a row is issued before its first dependent step.
// Each of the row's NT threads reads kLrRowWords 16-byte words of 4 pixels
// of each of the three maps (NT the least multiple of 32 with NT *
// kLrRowWords words covering the row, at most kLrRowThreads: exact8's 288
// words a row take 160 threads and one batch), as #10 does (LrRow /
// load_word: rows off 16 bytes take their edge words' neighbouring pixels,
// which they skip); the scatter runs from registers, and after the barrier
// the lookups read only registers and shared memory and write 4 results a
// thread as one 32-bit store. Wider rows take further batches, each one's
// loads issued before its work.
template <bool kAligned>
__global__ void __launch_bounds__(kLrRowThreads)
lr_fail_unpacked_kernel(const int* __restrict__ minS, const int* __restrict__ best, const int* __restrict__ disp,
                        uint8_t* __restrict__ fail, int rows, int W, int Wv, int min_x, int ndisp, int mindisp,
                        int max_diff) {
  extern __shared__ __align__(16) int disp2s[];  // [WS >= W], WS % 4 == 0
  const int NT = blockDim.x, tid = threadIdx.x;
  const LrRow g(blockIdx.x, rows, Wv, kAligned);
  const int off = g.off, nw = g.nw, WS = (W + 3) & ~3;
  const int* ms = minS + g.first;
  const int* bs = best + g.first;
  const int* dv = disp + g.first;
  const int maxD = mindisp + ndisp;

  int4 mw[kLrRowWords], bw[kLrRowWords], dw[kLrRowWords];
#pragma unroll
  for (int u = 0; u < kLrRowWords; ++u) {
    const int i = tid + NT * u;
    if (i < nw) {
      mw[u] = load_word(ms, i, g.tail);
      bw[u] = load_word(bs, i, g.tail);
      dw[u] = load_word(dv, i, g.tail);
    }
  }
  for (int i = tid; i < WS / 4; i += NT)
    reinterpret_cast<int4*>(disp2s)[i] = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
  __syncthreads();

  auto scatter = [&](int i, int4 m4, int4 b4) {
    const int mv[4] = {m4.x, m4.y, m4.z, m4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xv = 4 * i + e - off;  // the pixel's column in the valid region
      if (!kAligned && (xv < 0 || xv >= Wv)) continue;  // a neighbouring row's pixel
      const int b = bv[e], x2 = xv + min_x - (b + mindisp);
      // cost * 2048 + disparity in wrapping int32 arithmetic, as the plain form.
      const int p = static_cast<int>(static_cast<unsigned>(mv[e]) * 2048u + static_cast<unsigned>(b + mindisp));
      if (b >= 0 && b < ndisp && x2 >= 0 && x2 < W) atomicMin(&disp2s[x2], p);
    }
  };
#pragma unroll
  for (int u = 0; u < kLrRowWords; ++u)
    if (tid + NT * u < nw) scatter(tid + NT * u, mw[u], bw[u]);
  for (int base = NT * kLrRowWords; base < nw; base += NT * kLrRowWords) {
#pragma unroll
    for (int u = 0; u < kLrRowWords; ++u) {
      const int i = base + tid + NT * u;
      if (i < nw) {
        mw[u] = load_word(ms, i, g.tail);
        bw[u] = load_word(bs, i, g.tail);
      }
    }
#pragma unroll
    for (int u = 0; u < kLrRowWords; ++u)
      if (base + tid + NT * u < nw) scatter(base + tid + NT * u, mw[u], bw[u]);
  }
  __syncthreads();

  auto lookups = [&](int i, int4 d4) {
    const int vv[4] = {d4.x, d4.y, d4.z, d4.w};
    unsigned r = 0;  // byte e: element e's verdict
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = __int_as_float(vv[e]);
      const int df = static_cast<int>(floorf(d)), dc = static_cast<int>(ceilf(d));
      const int x = 4 * i + e - off + min_x;
      bool both = true;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int sh = k ? dc : df;
        const int c = x - sh;
        int v = kOob;
        if (sh >= mindisp - 1 && sh <= maxD && c >= 0 && c < W) {
          const int q = disp2s[c];
          v = q >= kSentinel ? kOob : (q & 2047);
        }
        both &= v >= mindisp && abs(v - sh) > max_diff;
      }
      r |= (both ? 1u : 0u) << (8 * e);
    }
    uint8_t* out = fail + g.first + 4 * i;
    if (kAligned || (4 * i - off >= 0 && 4 * i + 4 - off <= Wv)) {
      *reinterpret_cast<unsigned*>(out) = r;
    } else {
      for (int j = 0; j < 4; ++j)
        if (4 * i + j - off >= 0 && 4 * i + j - off < Wv) out[j] = (r >> (8 * j)) & 1;
    }
  };
#pragma unroll
  for (int u = 0; u < kLrRowWords; ++u)
    if (tid + NT * u < nw) lookups(tid + NT * u, dw[u]);
  for (int base = NT * kLrRowWords; base < nw; base += NT * kLrRowWords) {
#pragma unroll
    for (int u = 0; u < kLrRowWords; ++u)
      if (base + tid + NT * u < nw) dw[u] = load_word(dv, base + tid + NT * u, g.tail);
#pragma unroll
    for (int u = 0; u < kLrRowWords; ++u)
      if (base + tid + NT * u < nw) lookups(base + tid + NT * u, dw[u]);
  }
}

}  // namespace

// (rows, Wv) int32 pack (cost * 2048 + winner) and d16 of the valid columns
// x >= ndisp of rows of width W (both 16-byte aligned) -> (rows, Wv) uint8
// failure mask; a warp a row, as many rows a block (up to kLrWarps) as the
// shared memory a block may opt in to holds W ints of, as many blocks as the
// card holds at once.
SVT_EXPORT int svt_lr_fail_packed(const void* pack, const void* d16, void* fail, int rows, int W, int Wv, int ndisp,
                                  int max_diff, void* stream) {
  if (ndisp < 1 || ndisp >= 2048 || Wv != W - ndisp) return cudaErrorInvalidValue;
  if (rows == 0 || Wv <= 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int WS = (W + 3) & ~3;
  const int warps = min(kLrWarps, optin / (WS * (int)sizeof(int)));
  if (warps < 1) return cudaErrorInvalidValue;  // a row's disp2 fits no block
  const size_t smem = (size_t)warps * WS * sizeof(int);
  const auto kern = Wv % 4 == 0 ? lr_fail_kernel<true> : lr_fail_kernel<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // As many blocks as the card holds at once (each warp then walks rows),
  // fewer where there are fewer rows.
  const int blocks = max(1, min((rows + warps - 1) / warps, per_sm * sms));
  kern<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pack), static_cast<const int*>(d16), static_cast<uint8_t*>(fail), rows, W, Wv, ndisp,
      max_diff, WS);
  return cudaGetLastError();
}

// (rows, Wv) int32 minS and best (winner without mindisp) and float32
// disparity (with mindisp) of the columns x >= min_x of rows of width W ->
// (rows, Wv) uint8 failure mask.
SVT_EXPORT int svt_lr_fail(const void* minS, const void* best, const void* disp, void* fail, int rows, int W, int Wv,
                           int min_x, int ndisp, int mindisp, int max_diff, void* stream) {
  if (ndisp < 1 || mindisp < 0 || ndisp + mindisp >= 2048 || min_x < 0 || min_x + Wv > W)
    return cudaErrorInvalidValue;
  if (rows == 0 || Wv <= 0) return cudaSuccess;
  const bool aligned = Wv % 4 == 0;
  const int nw = aligned ? Wv / 4 : (Wv + 6) / 4;  // the words a row spans, at most
  const int per = (nw + kLrRowWords - 1) / kLrRowWords;
  const int NT = min(kLrRowThreads, (per + 31) / 32 * 32);
  const size_t smem = (size_t)((W + 3) & ~3) * sizeof(int);
  const auto kern = aligned ? lr_fail_unpacked_kernel<true> : lr_fail_unpacked_kernel<false>;
  if (smem > 48 * 1024) {  // a block takes more than 48 KB only by opting in (a host call each launch)
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<rows, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minS), static_cast<const int*>(best), static_cast<const int*>(disp),
      static_cast<uint8_t*>(fail), rows, W, Wv, min_x, ndisp, mindisp, max_diff);
  return cudaGetLastError();
}
