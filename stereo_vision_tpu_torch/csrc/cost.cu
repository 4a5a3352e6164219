// Windowed Birchfield-Tomasi cost volume for exact SGBM.
//
// Replaces stereo_vision_tpu/stereo/cost_pallas.py::cost_volume_pallas
// (kernel body _cost_kernel): clipped x-Sobel channel + raw channel, BT
// half-sample extrema of both, pixel cost sobel_BT + (raw_BT >> 2), then a
// block_size x block_size box sum with replicate borders over the FULL
// width, emitted only for columns x >= x_off. Output (B, H, W - x_off, D)
// int16, or int32 where the window's bound or the SGM scans need it (one
// template, both storage types). A disparity index d reads the right column
// x - max(d + mindisp, 0): the reference clamps a negative shift to 0.
//
// What bounds it on an H100: the int16 output, B*H*(W-x_off)*D*2 bytes
// (212 MB a 720p frame at D=128, about 63 us at 3.35 TB/s); the inputs are
// two int32 images. The TPU kernel shifted whole rows through VMEM with
// log2(D) masked sublane shifts because Mosaic has no gather; here a right
// sample x-d is a direct shared-memory index. What holds it back (PERF.md)
// is the instruction rate and shared memory: every (pixel, d) pair costs a
// pixel cost and four shared-memory accesses (the ring and the column sum,
// in and out), and every output a horizontal pass over the column sums.
//
// Design: a block owns one frame, a strip of kStrip output rows, a tile of
// TX output columns and a chunk of Dc = 32 * DPT disparities (the chunks on
// the grid, so any D runs and shared memory does not grow with D). It walks
// down the strip's kStrip + bs - 1 source rows, so each source row is
// staged once a strip and each pixel cost computed once a block (the
// window's bs - 1 halo rows and columns are the only work done twice). The
// window spans -r .. bs - 1 - r, r = bs / 2, about its centre: an even
// block, as the reference's, reaches one less below and to the right. Per source row:
//   S1. the clipped x-Sobel and the raw value of the row's left columns
//       (the window's, +-1) and right columns (those the chunk's shifts
//       reach, +-1), one thread a column, from image values loaded a row
//       ahead into registers;
//   S2. their BT half-sample extrema, packed for the pixel cost: Sobel in
//       the low and raw in the high halfword of four words a column;
//   R.  the row pass: the pixel cost of both channels at once with Hopper's
//       16x2 DPX add-max and min (pixel_cost); it enters a ring of bs rows
//       (int16) and the rolling column sum V[j][d] (int32) adds it and
//       subtracts the cost of the row leaving the window, read from the
//       ring. Where no window column and no shift is clamped (nearly every
//       block), each warp walks a run of consecutive columns and its lane
//       element e takes d = e + t at the run's column t: (j, d) and
//       (j + 1, d + 1) read the same right column, held in registers for
//       the run; elsewhere each warp takes columns j, j + 4, ... with the
//       lane's disparities lane + 32 q, the right samples of a warp 32
//       consecutive words either way;
//   H.  once the window is full, the horizontal box: each warp walks a run
//       of output columns with a running sum over d = DPT * lane + q (V read
//       as one DPT-wide vector a column), stored as one 8-byte (int16) or
//       16-byte (int32) vector a lane.
// No division at run time: d is the fastest thread index, Dc a template
// constant. V and the ring take NC * Dc * (4 + 2 bs) bytes (NC = TX + bs - 1);
// TX is 32, 24, 16 or 8, the widest that leaves four blocks an SM (24 at
// block 5, D >= 128), else three, two, one; where none fits (large
// blocks), V and the ring live in a slot of device scratch, one a resident
// block, and the blocks walk the (chunk, tile, strip, frame) items.

#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

using svt::clampi;
using svt::extrema;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStrip = 32;  // output rows a block walks down
constexpr int kAhead = 2;   // staging columns a thread loads a row ahead (more: loaded at once)

// Disparities a lane takes: Dc = 32 * DPT a chunk.
int dpt_for(int D) { return D <= 32 ? 1 : D <= 64 ? 2 : 4; }

// Bytes of a block's memory for a tile of TX output columns, a chunk of Dc
// disparities and block bs: `rings` (V [NC][Dc] int32, then the ring
// [bs][NC][Dc] int16), and `stage` (the channels of a column, packed: [NC]
// left and [NRcap] right uint4; then the Sobel and raw rows of S1,
// [2][NC + NRcap + 4] int32).
struct Layout {
  int NC, NRcap;
  size_t ring, rings, stage;
  __host__ __device__ Layout(int TX, int Dc, int bs) {
    NC = TX + bs - 1;
    NRcap = NC + Dc - 1;
    ring = (size_t)NC * Dc * 4;
    rings = (ring + (size_t)bs * NC * Dc * 2 + 15) / 16 * 16;
    stage = (size_t)(NC + NRcap) * 16 + (size_t)2 * (NC + NRcap + 4) * 4;
  }
};

// A column's six BT channels packed for the pixel cost: the Sobel channel
// in the low halfword, the raw channel in the high one, as x = (value, its
// half-minimum, minus the value, minus its half-maximum). Exact while the
// channels and their differences fit 16 bits (8-bit images: the Sobel
// channel lies in [0, 2 ftzero], the raw one in [0, 255]).
__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (static_cast<unsigned>(lo) & 0xffffu) | (static_cast<unsigned>(hi) << 16);
}
__device__ __forceinline__ uint4 pack_channels(const int (&s)[3], const int (&r)[3]) {
  return make_uint4(pack2(s[0], r[0]), pack2(s[1], r[1]), pack2(-s[0], -r[0]), pack2(-s[2], -r[2]));
}

// sobel_BT + (raw_BT >> 2) of a left and a right column, both channels at
// once in 16-bit halves (Hopper's DPX integer add-max / min): with
// BT = min(max(l - v1, v0 - l, 0), max(l0 - v, v - l1, 0)).
__device__ __forceinline__ int pixel_cost(const uint4& l, const uint4& v) {
  constexpr unsigned kLow = 0x80008000u;  // -32768 in both halves: max(x, kLow) == x
  const unsigned c0 = __viaddmax_s16x2_relu(l.x, v.w, __viaddmax_s16x2(v.y, l.z, kLow));
  const unsigned c1 = __viaddmax_s16x2_relu(l.y, v.z, __viaddmax_s16x2(v.x, l.w, kLow));
  const unsigned c = __vimin_s16x2_relu(c0, c1);
  return static_cast<int>((c & 0xffffu) + (c >> 18));
}

template <typename T, int N>
struct Vec;
template <>
struct Vec<int16_t, 1> {
  static __device__ __forceinline__ void store(int16_t* p, const int (&v)[1]) { *p = static_cast<int16_t>(v[0]); }
};
template <>
struct Vec<int16_t, 2> {
  static __device__ __forceinline__ void store(int16_t* p, const int (&v)[2]) {
    *reinterpret_cast<short2*>(p) = make_short2(v[0], v[1]);
  }
};
template <>
struct Vec<int16_t, 4> {
  static __device__ __forceinline__ void store(int16_t* p, const int (&v)[4]) {
    *reinterpret_cast<short4*>(p) = make_short4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<int, 1> {
  static __device__ __forceinline__ void store(int* p, const int (&v)[1]) { *p = v[0]; }
};
template <>
struct Vec<int, 2> {
  static __device__ __forceinline__ void store(int* p, const int (&v)[2]) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  }
};
template <>
struct Vec<int, 4> {
  static __device__ __forceinline__ void store(int* p, const int (&v)[4]) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
};

// N consecutive int32 of shared (or scratch) memory, 4 * N-byte aligned.
template <int N>
__device__ __forceinline__ void load_ints(const int* p, int (&v)[N]) {
  if constexpr (N == 4) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else if constexpr (N == 2) {
    const int2 w = *reinterpret_cast<const int2*>(p);
    v[0] = w.x, v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

// One block's work: output rows of strip `strip`, the TX columns of tile
// `tile` and the disparities of chunk `chunk` of frame b. V and the ring at
// `rings` (shared memory or a slot of device scratch), the staging at `stage`
// (shared memory).
template <typename T, int DPT>
__device__ __forceinline__ void cost_block(unsigned char* rings, int* stage, const int* __restrict__ left,
                                           const int* __restrict__ right, T* __restrict__ out, int H, int W, int D,
                                           int mindisp, int bs, int ftzero, int x_off, int TX, int chunk, int tile,
                                           int strip, int b) {
  constexpr int Dc = 32 * DPT;
  const Layout lay(TX, Dc, bs);
  const int NC = lay.NC, NRcap = lay.NRcap;
  int* V = reinterpret_cast<int*>(rings);
  int16_t* ring = reinterpret_cast<int16_t*>(rings + lay.ring);
  uint4* chL = reinterpret_cast<uint4*>(stage);  // packed channels of columns cmin..
  uint4* chR = chL + NC;                          // of columns qlo..
  int* tS = reinterpret_cast<int*>(chR + NRcap);  // Sobel of left columns cmin - 1 .., then right columns qlo - 1 ..
  int* tR = tS + NC + NRcap + 4;                   // raw values of the same columns

  // The window spans -r .. bs - 1 - r about its centre (r = bs / 2; an even
  // block reaches one less below and to the right, as the reference's).
  const int r = bs / 2, r1 = bs - 1 - r, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dc0 = chunk * Dc, dn = min(Dc, D - dc0);
  const int x0 = x_off + tile * TX;
  const int y0 = strip * kStrip, nsrc = min(kStrip, H - y0) + bs - 1;
  const int Wo = W - x_off;
  const int cmin = clampi(x0 - r, 0, W - 1), cmax = clampi(x0 + TX - 1 + r1, 0, W - 1);
  const int smin = max(dc0 + mindisp, 0), smax = max(dc0 + dn - 1 + mindisp, 0);
  const int qlo = cmin - smax, qhi = cmax - smin;  // right columns (below 0: column 0)
  const int nL = cmax - cmin + 1, nR = qhi - qlo + 1, nT = nL + nR + 4;
  const int* L = left + (size_t)b * H * W;
  const int* R = right + (size_t)b * H * W;
  // Right index of disparity dl of the chunk for left index il: column
  // (il + cmin) - max(dc0 + dl + mindisp, 0), counted from qlo.
  int sh[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) sh[q] = cmin - qlo - max(dc0 + lane + 32 * q + mindisp, 0);
  // The diagonal form of the row pass, where no window column and no shift
  // of the chunk is clamped and the chunk is whole: right index il - d + Dc
  // - 1 with il = j, so that (j, d) and (j + 1, d + 1) read one right
  // column; each warp then takes a run of cpw consecutive columns.
  const int cpw = (NC + kWarps - 1) / kWarps;
  const bool diag = x0 - r >= 0 && x0 + TX - 1 + r1 <= W - 1 && dc0 + mindisp >= 0 && dn == Dc && cpw <= 32;
  const int j0 = min(warp * cpw, NC), j1 = min(j0 + cpw, NC);
  // Output columns of this warp's runs in the horizontal pass.
  const int per = (TX + kWarps - 1) / kWarps;
  const int t0 = warp * per, t1 = min(min(t0 + per, TX), W - x0);
  const int dv = DPT * lane;  // the lane's first disparity there

  // S1's samples of staging column i of source row k: the raw values at
  // columns c -+ 1 of the rows above, at and below, and at c itself.
  auto samples = [&](int k, int i, int (&v)[7]) {
    const int yy = clampi(y0 - r + k, 0, H - 1);
    const bool isL = i < nL + 2;
    const int c = clampi(isL ? cmin - 1 + i : qlo - 1 + (i - nL - 2), 0, W - 1);
    const int cm = max(c - 1, 0), cp = min(c + 1, W - 1);
    const int* img = isL ? L : R;
    const int* rm = img + (size_t)max(yy - 1, 0) * W;
    const int* r0 = img + (size_t)yy * W;
    const int* rp = img + (size_t)min(yy + 1, H - 1) * W;
    v[0] = __ldg(rm + cm), v[1] = __ldg(rm + cp), v[2] = __ldg(r0 + cm), v[3] = __ldg(r0 + cp);
    v[4] = __ldg(rp + cm), v[5] = __ldg(rp + cp), v[6] = __ldg(r0 + c);
  };
  // The clipped x-Sobel (ftzero at columns 0 and W-1) and the raw value.
  auto put = [&](int i, const int (&v)[7]) {
    const bool isL = i < nL + 2;
    const int c = isL ? cmin - 1 + i : qlo - 1 + (i - nL - 2);
    const int dx = 2 * (v[3] - v[2]) + (v[1] - v[0]) + (v[5] - v[4]);
    tS[i] = c <= 0 || c >= W - 1 ? ftzero : clampi(dx, -ftzero, ftzero) + ftzero;
    tR[i] = v[6];
  };
  int pf[kAhead][7];  // the next row's samples, loaded a row ahead
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (tid + u * kThreads < nT) samples(0, tid + u * kThreads, pf[u]);

  for (int k = 0; k < nsrc; ++k) {
    // S1. Sobel and raw values of the columns the row needs, +-1; then the
    // loads of the next row's go out.
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (tid + u * kThreads < nT) put(tid + u * kThreads, pf[u]);
    for (int i = tid + kAhead * kThreads; i < nT; i += kThreads) {
      int v[7];
      samples(k, i, v);
      put(i, v);
    }
    if (k + 1 < nsrc) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (tid + u * kThreads < nT) samples(k + 1, tid + u * kThreads, pf[u]);
    }
    __syncthreads();
    // S2. The six BT channels of each column: value, half-minimum and
    // half-maximum of the Sobel and the raw value.
    for (int i = tid; i < nL + nR; i += kThreads) {
      const int it = i < nL ? i : i + 2;  // S1's left columns hold two more
      int sv[3], rv[3];
      extrema(tS[it + 1], tS[it], tS[it + 2], sv, 1);
      extrema(tR[it + 1], tR[it], tR[it + 2], rv, 1);
      (i < nL ? chL[i] : chR[i - nL]) = pack_channels(sv, rv);
    }
    __syncthreads();
    // R. The row's pixel costs into the ring and the column sums.
    const int slot = k % bs;
    if (diag && j0 < j1) {
      // Each warp walks its run of columns j0 + t; element e = lane + 32 q
      // of a lane takes d = e + t (wrapping past Dc into the lane's second
      // diagonal), whose right column j - d + Dc - 1 is the same at every t.
      uint4 rv[DPT], rw;
#pragma unroll
      for (int q = 0; q < DPT; ++q) rv[q] = chR[j0 - (lane + 32 * q) + Dc - 1];
      rw = chR[min(j0 - (lane + 32 * (DPT - 1)) + 2 * Dc - 1, NRcap - 1)];
      for (int t = 0; t < j1 - j0; ++t) {
        const int j = j0 + t;
        const uint4 a = chL[j];
#pragma unroll
        for (int q = 0; q < DPT; ++q) {
          int d = lane + 32 * q + t;
          const bool wrap = q == DPT - 1 && d >= Dc;
          d -= wrap ? Dc : 0;
          const int p = pixel_cost(a, wrap ? rw : rv[q]);
          int16_t* rp = ring + ((size_t)slot * NC + j) * Dc + d;
          int* vp = V + (size_t)j * Dc + d;
          const int old = k >= bs ? static_cast<int>(*rp) : 0;
          *rp = static_cast<int16_t>(p);
          *vp = (k == 0 ? 0 : *vp) + p - old;
        }
      }
    } else if (!diag) {
    for (int j = warp; j < NC; j += kWarps) {
      const int il = clampi(x0 - r + j, 0, W - 1) - cmin;
      const uint4 a = chL[il];
      int16_t* rp = ring + ((size_t)slot * NC + j) * Dc + lane;
      int* vp = V + (size_t)j * Dc + lane;
#pragma unroll
      for (int q = 0; q < DPT; ++q) {
        if (lane + 32 * q < dn) {
          const int p = pixel_cost(a, chR[il + sh[q]]);
          const int old = k >= bs ? static_cast<int>(rp[32 * q]) : 0;
          rp[32 * q] = static_cast<int16_t>(p);
          vp[32 * q] = (k == 0 ? 0 : vp[32 * q]) + p - old;
        }
      }
    }
    }
    __syncthreads();
    if (k < bs - 1) continue;  // the window is not full yet (uniform over the block)
    // H. Output row y = y0 + k - (bs - 1): the box of window columns t .. t + bs - 1.
    const int y = y0 + k - (bs - 1);
    T* orow = out + (((size_t)b * H + y) * Wo + (x0 - x_off)) * D + dc0 + dv;
    const bool whole = dv + DPT <= dn && D % DPT == 0;
    int hs[DPT];
    for (int t = t0; t < t1; ++t) {
      if (t == t0) {
#pragma unroll
        for (int q = 0; q < DPT; ++q) hs[q] = 0;
        for (int dx = 0; dx < bs; ++dx) {
          int v[DPT];
          load_ints<DPT>(V + (size_t)(t + dx) * Dc + dv, v);
#pragma unroll
          for (int q = 0; q < DPT; ++q) hs[q] += v[q];
        }
      } else {
        int vin[DPT], vout[DPT];
        load_ints<DPT>(V + (size_t)(t + bs - 1) * Dc + dv, vin);
        load_ints<DPT>(V + (size_t)(t - 1) * Dc + dv, vout);
#pragma unroll
        for (int q = 0; q < DPT; ++q) hs[q] += vin[q] - vout[q];
      }
      T* o = orow + (size_t)t * D;
      if (whole) {
        Vec<T, DPT>::store(o, hs);
      } else {
#pragma unroll
        for (int q = 0; q < DPT; ++q)
          if (dv + q < dn) o[q] = static_cast<T>(hs[q]);
      }
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads, 4)
cost_kernel(const int* __restrict__ left, const int* __restrict__ right, T* __restrict__ out, int H, int W, int D,
            int mindisp, int bs, int ftzero, int x_off, int TX, int nchunks) {
  extern __shared__ __align__(16) unsigned char cost_smem[];
  const Layout lay(TX, 32 * DPT, bs);
  cost_block<T, DPT>(cost_smem, reinterpret_cast<int*>(cost_smem + lay.rings), left, right, out, H, W, D, mindisp,
                     bs, ftzero, x_off, TX, blockIdx.x % nchunks, blockIdx.x / nchunks, blockIdx.y, blockIdx.z);
}

// The block over V and the ring in device scratch: slot blockIdx.x of `slot`
// bytes; items (chunk, tile, strip, frame) = blockIdx.x, + gridDim.x, ...
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
cost_scratch_kernel(const int* __restrict__ left, const int* __restrict__ right, T* __restrict__ out,
                    unsigned char* scratch, size_t slot, int H, int W, int D, int mindisp, int bs, int ftzero,
                    int x_off, int TX, int nchunks, int ntiles, int nstrips, int items) {
  extern __shared__ __align__(16) unsigned char cost_smem[];
  unsigned char* rings = scratch + blockIdx.x * slot;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int rest = item;
    const int chunk = rest % nchunks;
    rest /= nchunks;
    const int tile = rest % ntiles;
    rest /= ntiles;
    cost_block<T, DPT>(rings, reinterpret_cast<int*>(cost_smem), left, right, out, H, W, D, mindisp, bs, ftzero,
                       x_off, TX, chunk, tile, rest % nstrips, rest / nstrips);
    __syncthreads();  // the next item reuses the slot and the staging
  }
}

// The tile width for D disparities and block bs: the widest of 32, 24, 16
// and 8 output columns whose block takes at most a quarter of `optin` bytes
// of shared memory (four blocks an SM), else a third, a half, all of it;
// 0 where none fits (V and the ring then go to device scratch).
int cost_tile(int D, int bs, long long optin) {
  const int Dc = 32 * dpt_for(D);
  for (int share = 4; share >= 1; --share)
    for (int tx : {32, 24, 16, 8}) {
      const Layout lay(tx, Dc, bs);
      if ((long long)(lay.rings + lay.stage) <= optin / share) return tx;
    }
  return 0;
}

// The scratch form's geometry: 32 output columns, a slot a block, two
// blocks an SM (fewer where there are fewer items).
struct ScratchPlan {
  int TX = 32, nchunks, ntiles, nstrips, items, blocks;
  size_t slot, smem;
  ScratchPlan(int B, int H, int Wo, int D, int bs, int sms) {
    const int Dc = 32 * dpt_for(D);
    const Layout lay(TX, Dc, bs);
    nchunks = (D + Dc - 1) / Dc;
    ntiles = (Wo + TX - 1) / TX;
    nstrips = (H + kStrip - 1) / kStrip;
    const long long n = (long long)B * nstrips * ntiles * nchunks;
    items = (int)std::min(n, (long long)INT32_MAX);
    blocks = (int)std::min(n, 2LL * sms);
    slot = (lay.rings + 255) / 256 * 256;
    smem = lay.stage;
  }
};

int device_attr(cudaDeviceAttr attr, int device) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, attr, device) == cudaSuccess ? v : -1;
}

template <typename T, int DPT>
cudaError_t launch(const int* left, const int* right, T* out, int B, int H, int W, int D, int mindisp, int bs,
                   int ftzero, int x_off, int TX, unsigned char* scratch, cudaStream_t stream) {
  constexpr int Dc = 32 * DPT;
  const int Wo = W - x_off;
  if (scratch) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const int sms = device_attr(cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) return cudaErrorInvalidValue;
    const ScratchPlan plan(B, H, Wo, D, bs, sms);
    e = cudaFuncSetAttribute(cost_scratch_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan.smem);
    if (e != cudaSuccess) return e;
    cost_scratch_kernel<T, DPT><<<plan.blocks, kThreads, plan.smem, stream>>>(
        left, right, out, scratch, plan.slot, H, W, D, mindisp, bs, ftzero, x_off, plan.TX, plan.nchunks,
        plan.ntiles, plan.nstrips, plan.items);
    return cudaGetLastError();
  }
  const Layout lay(TX, Dc, bs);
  const size_t smem = lay.rings + lay.stage;
  cudaError_t e = cudaFuncSetAttribute(cost_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int nchunks = (D + Dc - 1) / Dc;
  const dim3 grid(nchunks * ((Wo + TX - 1) / TX), (H + kStrip - 1) / kStrip, B);
  cost_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(left, right, out, H, W, D, mindisp, bs, ftzero, x_off, TX,
                                                        nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpt(const int* l, const int* r, T* out, int B, int H, int W, int D, int mindisp, int bs,
                       int ftzero, int x_off, int TX, unsigned char* scratch, cudaStream_t st) {
  switch (dpt_for(D)) {
    case 1: return launch<T, 1>(l, r, out, B, H, W, D, mindisp, bs, ftzero, x_off, TX, scratch, st);
    case 2: return launch<T, 2>(l, r, out, B, H, W, D, mindisp, bs, ftzero, x_off, TX, scratch, st);
    default: return launch<T, 4>(l, r, out, B, H, W, D, mindisp, bs, ftzero, x_off, TX, scratch, st);
  }
}

}  // namespace

// The tile width (output columns a block) of the cost kernel for D
// disparities and block bs on `device`; 0 where no tile fits a block's
// shared memory (svt_cost_volume then takes device scratch), -1 for a
// failed device query.
SVT_EXPORT int svt_cost_volume_tile(int D, int bs, int device) {
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return optin < 0 ? -1 : cost_tile(D, bs, optin);
}

// Bytes of device scratch svt_cost_volume needs where svt_cost_volume_tile
// is 0: a slot of V and the ring for each of two blocks an SM; -1 for a
// failed device query.
SVT_EXPORT long long svt_cost_volume_scratch_bytes(int B, int H, int Wo, int D, int bs, int device) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) return -1;
  if (B == 0 || H == 0 || Wo <= 0) return 0;
  const ScratchPlan plan(B, H, Wo, D, bs, sms);
  return (long long)plan.blocks * (long long)plan.slot;
}

// (B, H, W) int32 left/right -> (B, H, W - x_off, D) windowed cost, int16
// (out_bytes 2) or int32 (out_bytes 4), any D, in tiles of TX columns
// (svt_cost_volume_tile) or, with `scratch` (svt_cost_volume_scratch_bytes
// of it; TX then unused), over V and the ring in device scratch.
// mindisp + D >= 1, any bs >= 1.
SVT_EXPORT int svt_cost_volume(const void* left, const void* right, void* out, int B, int H, int W, int D,
                               int mindisp, int bs, int ftzero, int x_off, int out_bytes, int TX, void* scratch,
                               void* stream) {
  if (bs < 1 || D < 1 || mindisp + D < 1 || x_off < 0 || x_off >= W) return cudaErrorInvalidValue;
  if (TX < 1 && !scratch) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  const auto l = static_cast<const int*>(left), r = static_cast<const int*>(right);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<unsigned char*>(scratch);
  if (out_bytes == 2)
    return launch_dpt(l, r, static_cast<int16_t*>(out), B, H, W, D, mindisp, bs, ftzero, x_off, TX, sc, st);
  if (out_bytes == 4)
    return launch_dpt(l, r, static_cast<int*>(out), B, H, W, D, mindisp, bs, ftzero, x_off, TX, sc, st);
  return cudaErrorInvalidValue;
}
