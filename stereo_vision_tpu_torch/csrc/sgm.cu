// Semi-global aggregation and winner-take-all for exact SGBM.
//
// Replaces the kernel bodies of stereo_vision_tpu/stereo/sgm_pallas.py:
//   _vertical_kernel   -> vertical_step  (3 down + 3 up directions; the
//                         sgm_reduce_pallas and aggregate_8_pallas sites)
//   _horizontal_kernel -> horizontal_scan (L->R, or R->L; both sites)
//   _wta4_kernel       -> wta_kernel     (sum of 2-4 direction volumes ->
//                                         min/argmin/uniqueness/subpixel samples)
//   _wta_kernel        -> wta_stats_kernel (the same from one int32 volume,
//                                         wta_stats_pallas)
//   _horizontal_rl_wta_kernel -> horizontal_rl_wta (the R->L scan fused with
//                                         the WTA over four directions)
//
// Layout: one warp owns the D disparities of one pixel, VPL = D/32 (rounded
// up to 1, 2, 4 or 8) consecutive disparities per lane, d = lane*VPL + k.
// The d +- 1 neighbours of an SGM step come from the lane's own registers or
// one shuffle; min over d is a 5-step shuffle reduction, so no step needs a
// block barrier. Disparities d >= D hold a large sentinel that no min takes.
// All arithmetic is int32 (the TPU kernels' float32 was a Mosaic workaround).
// Costs, carries and direction volumes are stored as T: int16 where the
// wrappers find that 3 * (cost_bound + P2) (or cost_bound + P2 for a single
// direction) fits it, int32 otherwise; every kernel is one template over T.
//
// What bounds them on an H100 (720p, D=128, per frame, int16 volumes of
// 212 MB): vertical reads the cost once and writes two volumes (637 MB,
// ~190 us); each horizontal reads the cost and writes one volume (425 MB,
// ~127 us); WTA reads four volumes (850 MB, ~254 us); the one-volume WTA
// reads an int32 volume (425 MB, ~127 us); the fused R->L scan + WTA reads
// the cost and three volumes (850 MB) and writes only the maps. The scans
// are also latency-bound chains: H (or W) dependent steps.
//
// Vertical design: a diagonal moves one column per row, so no block can own
// a column strip, and blocks carry nothing between them. One launch per row
// step (row i for the down set, row H-1-i for the up set, both in the same
// launch) with the six carries ping-ponged in global memory: a carry set is
// 6*B*W*D int16 (7 MB at 720p, B=4), which stays in the 50 MB L2. This was
// chosen over a persistent cooperative kernel with a grid-wide barrier per
// row because it needs no co-residency limit on the grid and is simple;
// its cost is one launch (a few us) per row.
//
// Horizontal design: one warp per (frame, row) keeps its carry in registers
// and walks the W columns, prefetching the next column's costs.
//
// WTA design: one warp per pixel sums the volumes in registers; ties in the
// argmin go to the smallest d. The fused R->L kernel is the horizontal scan
// with that reduction at every column: the fourth direction volume stays in
// registers, and the reduction's shuffles lengthen the scan's serial chain
// (the trade the reference measured; sgm_cuda._FUSED_RL_WTA picks the form).

#include <type_traits>

#include "common.cuh"

namespace {

using svt::kFullMask;
using svt::warp_min;
using svt::warp_sum;

constexpr int kBig = 1 << 29;  // out-of-range d±1 neighbour
constexpr int kWarps = 8;      // warps per block

// VPL consecutive values of type T as raw words (16 bytes at most each).
template <typename T, int VPL>
struct Words {
  static constexpr int kBytes = VPL * (int)sizeof(T);
  static constexpr int kWordBytes = kBytes >= 16 ? 16 : kBytes;
  static constexpr int kN = kBytes / kWordBytes;
  using Word = typename std::conditional<
      kWordBytes == 16, int4,
      typename std::conditional<kWordBytes == 8, int2,
                                typename std::conditional<kWordBytes == 4, int, int16_t>::type>::type>::type;
};

// Load the lane's VPL values of one pixel's D-vector; entries d >= D get fill.
template <typename T, int VPL>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int D, int lane, int (&v)[VPL], int fill) {
  const int d0 = lane * VPL;
  if (d0 + VPL <= D && D % VPL == 0) {  // aligned vector access
    using W = Words<T, VPL>;
    typename W::Word w[W::kN];
#pragma unroll
    for (int i = 0; i < W::kN; ++i) w[i] = reinterpret_cast<const typename W::Word*>(p + d0)[i];
    const T* s = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int k = 0; k < VPL; ++k) v[k] = s[k];
  } else {
#pragma unroll
    for (int k = 0; k < VPL; ++k) v[k] = d0 + k < D ? p[d0 + k] : fill;
  }
}

template <typename T, int VPL>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int D, int lane, const int (&v)[VPL]) {
  const int d0 = lane * VPL;
  if (d0 + VPL <= D && D % VPL == 0) {
    using W = Words<T, VPL>;
    typename W::Word w[W::kN];
    T* s = reinterpret_cast<T*>(w);
#pragma unroll
    for (int k = 0; k < VPL; ++k) s[k] = static_cast<T>(v[k]);
#pragma unroll
    for (int i = 0; i < W::kN; ++i) reinterpret_cast<typename W::Word*>(p + d0)[i] = w[i];
  } else {
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (d0 + k < D) p[d0 + k] = static_cast<T>(v[k]);
  }
}

// Zero carry (the border rule): L = 0 for real d, sentinel for padding.
template <int VPL>
__device__ __forceinline__ void zero_carry(int D, int lane, int (&L)[VPL]) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) L[k] = lane * VPL + k < D ? 0 : kBig;
}

// One SGM step: L'[d] = c[d] + min(L[d], L[d-1]+P1, L[d+1]+P1, minL+P2) - minL.
// Returns min over d of L'. Padding entries of L' keep the sentinel.
template <int VPL>
__device__ __forceinline__ int sgm_step(const int (&c)[VPL], const int (&L)[VPL], int minL, int P1, int P2,
                                        int D, int lane, int (&Ln)[VPL]) {
  int below = __shfl_up_sync(kFullMask, L[VPL - 1], 1);  // L at d = lane*VPL - 1
  int above = __shfl_down_sync(kFullMask, L[0], 1);      // L at d = lane*VPL + VPL
  if (lane == 0) below = kBig;
  if (lane == 31) above = kBig;
  int m = kBig;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int Lm = k == 0 ? below : L[k - 1];
    const int Lp = k == VPL - 1 ? above : L[k + 1];
    const int cand = min(min(L[k], minL + P2), min(Lm, Lp) + P1);
    Ln[k] = lane * VPL + k < D ? c[k] + cand - minL : kBig;
    m = min(m, Ln[k]);
  }
  return warp_min(m);
}

// Row step i of the vertical scans. blockIdx.z = 0: down set on row i;
// 1: up set on row H-1-i (the reference's y-flipped scan, with the SAME
// column-shift directions). Carry slots: [set*3 + dir][b][x][d], dir 0 =
// vertical, 1 = predecessor at x-1, 2 = predecessor at x+1; a predecessor
// outside the image is a zero carry, as is every carry at i = 0.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
vertical_step(const T* __restrict__ C, T* __restrict__ s_dn, T* __restrict__ s_up,
              const T* __restrict__ Lin, T* __restrict__ Lout, const int* __restrict__ min_in,
              int* __restrict__ min_out, int B, int H, int W, int D, int P1, int P2, int with_diag, int i) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y, set = blockIdx.z;
  if (x >= W) return;  // whole warp
  const int row = set == 0 ? i : H - 1 - i;
  int c[VPL];
  load_vec<T, VPL>(C + (((size_t)b * H + row) * W + x) * D, D, lane, c, 0);
  int acc[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) acc[k] = 0;
  const int ndir = with_diag ? 3 : 1;
  for (int dir = 0; dir < ndir; ++dir) {
    const int px = x - (dir == 1) + (dir == 2);
    const size_t slot = ((size_t)(set * 3 + dir) * B + b) * W;
    int L[VPL], Ln[VPL];
    int m = 0;
    if (i == 0 || px < 0 || px >= W) {
      zero_carry<VPL>(D, lane, L);
    } else {
      load_vec<T, VPL>(Lin + (slot + px) * D, D, lane, L, kBig);
      m = min_in[slot + px];
    }
    const int mn = sgm_step<VPL>(c, L, m, P1, P2, D, lane, Ln);
    store_vec<T, VPL>(Lout + (slot + x) * D, D, lane, Ln);
    if (lane == 0) min_out[slot + x] = mn;
#pragma unroll
    for (int k = 0; k < VPL; ++k) acc[k] += Ln[k];
  }
  store_vec<T, VPL>((set == 0 ? s_dn : s_up) + (((size_t)b * H + row) * W + x) * D, D, lane, acc);
}

// One warp per (frame, row): the L->R (reverse: R->L) scan over W columns.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
horizontal_scan(const T* __restrict__ C, T* __restrict__ out, int rows, int W, int D, int P1,
                int P2, int reverse) {
  const int lane = threadIdx.x & 31;
  const int rid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rid >= rows) return;  // whole warp
  const T* crow = C + (size_t)rid * W * D;
  T* orow = out + (size_t)rid * W * D;
  int L[VPL], c[VPL], cn[VPL];
  zero_carry<VPL>(D, lane, L);
  int m = 0;
  load_vec<T, VPL>(crow + (size_t)(reverse ? W - 1 : 0) * D, D, lane, cn, 0);
  for (int t = 0; t < W; ++t) {
    const int x = reverse ? W - 1 - t : t;
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = cn[k];
    if (t + 1 < W) load_vec<T, VPL>(crow + (size_t)(reverse ? x - 1 : x + 1) * D, D, lane, cn, 0);
    int Ln[VPL];
    m = sgm_step<VPL>(c, L, m, P1, P2, D, lane, Ln);
    store_vec<T, VPL>(orow + (size_t)x * D, D, lane, Ln);
#pragma unroll
    for (int k = 0; k < VPL; ++k) L[k] = Ln[k];
  }
}

// The WTA reduction of one pixel's aggregated vector S (entries d >= D hold
// kBig): min, argmin (ties -> smallest d), the uniqueness verdict and S at
// d0-1, d0, d0+1 with d0 = clip(best, 1, D-2); lane 0 writes them at p.
template <int VPL>
__device__ __forceinline__ void wta_store(const int (&S)[VPL], int D, int lane, int uniq, long long p,
                                          int* __restrict__ minS, int* __restrict__ best, int* __restrict__ sm,
                                          int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok) {
  int m = kBig;
#pragma unroll
  for (int k = 0; k < VPL; ++k) m = min(m, S[k]);
  const int mn = warp_min(m);
  int bl = D;
#pragma unroll
  for (int k = VPL - 1; k >= 0; --k)
    if (S[k] == mn) bl = lane * VPL + k;  // padding holds kBig > mn
  const int bst = warp_min(bl);
  bool offend = false;
  if (uniq > 0) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int d = lane * VPL + k;
      offend |= d < D && abs(d - bst) > 1 && mn * (100 + uniq) > S[k] * 100;
    }
  }
  const bool ok = !__any_sync(kFullMask, offend);
  const int d0 = min(max(bst, 1), D - 2);
  int a = 0, z = 0, c = 0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int d = lane * VPL + k;
    a += d == d0 - 1 ? S[k] : 0;
    z += d == d0 ? S[k] : 0;
    c += d == d0 + 1 ? S[k] : 0;
  }
  a = warp_sum(a);
  z = warp_sum(z);
  c = warp_sum(c);
  if (lane == 0) {
    minS[p] = mn;
    best[p] = bst;
    sm[p] = a;
    s0[p] = z;
    sp[p] = c;
    uok[p] = ok ? 1 : 0;
  }
}

// One warp per pixel: S = sum of nvol volumes, then wta_store.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
wta_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
           const T* __restrict__ v3, int nvol, int* __restrict__ minS, int* __restrict__ best,
           int* __restrict__ sm, int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok,
           long long npix, int D, int uniq) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // whole warp
  const size_t base = (size_t)p * D;
  const T* vols[4] = {v0, v1, v2, v3};
  int S[VPL], t[VPL];
  load_vec<T, VPL>(vols[0] + base, D, lane, S, kBig);
  for (int j = 1; j < nvol; ++j) {
    load_vec<T, VPL>(vols[j] + base, D, lane, t, 0);
#pragma unroll
    for (int k = 0; k < VPL; ++k) S[k] += t[k];
  }
  wta_store<VPL>(S, D, lane, uniq, p, minS, best, sm, s0, sp, uok);
}

// One warp per pixel of one aggregated int32 volume.
template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
wta_stats_kernel(const int* __restrict__ S, int* __restrict__ minS, int* __restrict__ best, int* __restrict__ sm,
                 int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok, long long npix, int D,
                 int uniq) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // whole warp
  int v[VPL];
  load_vec<int, VPL>(S + (size_t)p * D, D, lane, v, kBig);
  wta_store<VPL>(v, D, lane, uniq, p, minS, best, sm, s0, sp, uok);
}

// One warp per (frame, row): the R->L scan over W columns; at each column
// its L plus the three stored direction volumes is the aggregated vector,
// reduced in place by wta_store (the R->L volume is never stored).
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
horizontal_rl_wta(const T* __restrict__ C, const T* __restrict__ v0, const T* __restrict__ v1,
                  const T* __restrict__ v2, int rows, int W, int D, int P1, int P2, int uniq,
                  int* __restrict__ minS, int* __restrict__ best, int* __restrict__ sm, int* __restrict__ s0,
                  int* __restrict__ sp, uint8_t* __restrict__ uok) {
  const int lane = threadIdx.x & 31;
  const int rid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rid >= rows) return;  // whole warp
  const T* crow = C + (size_t)rid * W * D;
  int L[VPL], c[VPL], cn[VPL], S[VPL], t[VPL];
  zero_carry<VPL>(D, lane, L);
  int m = 0;
  load_vec<T, VPL>(crow + (size_t)(W - 1) * D, D, lane, cn, 0);
  for (int x = W - 1; x >= 0; --x) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = cn[k];
    if (x > 0) load_vec<T, VPL>(crow + (size_t)(x - 1) * D, D, lane, cn, 0);
    m = sgm_step<VPL>(c, L, m, P1, P2, D, lane, S);  // padding entries keep kBig
#pragma unroll
    for (int k = 0; k < VPL; ++k) L[k] = S[k];
    const long long p = (long long)rid * W + x;
    const size_t base = (size_t)p * D;
    const T* vols[3] = {v0, v1, v2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      load_vec<T, VPL>(vols[j] + base, D, lane, t, 0);
#pragma unroll
      for (int k = 0; k < VPL; ++k) S[k] += t[k];
    }
    wta_store<VPL>(S, D, lane, uniq, p, minS, best, sm, s0, sp, uok);
  }
}

template <typename T, int VPL>
cudaError_t vertical(const T* C, T* s_dn, T* s_up, T* Lbuf, int* mbuf, int B, int H, int W, int D, int P1, int P2,
                     int with_diag, cudaStream_t stream) {
  const size_t lset = (size_t)6 * B * W * D, mset = (size_t)6 * B * W;
  const dim3 grid((W + kWarps - 1) / kWarps, B, 2);
  for (int i = 0; i < H; ++i) {
    const int src = (i + 1) & 1, dst = i & 1;
    vertical_step<T, VPL><<<grid, kWarps * 32, 0, stream>>>(C, s_dn, s_up, Lbuf + src * lset, Lbuf + dst * lset,
                                                            mbuf + src * mset, mbuf + dst * mset, B, H, W, D, P1,
                                                            P2, with_diag, i);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename T, int VPL>
cudaError_t horizontal(const T* C, T* out, int rows, int W, int D, int P1, int P2, int reverse,
                       cudaStream_t stream) {
  horizontal_scan<T, VPL><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(C, out, rows, W, D, P1, P2,
                                                                                    reverse);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t wta(const T* const* v, int nvol, int* const* maps, uint8_t* uok, int npix, int D, int uniq,
                cudaStream_t stream) {
  wta_kernel<T, VPL><<<(npix + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      v[0], v[1], v[2], v[3], nvol, maps[0], maps[1], maps[2], maps[3], maps[4], uok, npix, D, uniq);
  return cudaGetLastError();
}

template <int VPL>
cudaError_t wta_stats(const int* S, int* const* maps, uint8_t* uok, long long npix, int D, int uniq,
                      cudaStream_t stream) {
  wta_stats_kernel<VPL><<<(npix + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      S, maps[0], maps[1], maps[2], maps[3], maps[4], uok, npix, D, uniq);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t rl_wta(const T* C, const T* const* v, int rows, int W, int D, int P1, int P2, int uniq,
                   int* const* maps, uint8_t* uok, cudaStream_t stream) {
  horizontal_rl_wta<T, VPL><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      C, v[0], v[1], v[2], rows, W, D, P1, P2, uniq, maps[0], maps[1], maps[2], maps[3], maps[4], uok);
  return cudaGetLastError();
}

// Values per lane for D disparities: 1, 2, 4 or 8 (D <= 256).
int vpl_for(int D) { return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8; }

// fn<T, VPL>() for the storage type of `bytes` (2: int16, 4: int32) and D's
// values per lane; cudaErrorInvalidValue for another width.
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int bytes, int D, Args... args) {
  const int vpl = vpl_for(D);
  if (bytes == 2) {
    switch (vpl) {
      case 1: return Fn<int16_t, 1>::run(args...);
      case 2: return Fn<int16_t, 2>::run(args...);
      case 4: return Fn<int16_t, 4>::run(args...);
      default: return Fn<int16_t, 8>::run(args...);
    }
  }
  if (bytes == 4) {
    switch (vpl) {
      case 1: return Fn<int, 1>::run(args...);
      case 2: return Fn<int, 2>::run(args...);
      case 4: return Fn<int, 4>::run(args...);
      default: return Fn<int, 8>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, int VPL>
struct VerticalFn {
  static cudaError_t run(const void* C, void* dn, void* up, void* L, void* m, int B, int H, int W, int D, int P1,
                         int P2, int with_diag, cudaStream_t st) {
    return vertical<T, VPL>(static_cast<const T*>(C), static_cast<T*>(dn), static_cast<T*>(up), static_cast<T*>(L),
                            static_cast<int*>(m), B, H, W, D, P1, P2, with_diag, st);
  }
};

template <typename T, int VPL>
struct HorizontalFn {
  static cudaError_t run(const void* C, void* out, int rows, int W, int D, int P1, int P2, int reverse,
                         cudaStream_t st) {
    return horizontal<T, VPL>(static_cast<const T*>(C), static_cast<T*>(out), rows, W, D, P1, P2, reverse, st);
  }
};

template <typename T, int VPL>
struct WtaFn {
  static cudaError_t run(const void* const* vp, int nvol, int* const* maps, uint8_t* uok, int npix, int D, int uniq,
                         cudaStream_t st) {
    const T* v[4] = {static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2]),
                     static_cast<const T*>(vp[3])};
    return wta<T, VPL>(v, nvol, maps, uok, npix, D, uniq, st);
  }
};

template <typename T, int VPL>
struct RlWtaFn {
  static cudaError_t run(const void* C, const void* const* vp, int rows, int W, int D, int P1, int P2, int uniq,
                         int* const* maps, uint8_t* uok, cudaStream_t st) {
    const T* v[3] = {static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2])};
    return rl_wta<T, VPL>(static_cast<const T*>(C), v, rows, W, D, P1, P2, uniq, maps, uok, st);
  }
};

}  // namespace

// (B, H, W, D) cost -> down-set and up-set sums, H launches; every volume
// int16 (bytes 2) or int32 (bytes 4). Lbuf: 2 x 6 x B x W x D carries of
// that type; mbuf: 2 x 6 x B x W int32 minima.
SVT_EXPORT int svt_sgm_vertical(const void* C, void* s_dn, void* s_up, void* Lbuf, void* mbuf, int B, int H,
                                int W, int D, int P1, int P2, int with_diag, int bytes, void* stream) {
  if (D > 256) return cudaErrorInvalidValue;
  return dispatch<VerticalFn>(bytes, D, C, s_dn, s_up, Lbuf, mbuf, B, H, W, D, P1, P2, with_diag,
                              static_cast<cudaStream_t>(stream));
}

// (B, H, W, D) cost -> one horizontal direction volume of the same type.
SVT_EXPORT int svt_sgm_horizontal(const void* C, void* out, int B, int H, int W, int D, int P1, int P2,
                                  int reverse, int bytes, void* stream) {
  if (D > 256) return cudaErrorInvalidValue;
  return dispatch<HorizontalFn>(bytes, D, C, out, B * H, W, D, P1, P2, reverse, static_cast<cudaStream_t>(stream));
}

// nvol (2-4) (npix, D) volumes of one type -> six per-pixel maps (v2, v3
// may be null when nvol is smaller).
SVT_EXPORT int svt_sgm_wta(const void* v0, const void* v1, const void* v2, const void* v3, int nvol,
                           void* minS, void* best, void* sm, void* s0, void* sp, void* uok, int npix, int D,
                           int uniq, int bytes, void* stream) {
  if (D > 256 || D < 3 || nvol < 2 || nvol > 4) return cudaErrorInvalidValue;
  const void* v[4] = {v0, v1, v2, v3};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(sm),
                  static_cast<int*>(s0), static_cast<int*>(sp)};
  return dispatch<WtaFn>(bytes, D, static_cast<const void* const*>(v), nvol, static_cast<int* const*>(maps),
                         static_cast<uint8_t*>(uok), npix, D, uniq, static_cast<cudaStream_t>(stream));
}

// One int32 (npix, D) aggregated volume -> six per-pixel maps.
SVT_EXPORT int svt_sgm_wta_stats(const void* S, void* minS, void* best, void* sm, void* s0, void* sp, void* uok,
                                 long long npix, int D, int uniq, void* stream) {
  if (D > 256 || D < 3) return cudaErrorInvalidValue;
  const auto s = static_cast<const int*>(S);
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(sm),
                  static_cast<int*>(s0), static_cast<int*>(sp)};
  const auto u = static_cast<uint8_t*>(uok);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (vpl_for(D)) {
    case 1: return wta_stats<1>(s, maps, u, npix, D, uniq, st);
    case 2: return wta_stats<2>(s, maps, u, npix, D, uniq, st);
    case 4: return wta_stats<4>(s, maps, u, npix, D, uniq, st);
    default: return wta_stats<8>(s, maps, u, npix, D, uniq, st);
  }
}

// (B, H, W, D) cost + three direction volumes, all of one type -> six
// per-pixel maps of the four-direction sum, the R->L direction scanned in place.
SVT_EXPORT int svt_sgm_horizontal_rl_wta(const void* C, const void* v0, const void* v1, const void* v2, void* minS,
                                         void* best, void* sm, void* s0, void* sp, void* uok, int B, int H, int W,
                                         int D, int P1, int P2, int uniq, int bytes, void* stream) {
  if (D > 256 || D < 3) return cudaErrorInvalidValue;
  const void* v[3] = {v0, v1, v2};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(sm),
                  static_cast<int*>(s0), static_cast<int*>(sp)};
  return dispatch<RlWtaFn>(bytes, D, C, static_cast<const void* const*>(v), B * H, W, D, P1, P2, uniq,
                           static_cast<int* const*>(maps), static_cast<uint8_t*>(uok),
                           static_cast<cudaStream_t>(stream));
}
