// The banded scans and WTA at bands above 64: up to 1024, a
// pixel's lanes spread over a group of 32 threads, LPT = KP / 32 lanes a
// thread (KP = 128, 256, 512 or 1024; lanes at and past K hold kBig, as
// banded.cuh sets out); above 1024, a warp walks the band in steps of 32
// with its carry read back from memory (wide_range.cuh: banded_chunk_*
// below). The kernels of banded.cu keep a pixel's lanes in one thread's
// registers, which stops at 64. One source a storage type (banded_wide.cu:
// int16, banded_wide32.cu: int32), built beside banded.cu.
//
// Replaces, at these bands, stereo_vision_tpu/stereo/banded_pallas.py:
//   _vert_kernel:666 without diagonals -> banded_line_kernel (banded_group.cuh)
//     over (frame, column, direction) lines: #18's group step with the walk
//     of a column;
//   _vert_kernel with diagonals         -> banded_wide_diag_kernel;
//   _horiz_kernel:759                   -> banded_line_kernel over rows (#18);
//   _wta_kernel:815 (6-stat and sub)    -> banded_wta_wide_kernel.
// (The cost kernel, banded_cost.cu, takes every K itself.)
//
// What bounds them: bytes, as their forms at K <= 64 (each scan reads one
// volume and writes one or two); the scans are also chains of dependent
// steps. None runs on a main path; they are right and simple first.
#pragma once

#include <climits>

#include "banded_group.cuh"
#include "wide_range.cuh"

namespace {

using svt::kBig;
using svt::subpixel16;
using svt::WtaStats;

constexpr int kWideGroup = 32;  // threads a pixel
constexpr int kWideThreads = 128;

// Threads of a (frame, direction) block of the 8-path scan: 16 groups, 4
// from LPT 16 on (a thread's carries then need more than the 128 registers
// that 512 threads a block leave it).
__host__ __device__ constexpr int wide_diag_threads(int lpt) { return lpt >= 16 ? 128 : 512; }

// ------------------------------------------------------- 8-path vertical

// One group step of a carry read from memory: `prev` holds the predecessor's
// K lanes (a diagonal or vertical carry of the row before). Realigned by
// delta as banded_step<KP, kDiag> (+-G, and +-2G where `two`; a reset beyond
// the reach), by direct loads of lanes k + sh + o - 1, then group_update.
template <typename T, int LPT>
__device__ __forceinline__ void carry_step(const int (&c)[LPT], const T* prev, int delta, int t, int K, int G,
                                           bool two, int P1, int P2, int (&L)[LPT]) {
  const int reach = two ? 2 * G : G;
  const int sh = delta == G                ? G
                 : delta == -G             ? -G
                 : two && delta == 2 * G   ? 2 * G
                 : two && delta == -2 * G ? -2 * G
                                           : 0;
  int a[3][LPT];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int kk = t + kWideGroup * j + o - 1, src = kk + sh;
      a[o][j] = kk >= 0 && kk < K && src >= 0 && src < K ? static_cast<int>(prev[src]) : kBig;
    }
  }
  svt::group_update<kWideGroup, LPT>(a, c, t, K, delta > reach || delta < -reach, P1, P2, L);
}

// One block per (frame, direction): blockIdx.y = 0 scans down, 1 up (the
// y-flipped volume with the same column shifts). Its groups loop over
// the columns of each row (Wv x 32 threads do not fit one block); per
// column, the vertical carry (predecessor (y', x)) and the (1,1) and (-1,1)
// diagonal carries (predecessors (y', x - 1), (y', x + 1)), y' the row
// visited before, each a group step, and their sum stored. All three carry
// sets go through a ping-pong pair of rows, [2 rows][3 sets][Wv][K] of T, in
// shared memory or at scratch + (frame * 2 + direction) * 6 * Wv * KS; one
// __syncthreads a row.
template <typename T, int LPT>
__global__ void __launch_bounds__(wide_diag_threads(LPT))
banded_wide_diag_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out_dn,
                        T* __restrict__ out_up, T* scratch, int H, int Wv, int K, int G, int P1, int P2) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int b = blockIdx.x, up = blockIdx.y;
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const size_t plane = (size_t)Wv * KS;
  T* carry = scratch ? scratch + ((size_t)b * 2 + up) * 6 * plane : reinterpret_cast<T*>(wide_smem);
  const T* Cb = C + (size_t)b * H * plane;
  T* Ob = (up ? out_up : out_dn) + (size_t)b * H * plane;
  const int* Sb = shift + (size_t)b * H * Wv;
  const int t = threadIdx.x & 31, group = threadIdx.x >> 5, ngroups = blockDim.x >> 5;
  const bool two = 2 * G < K;
  const int step = up ? -1 : 1;
  int y = up ? H - 1 : 0;
  for (int ti = 0; ti < H; ++ti, y += step) {
    const T* rd = carry + (size_t)(ti & 1) * 3 * plane;  // the previous row's carries: (1,1), (-1,1), vertical
    T* wr = carry + (size_t)((ti + 1) & 1) * 3 * plane;
    const int* sp = Sb + (size_t)(y - step) * Wv;  // the previous row's shifts (ti > 0)
    for (int x = group; x < Wv; x += ngroups) {
      const T* cp = Cb + ((size_t)y * Wv + x) * KS;
      int c[LPT], Lv[LPT], Ld[LPT], Lu[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int k = t + kWideGroup * j;
        c[j] = k < K ? static_cast<int>(cp[k]) : kBig;
      }
      const int sy = Sb[(size_t)y * Wv + x];
      if (ti == 0) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) Lv[j] = Ld[j] = Lu[j] = c[j];
      } else {
        carry_step<T, LPT>(c, rd + 2 * plane + (size_t)x * KS, sy - sp[x], t, K, G, false, P1, P2, Lv);
        if (x > 0) {
          carry_step<T, LPT>(c, rd + (size_t)(x - 1) * KS, sy - sp[x - 1], t, K, G, two, P1, P2, Ld);
        } else {
#pragma unroll
          for (int j = 0; j < LPT; ++j) Ld[j] = c[j];  // a zero carry from outside the frame
        }
        if (x + 1 < Wv) {
          carry_step<T, LPT>(c, rd + plane + (size_t)(x + 1) * KS, sy - sp[x + 1], t, K, G, two, P1, P2, Lu);
        } else {
#pragma unroll
          for (int j = 0; j < LPT; ++j) Lu[j] = c[j];
        }
      }
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int k = t + kWideGroup * j;
        if (k < K) {
          wr[(size_t)x * KS + k] = static_cast<T>(Ld[j]);
          wr[plane + (size_t)x * KS + k] = static_cast<T>(Lu[j]);
          wr[2 * plane + (size_t)x * KS + k] = static_cast<T>(Lv[j]);
          Ob[((size_t)y * Wv + x) * KS + k] = static_cast<T>(Ld[j] + Lv[j] + Lu[j]);
        }
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------- WTA

// One group per pixel: S = the int32 sum of the nvol (2-4) volumes at lanes
// t + 32 j (kBig past K); the minimum and argmin (ties -> the smallest k)
// from the group's reductions; uniqueness a group AND of the per-lane test;
// the samples at d0 - 1, d0, d0 + 1 (d0 = clip(best, 1, K - 2)) by shuffle
// from their owners. Thread 0 of the group writes the maps.
template <typename T, int LPT>
__global__ void __launch_bounds__(kWideThreads)
banded_wta_wide_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                       const T* __restrict__ v3, int nvol, int npix, int K, int uniq, int sub, int* __restrict__ minS,
                       int* __restrict__ best, int* __restrict__ m2, int* __restrict__ m3, int* __restrict__ m4,
                       uint8_t* __restrict__ uok) {
  const int p = (int)(((long long)blockIdx.x * kWideThreads + threadIdx.x) / kWideGroup);
  if (p >= npix) return;  // whole group
  const int t = threadIdx.x & 31;
  const T* const vols[4] = {v0, v1, v2, v3};
  int S[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int k = t + kWideGroup * j;
    int sum = 0;
    for (int v = 0; v < nvol; ++v) sum += k < K ? static_cast<int>(vols[v][(size_t)p * svt::lane_stride(K) + k]) : 0;
    S[j] = k < K ? sum : kBig;
  }
  int mn = S[0], bst = t;  // the thread's own minimum and its smallest lane
#pragma unroll
  for (int j = 1; j < LPT; ++j)
    if (S[j] < mn) {
      mn = S[j];
      bst = t + kWideGroup * j;
    }
  const int m = __reduce_min_sync(svt::kFullMask, mn);
  const int b = __reduce_min_sync(svt::kFullMask, mn == m ? bst : INT_MAX);
  bool ok = true;
  if (uniq > 0) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int k = t + kWideGroup * j;
      ok &= !(k < K && abs(k - b) > 1 && m * (100 + uniq) > S[j] * 100);
    }
    ok = __all_sync(svt::kFullMask, ok);
  }
  // Lane kq of S, from thread kq % 32's element kq / 32 (uniform across the group).
  auto lane_of = [&](int kq) {
    const int e = kq / kWideGroup;
    int v = S[0];
#pragma unroll
    for (int j = 1; j < LPT; ++j) v = e == j ? S[j] : v;
    return __shfl_sync(svt::kFullMask, v, kq % kWideGroup);
  };
  const int d0 = min(max(b, 1), K - 2);
  const WtaStats w{m, b, lane_of(d0 - 1), lane_of(d0), lane_of(d0 + 1), ok};
  if (t == 0) {
    minS[p] = w.mn;
    best[p] = w.bst;
    uok[p] = w.ok ? 1 : 0;
    if (sub) {
      m2[p] = subpixel16(w, K);
    } else {
      m2[p] = w.a;
      m3[p] = w.z;
      m4[p] = w.c;
    }
  }
}

// ------------------------------------------------------ bands above 1024

// The line scan (rows: the horizontal scans; columns: the vertical pair
// without diagonals) above 1024: one warp a line, as banded_line_kernel's
// groups, its carry the previous pixel's stored lanes.
template <typename T, bool kColumns>
__global__ void __launch_bounds__(kWideThreads)
banded_chunk_line_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out,
                         T* __restrict__ out_up, int lines, int n, int Wv, int K, int G, int P1, int P2, int reverse) {
  const int lane = threadIdx.x & 31;
  const int line = (int)(((long long)blockIdx.x * kWideThreads + threadIdx.x) / 32);
  if (line >= lines) return;  // whole warp
  size_t first;
  T* o = out;
  bool rev = reverse;
  if constexpr (kColumns) {
    const int half = lines / 2, up = line >= half, rem = line - up * half, b = rem / Wv;
    first = (size_t)b * n * Wv + (rem - b * Wv);
    o = up ? out_up : out;
    rev = up;
  } else {
    first = (size_t)line * Wv;
  }
  const size_t pstride = kColumns ? (size_t)Wv : 1;
  auto pos = [&](int ti) { return (size_t)(rev ? n - 1 - ti : ti) * pstride; };
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const T* crow = C + first * KS;
  T* orow = o + first * KS;
  const int* srow = shift + first;
  int sprev = srow[pos(0)];  // delta 0 at the first step
  for (int ti = 0; ti < n; ++ti) {
    const size_t x = pos(ti);
    const int delta = srow[x] - sprev;
    sprev = srow[x];
    const int sh = delta == G ? G : delta == -G ? -G : 0;
    const bool reset = delta > G || delta < -G;
    const T* prev = ti == 0 ? nullptr : orow + pos(ti - 1) * KS;
    const T* cp = crow + x * KS;
    T* op = orow + x * KS;
    const int m = svt::band_min(prev, sh, K, lane);
    for (int k = lane; k < K; k += 32)
      op[k] = static_cast<T>(svt::band_update(prev, sh, reset, m, static_cast<int>(cp[k]), k, K, P1, P2));
    __syncwarp();  // the pixel's lanes, stored by every lane, are the next step's carry
  }
}

// The 8-path vertical above 1024: banded_wide_diag_kernel with a warp a
// column and its three carries' band minima taken before the update.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
banded_chunk_diag_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out_dn,
                         T* __restrict__ out_up, T* scratch, int H, int Wv, int K, int G, int P1, int P2) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int b = blockIdx.x, up = blockIdx.y;
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const size_t plane = (size_t)Wv * KS;
  T* carry = scratch ? scratch + ((size_t)b * 2 + up) * 6 * plane : reinterpret_cast<T*>(wide_smem);
  const T* Cb = C + (size_t)b * H * plane;
  T* Ob = (up ? out_up : out_dn) + (size_t)b * H * plane;
  const int* Sb = shift + (size_t)b * H * Wv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const bool two = 2 * G < K;
  const int reach = two ? 2 * G : G;
  const int step = up ? -1 : 1;
  // The realignment of a carry by delta (+-G, and +-2G where `two`).
  auto shift_of = [&](int delta, bool diag) {
    return delta == G ? G : delta == -G ? -G : diag && two && delta == 2 * G ? 2 * G
                                            : diag && two && delta == -2 * G ? -2 * G : 0;
  };
  int y = up ? H - 1 : 0;
  for (int ti = 0; ti < H; ++ti, y += step) {
    const T* rd = carry + (size_t)(ti & 1) * 3 * plane;  // the previous row's carries: (1,1), (-1,1), vertical
    T* wr = carry + (size_t)((ti + 1) & 1) * 3 * plane;
    const int* sp = Sb + (size_t)(y - step) * Wv;  // the previous row's shifts (ti > 0)
    for (int x = warp; x < Wv; x += nwarps) {
      const T* cp = Cb + ((size_t)y * Wv + x) * KS;
      const int sy = Sb[(size_t)y * Wv + x];
      // Carries: 0 vertical (x), 1 (1,1) from x - 1, 2 (-1,1) from x + 1; none
      // (the cost itself) on the first row or from outside the frame.
      const T* prev[3] = {nullptr, nullptr, nullptr};
      int sh[3] = {0, 0, 0}, m[3] = {0, 0, 0};
      bool reset[3] = {true, true, true};
      if (ti > 0) {
        const int px[3] = {x, x - 1, x + 1};
        const T* src[3] = {rd + 2 * plane, rd, rd + plane};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (px[i] < 0 || px[i] >= Wv) continue;
          const int delta = sy - sp[px[i]];
          const int lim = i == 0 ? G : reach;
          prev[i] = src[i] + (size_t)px[i] * KS;
          sh[i] = shift_of(delta, i > 0);
          reset[i] = delta > lim || delta < -lim;
          m[i] = svt::band_min(prev[i], sh[i], K, lane);
        }
      }
      for (int k = lane; k < K; k += 32) {
        const int c = static_cast<int>(cp[k]);
        int L[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) L[i] = prev[i] ? svt::band_update(prev[i], sh[i], reset[i], m[i], c, k, K, P1, P2) : c;
        wr[(size_t)x * KS + k] = static_cast<T>(L[1]);
        wr[plane + (size_t)x * KS + k] = static_cast<T>(L[2]);
        wr[2 * plane + (size_t)x * KS + k] = static_cast<T>(L[0]);
        Ob[((size_t)y * Wv + x) * KS + k] = static_cast<T>(L[0] + L[1] + L[2]);
      }
    }
    __syncthreads();
  }
}

// The WTA (6-stat and sub) above 1024: one warp a pixel.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
banded_chunk_wta_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                        const T* __restrict__ v3, int nvol, int npix, int K, int uniq, int sub, int* __restrict__ minS,
                        int* __restrict__ best, int* __restrict__ m2, int* __restrict__ m3, int* __restrict__ m4,
                        uint8_t* __restrict__ uok) {
  const int p = (int)(((long long)blockIdx.x * kWideThreads + threadIdx.x) / 32);
  if (p >= npix) return;  // whole warp
  const int lane = threadIdx.x & 31;
  const T* const vols[4] = {v0, v1, v2, v3};
  const size_t base = (size_t)p * svt::lane_stride(K);
  auto S = [&](int k) {
    int s = 0;
    for (int v = 0; v < nvol; ++v) s += static_cast<int>(vols[v][base + k]);
    return s;
  };
  const svt::WideStats ws = svt::wide_wta(S, K, uniq, lane);
  const WtaStats w{ws.mn, ws.best, ws.sm, ws.s0, ws.sp, ws.ok};
  if (lane == 0) {
    minS[p] = w.mn;
    best[p] = w.bst;
    uok[p] = w.ok ? 1 : 0;
    if (sub) {
      m2[p] = subpixel16(w, K);
    } else {
      m2[p] = w.a;
      m3[p] = w.z;
      m4[p] = w.c;
    }
  }
}

template <typename T>
struct ChunkScans {
  static unsigned blocks(long long warps) { return (unsigned)((warps * 32 + kWideThreads - 1) / kWideThreads); }
  static cudaError_t vertical(const void* C, const int* s, void* dn, void* up, int P, int H, int Wv, int K, int G,
                              int P1, int P2, cudaStream_t st) {
    const int lines = 2 * P * Wv;
    banded_chunk_line_kernel<T, true><<<blocks(lines), kWideThreads, 0, st>>>(
        static_cast<const T*>(C), s, static_cast<T*>(dn), static_cast<T*>(up), lines, H, Wv, K, G, P1, P2, 0);
    return cudaGetLastError();
  }
  static cudaError_t horizontal(const void* C, const int* s, void* out, int P, int H, int Wv, int K, int G, int P1,
                                int P2, int reverse, cudaStream_t st) {
    const int lines = P * H;
    banded_chunk_line_kernel<T, false><<<blocks(lines), kWideThreads, 0, st>>>(
        static_cast<const T*>(C), s, static_cast<T*>(out), nullptr, lines, Wv, Wv, K, G, P1, P2, reverse);
    return cudaGetLastError();
  }
  static cudaError_t diag(const void* C, const int* s, void* dn, void* up, void* scratch, int P, int H, int Wv, int K,
                          int G, int P1, int P2, cudaStream_t st) {
    const size_t smem = scratch ? 0 : (size_t)6 * Wv * svt::lane_stride(K) * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(banded_chunk_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    banded_chunk_diag_kernel<T><<<dim3(P, 2), kWideThreads, smem, st>>>(
        static_cast<const T*>(C), s, static_cast<T*>(dn), static_cast<T*>(up), static_cast<T*>(scratch), H, Wv, K, G,
        P1, P2);
    return cudaGetLastError();
  }
  static cudaError_t wta(const void* const* vp, int nvol, int npix, int K, int uniq, int sub, int* const* maps,
                         uint8_t* uok, cudaStream_t st) {
    banded_chunk_wta_kernel<T><<<blocks(npix), kWideThreads, 0, st>>>(
        static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2]),
        static_cast<const T*>(vp[3]), nvol, npix, K, uniq, sub, maps[0], maps[1], maps[2], maps[3], maps[4], uok);
    return cudaGetLastError();
  }
};

// The widest band the register forms take; above it, ChunkScans.
constexpr int kRegisterBand = 1024;

// ---------------------------------------------------------------- dispatch

// Fn<KP / 32>::run(args...) for 64 < K <= 1024.
template <template <int> class Fn, typename... Args>
cudaError_t wide_dispatch(int K, Args... args) {
  if (K <= 64 || K > kRegisterBand) return cudaErrorInvalidValue;
  if (K <= 128) return Fn<4>::run(args...);
  if (K <= 256) return Fn<8>::run(args...);
  if (K <= 512) return Fn<16>::run(args...);
  return Fn<32>::run(args...);
}

template <typename T>
struct WideScans {
  template <int LPT>
  struct Vertical {
    static cudaError_t run(const void* C, const int* s, void* dn, void* up, int P, int H, int Wv, int K, int G, int P1,
                           int P2, cudaStream_t st) {
      return line_launch<T, kWideGroup, LPT, true>(static_cast<const T*>(C), s, static_cast<T*>(dn),
                                                   static_cast<T*>(up), 2 * P * Wv, H, Wv, K, G, P1, P2, 0, st);
    }
  };
  template <int LPT>
  struct Horizontal {
    static cudaError_t run(const void* C, const int* s, void* out, int P, int H, int Wv, int K, int G, int P1, int P2,
                           int reverse, cudaStream_t st) {
      return line_launch<T, kWideGroup, LPT, false>(static_cast<const T*>(C), s, static_cast<T*>(out), nullptr, P * H,
                                                    Wv, Wv, K, G, P1, P2, reverse, st);
    }
  };
  template <int LPT>
  struct Diag {
    static cudaError_t run(const void* C, const int* s, void* dn, void* up, void* scratch, int P, int H, int Wv, int K,
                           int G, int P1, int P2, cudaStream_t st) {
      const size_t smem = scratch ? 0 : (size_t)6 * Wv * svt::lane_stride(K) * sizeof(T);
      cudaError_t e = cudaFuncSetAttribute(banded_wide_diag_kernel<T, LPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      const int threads = min(wide_diag_threads(LPT), Wv * kWideGroup);
      banded_wide_diag_kernel<T, LPT><<<dim3(P, 2), threads, smem, st>>>(
          static_cast<const T*>(C), s, static_cast<T*>(dn), static_cast<T*>(up), static_cast<T*>(scratch), H, Wv, K, G,
          P1, P2);
      return cudaGetLastError();
    }
  };
  template <int LPT>
  struct Wta {
    static cudaError_t run(const void* const* vp, int nvol, int npix, int K, int uniq, int sub, int* const* maps,
                           uint8_t* uok, cudaStream_t st) {
      const long long blocks = ((long long)npix * kWideGroup + kWideThreads - 1) / kWideThreads;
      banded_wta_wide_kernel<T, LPT><<<(unsigned)blocks, kWideThreads, 0, st>>>(
          static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2]),
          static_cast<const T*>(vp[3]), nvol, npix, K, uniq, sub, maps[0], maps[1], maps[2], maps[3], maps[4], uok);
      return cudaGetLastError();
    }
  };
};

// Bytes of device scratch the 8-path wide scan needs for P frames on
// `device`: 0 where a block's carry rows (6 * Wv * lane_stride(K) values of T) fit the
// device's opt-in shared memory per block, else those bytes for each
// (frame, direction) block; -1 for a failed device query.
template <typename T>
long long wide_diag_scratch_bytes(int P, int Wv, int K, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  const long long carries = 6LL * Wv * svt::lane_stride(K) * (long long)sizeof(T);
  return carries <= optin ? 0 : 2LL * P * carries;
}

// The entry points of banded_wide.cu (T = int16_t) and banded_wide32.cu (T =
// int), one library a storage type: the arguments of svt_banded_vertical
// (with the 8-path vertical's scratch and a `diagonals` flag),
// svt_banded_horizontal and svt_banded_wta, without `bytes`.
template <typename T>
int wide_vertical_entry(const void* C, const void* shift, void* dn, void* up, void* scratch, int P, int H, int Wv,
                        int K, int G, int P1, int P2, int diagonals, void* stream) {
  if (P == 0 || H == 0 || Wv == 0) return cudaSuccess;
  const auto s = static_cast<const int*>(shift);
  const auto st = static_cast<cudaStream_t>(stream);
  if (K > kRegisterBand) {
    if (diagonals) return ChunkScans<T>::diag(C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
    return ChunkScans<T>::vertical(C, s, dn, up, P, H, Wv, K, G, P1, P2, st);
  }
  if (diagonals) return wide_dispatch<WideScans<T>::template Diag>(K, C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
  return wide_dispatch<WideScans<T>::template Vertical>(K, C, s, dn, up, P, H, Wv, K, G, P1, P2, st);
}

template <typename T>
int wide_horizontal_entry(const void* C, const void* shift, void* out, int P, int H, int Wv, int K, int G, int P1,
                          int P2, int reverse, void* stream) {
  if (P == 0 || H == 0 || Wv == 0) return cudaSuccess;
  if (K > kRegisterBand)
    return ChunkScans<T>::horizontal(C, static_cast<const int*>(shift), out, P, H, Wv, K, G, P1, P2, reverse,
                                     static_cast<cudaStream_t>(stream));
  return wide_dispatch<WideScans<T>::template Horizontal>(K, C, static_cast<const int*>(shift), out, P, H, Wv, K, G,
                                                          P1, P2, reverse, static_cast<cudaStream_t>(stream));
}

template <typename T>
int wide_wta_entry(const void* v0, const void* v1, const void* v2, const void* v3, int nvol, void* minS, void* best,
                   void* m2, void* m3, void* m4, void* uok, int npix, int K, int uniq, int sub, void* stream) {
  if (nvol < 2 || nvol > 4) return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  const void* v[4] = {v0, v1, v2, v3};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(m2), static_cast<int*>(m3),
                  static_cast<int*>(m4)};
  if (K > kRegisterBand)
    return ChunkScans<T>::wta(static_cast<const void* const*>(v), nvol, npix, K, uniq, sub,
                              static_cast<int* const*>(maps), static_cast<uint8_t*>(uok),
                              static_cast<cudaStream_t>(stream));
  return wide_dispatch<WideScans<T>::template Wta>(K, static_cast<const void* const*>(v), nvol, npix, K, uniq, sub,
                                                   static_cast<int* const*>(maps), static_cast<uint8_t*>(uok),
                                                   static_cast<cudaStream_t>(stream));
}

}  // namespace
