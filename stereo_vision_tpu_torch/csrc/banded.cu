// Band-limited SGBM core of the hierarchical matcher (matcher="sgbm_hier").
//
// Replaces the kernel bodies of stereo_vision_tpu/stereo/banded_pallas.py
// that banded_stats_pack chains:
//   _pix_kernel + _aligned_box_kernel(_srows) -> banded_cost_kernel (banded_cost.cu)
//   _vert_kernel (without diagonals)          -> banded_vertical_kernel
//   _vert_kernel (with diagonals, 8 paths)    -> banded_diag.cuh
//   _horiz_kernel                             -> banded_line_kernel (banded_group.cuh)
//   _wta_kernel (4-stat sub form and 6-stat)  -> banded_wta_kernel
//   _wta_fused_kernel (band 16)               -> banded_wta_fused_kernel
// and the image pyramid's box mean:
//   _downsample_kernel (downsample_box_pack)  -> downsample_box_kernel
//
// Lane k at pixel p is the absolute disparity s(p) + k (s(p) + stride * k
// in the cost kernel's strided search, which only the coarse level runs,
// at s == 0). Every
// cross-pixel term is first re-indexed into p's band by the shift delta,
// with the semantics of stereo_vision_tpu/stereo/banded.py for ANY shift
// map (the TPU kernels realign only at tile entries, which needs
// tile-constant maps): per-step deltas s(p) - s(predecessor), 0 at a
// scan's first row or column.
//   carries: delta == +-G shifts the lanes (no source -> kBig, so that
//     lane's candidate is exactly minL + P2), |delta| > G fills the row
//     with kBig and the update resets to the border rule L = c, any other
//     delta leaves the lanes as they are; the diagonal carries also shift
//     by +-2G when 2G < K (and reset only beyond it), and a diagonal
//     predecessor outside the frame is a zero carry (L = c);
//   window: the same shifts, but a lane with no source, or |delta| > G,
//     takes the centre pixel's own value.
// Layout: banded volumes (P, H, Wv, K) of T, frames on the grid; T is int16
// where the wrappers find that the volumes' bound fits it and int32
// otherwise, and every kernel is one template over T. The cost kernel
// (banded_cost.cu) takes any K % 4 == 0 from 4 at run time; the
// scans and the WTA here take K up to 64 (banded.cuh: instantiated at the
// next power of two, K at run time), banded_wide.cu and banded_wide32.cu
// the bands above 64. The TPU
// kernels' 128-lane frame packing, float32-for-int and tile-entry delta
// rows are not carried over.
//
// What bounds them on an H100 (hier4x3 full-res level, 32 frames of
// 1280x720, K=4, 1152 valid columns; one int16 volume = 212 MB): the cost
// kernel writes one volume and reads the images and shift map (~169 us at
// 3.35 TB/s); vertical reads one and writes two (~190 us); each horizontal
// reads one and writes one (~127 us); the WTA reads three and writes four
// int32 maps and a bool map (~318 us). The scans are also dependent chains
// of H (or Wv) steps. The fused WTA (hier16x3 full level: 8 frames, K=16,
// three 212 MB volumes and a 26.5 MB shift map in, two 26.5 MB int32 maps
// out) is bytes-bound at ~0.21 ms; its operations take under 0.02 ms at
// 67 T/s.
//
// Design (right and simple first, then the cost kernel for Hopper):
//   cost: see banded_cost_kernel (banded_cost.cu).
//   vertical: one thread per (frame, column, direction) walks the rows with
//     its K carries in registers (no diagonals: the down and up scans are
//     independent per column), prefetching the next row. Lane shifts by a
//     runtime delta use a barrel shifter over compile-time offsets.
//   horizontal: see banded_line_kernel.
//   wta: one thread per pixel sums the 2-4 volumes in int32 and reduces
//     over the K lanes. The fused form shares that reduction and the
//     subpixel step, reads the pixel's shift and writes the LR check's pack
//     (minS * 2048 + best + s) and d16 + 32768 * unique_ok; the TPU kernel's
//     8-rows-a-step (W, 128) lane layout and its group-sum matmuls have no
//     counterpart here.
//   downsample: one thread per output pixel; the TPU kernel's 0/1 pooling
//     matmul becomes an integer sum, the float32 division and the
//     half-to-even round stay.

#include "banded_group.cuh"

namespace {

using svt::kBig;
using svt::subpixel16;
using svt::WtaStats;

constexpr int kScanThreads = 128;
constexpr int kDownsampleThreads = 256;

// ------------------------------------------------------------- vertical

// One thread per (frame, column, direction): blockIdx.z = 0 scans down,
// 1 scans up; the delta is s(y) - s(previous row visited).
template <typename T, int KP>
__device__ __forceinline__ void vertical_scan(const T* __restrict__ C, const int* __restrict__ shift,
                                              T* __restrict__ out_dn, T* __restrict__ out_up, int H, int Wv, int K,
                                              int G, int P1, int P2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Wv) return;
  const int b = blockIdx.y, up = blockIdx.z;
  const T* Cb = C + (size_t)b * H * Wv * K;
  T* Ob = (up ? out_up : out_dn) + (size_t)b * H * Wv * K;
  const int* Sb = shift + (size_t)b * H * Wv;
  const int step = up ? -1 : 1;
  int y = up ? H - 1 : 0;
  int L[KP], c[KP], cn[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) L[k] = k < K ? 0 : kBig;
  svt::load_lanes<T, KP>(Cb + ((size_t)y * Wv + x) * K, K, cn, kBig);
  int sn = Sb[(size_t)y * Wv + x], sprev = sn;
  for (int t = 0; t < H; ++t, y += step) {
#pragma unroll
    for (int k = 0; k < KP; ++k) c[k] = cn[k];
    const int sy = sn;
    if (t + 1 < H) {
      svt::load_lanes<T, KP>(Cb + ((size_t)(y + step) * Wv + x) * K, K, cn, kBig);
      sn = Sb[(size_t)(y + step) * Wv + x];
    }
    svt::banded_step<KP>(c, L, sy - sprev, K, G, P1, P2);
    svt::store_lanes<T, KP>(Ob + ((size_t)y * Wv + x) * K, K, L);
    sprev = sy;
  }
}

// K == KP takes a copy of the scan in which K is a constant, so that the
// band's masks fold away and the power-of-two bands run as before.
template <typename T, int KP>
__global__ void __launch_bounds__(kScanThreads)
banded_vertical_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out_dn,
                       T* __restrict__ out_up, int H, int Wv, int K, int G, int P1, int P2) {
  if (KP <= 8 || K == KP) {  // K % 4 == 0 leaves K == KP for KP <= 8
    vertical_scan<T, KP>(C, shift, out_dn, out_up, H, Wv, KP, G, P1, P2);
  } else {
    vertical_scan<T, KP>(C, shift, out_dn, out_up, H, Wv, K, G, P1, P2);
  }
}

// ------------------------------------------------------------ horizontal

// banded_line_kernel (banded_group.cuh) over the (frame, row) lines, a group
// of min(KP, 32) threads a row.

// ------------------------------------------------------------------- WTA

// S = the int32 sum of the nvol (2-4) volumes' K lanes at pixel p; the
// lanes k >= K hold kBig.
template <typename T, int KP>
__device__ __forceinline__ void sum_volumes(const T* const (&vols)[4], int nvol, int p, int K, int (&S)[KP]) {
  int t[KP];
  svt::load_lanes<T, KP>(vols[0] + (size_t)p * K, K, S, 0);
  for (int j = 1; j < nvol; ++j) {
    svt::load_lanes<T, KP>(vols[j] + (size_t)p * K, K, t, 0);
#pragma unroll
    for (int k = 0; k < KP; ++k) S[k] += t[k];
  }
#pragma unroll
  for (int k = 0; k < KP; ++k)
    if (k >= K) S[k] = kBig;
}

template <int KP>
__device__ __forceinline__ WtaStats wta_reduce(const int (&S)[KP], int K, int uniq) {
  WtaStats w{S[0], 0, 0, 0, 0, true};
#pragma unroll
  for (int k = 1; k < KP; ++k)
    if (S[k] < w.mn) {  // the lanes k >= K hold kBig and never win
      w.mn = S[k];
      w.bst = k;
    }
  if (uniq > 0) {
#pragma unroll
    for (int k = 0; k < KP; ++k) w.ok &= !(k < K && abs(k - w.bst) > 1 && w.mn * (100 + uniq) > S[k] * 100);
  }
  const int d0 = min(max(w.bst, 1), K - 2);
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    w.a = k == d0 - 1 ? S[k] : w.a;
    w.z = k == d0 ? S[k] : w.z;
    w.c = k == d0 + 1 ? S[k] : w.c;
  }
  return w;
}

// One thread per pixel: minS, best, the uniqueness verdict, and either the
// samples a, z, c or, with sub, the subpixel parabola.
template <typename T, int KP>
__device__ __forceinline__ void wta_pixel(const T* const (&vols)[4], int nvol, int p, int K, int uniq, int sub,
                                          int* __restrict__ minS, int* __restrict__ best, int* __restrict__ m2,
                                          int* __restrict__ m3, int* __restrict__ m4, uint8_t* __restrict__ uok) {
  int S[KP];
  sum_volumes<T, KP>(vols, nvol, p, K, S);
  const WtaStats w = wta_reduce<KP>(S, K, uniq);
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

// K == KP takes a copy in which K is a constant (see banded_vertical_kernel).
template <typename T, int KP>
__global__ void __launch_bounds__(kScanThreads)
banded_wta_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                  const T* __restrict__ v3, int nvol, int npix, int K, int uniq, int sub, int* __restrict__ minS,
                  int* __restrict__ best, int* __restrict__ m2, int* __restrict__ m3, int* __restrict__ m4,
                  uint8_t* __restrict__ uok) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const T* const vols[4] = {v0, v1, v2, v3};
  if (KP <= 8 || K == KP) {
    wta_pixel<T, KP>(vols, nvol, p, KP, uniq, sub, minS, best, m2, m3, m4, uok);
  } else {
    wta_pixel<T, KP>(vols, nvol, p, K, uniq, sub, minS, best, m2, m3, m4, uok);
  }
}

// The fused form: one thread per pixel writes the LR check's
// pack = minS * 2048 + (best + s) and du = (sub16 + 16 * s) + 32768 * unique_ok,
// s the pixel's shift, in [0, ndisp - K] with 16 * ndisp < 32768 (the
// wrapper checks ndisp), so that best + s fits the pack's 11 bits and d16
// stays below the uniqueness bit; minS < 2^20 (the wrapper checks the
// volumes' bound) keeps the pack in int32.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
banded_wta_fused_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                        const T* __restrict__ v3, int nvol, int npix, int uniq, const int* __restrict__ shift,
                        int* __restrict__ pack, int* __restrict__ du) {
  constexpr int K = 16;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const T* const vols[4] = {v0, v1, v2, v3};
  int S[K];
  sum_volumes<T, K>(vols, nvol, p, K, S);
  const WtaStats w = wta_reduce<K>(S, K, uniq);
  const int s = shift[p];
  pack[p] = w.mn * 2048 + w.bst + s;
  du[p] = subpixel16(w, K) + 16 * s + (w.ok ? 32768 : 0);
}

// ------------------------------------------------------------- dispatch

// Fn<T, KP>::run(args...) for the storage type of `bytes` (2: int16, 4:
// int32) and KP the power of two at or above K (4 <= K <= 64, K % 4 == 0).
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int bytes, int K, Args... args) {
  if (K < 4 || K > 64 || K % 4) return cudaErrorInvalidValue;
  const int kp = K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : K <= 32 ? 32 : 64;
  if (bytes == 2) {
    switch (kp) {
      case 4: return Fn<int16_t, 4>::run(args...);
      case 8: return Fn<int16_t, 8>::run(args...);
      case 16: return Fn<int16_t, 16>::run(args...);
      case 32: return Fn<int16_t, 32>::run(args...);
      default: return Fn<int16_t, 64>::run(args...);
    }
  }
  if (bytes == 4) {
    switch (kp) {
      case 4: return Fn<int, 4>::run(args...);
      case 8: return Fn<int, 8>::run(args...);
      case 16: return Fn<int, 16>::run(args...);
      case 32: return Fn<int, 32>::run(args...);
      default: return Fn<int, 64>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, int KP>
struct VerticalFn {
  static cudaError_t run(const void* C, const int* s, void* dn, void* up, int P, int H, int Wv, int K, int G, int P1,
                         int P2, cudaStream_t st) {
    const dim3 grid((Wv + kScanThreads - 1) / kScanThreads, P, 2);
    banded_vertical_kernel<T, KP><<<grid, kScanThreads, 0, st>>>(static_cast<const T*>(C), s, static_cast<T*>(dn),
                                                                 static_cast<T*>(up), H, Wv, K, G, P1, P2);
    return cudaGetLastError();
  }
};

template <typename T, int KP>
struct HorizontalFn {
  static cudaError_t run(const void* C, const int* s, void* out, int rows, int Wv, int K, int G, int P1, int P2,
                         int reverse, cudaStream_t st) {
    constexpr int GS = KP < 32 ? KP : 32;
    return line_launch<T, GS, KP / GS, false>(static_cast<const T*>(C), s, static_cast<T*>(out), nullptr, rows, Wv,
                                              Wv, K, G, P1, P2, reverse, st);
  }
};

template <typename T, int KP>
struct WtaFn {
  static cudaError_t run(const void* const* vp, int nvol, int npix, int K, int uniq, int sub, int* const* maps,
                         uint8_t* uok, cudaStream_t st) {
    banded_wta_kernel<T, KP><<<(npix + kScanThreads - 1) / kScanThreads, kScanThreads, 0, st>>>(
        static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2]),
        static_cast<const T*>(vp[3]), nvol, npix, K, uniq, sub, maps[0], maps[1], maps[2], maps[3], maps[4], uok);
    return cudaGetLastError();
  }
};

// ------------------------------------------------------------- downsample

// One thread per output pixel of (P, H / fy, W / fx): the integer sum of its
// fy x fx block, then round(sum / (fy * fx)) in float32, half to even (the
// reference's float32 division and round; the sum is exact).
__global__ void __launch_bounds__(kDownsampleThreads)
downsample_box_kernel(const int* __restrict__ in, int* __restrict__ out, int H, int W, int Hc, int Wc, int fy, int fx,
                      int npix) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int b = p / (Hc * Wc), rem = p - b * Hc * Wc;
  const int y = rem / Wc, x = rem - y * Wc;
  const int* src = in + ((size_t)b * H + (size_t)y * fy) * W + (size_t)x * fx;
  int sum = 0;
  for (int i = 0; i < fy; ++i)
    for (int j = 0; j < fx; ++j) sum += src[(size_t)i * W + j];
  out[p] = static_cast<int>(rintf(__fdiv_rn(static_cast<float>(sum), static_cast<float>(fy * fx))));
}

}  // namespace

// (P, H, Wv, K) cost + (P, H, Wv) shift map -> the down and up vertical
// direction volumes, all of the type of `bytes`.
SVT_EXPORT int svt_banded_vertical(const void* C, const void* shift, void* dn, void* up, int P, int H, int Wv, int K,
                                   int G, int P1, int P2, int bytes, void* stream) {
  return dispatch<VerticalFn>(bytes, K, C, static_cast<const int*>(shift), dn, up, P, H, Wv, K, G, P1, P2,
                              static_cast<cudaStream_t>(stream));
}

// (P, H, Wv, K) cost + (P, H, Wv) shift map -> one horizontal direction volume.
SVT_EXPORT int svt_banded_horizontal(const void* C, const void* shift, void* out, int P, int H, int Wv, int K, int G,
                                     int P1, int P2, int reverse, int bytes, void* stream) {
  if (P == 0 || H == 0 || Wv == 0) return cudaSuccess;
  return dispatch<HorizontalFn>(bytes, K, C, static_cast<const int*>(shift), out, P * H, Wv, K, G, P1, P2, reverse,
                                static_cast<cudaStream_t>(stream));
}

// nvol (2-4) (npix, K) volumes of one type -> minS, best and either sub16
// (sub) or sm, s0, sp (int32), and the uniqueness verdict (uint8). m3/m4 and
// v2/v3 may be null when unused.
SVT_EXPORT int svt_banded_wta(const void* v0, const void* v1, const void* v2, const void* v3, int nvol, void* minS,
                              void* best, void* m2, void* m3, void* m4, void* uok, int npix, int K, int uniq,
                              int sub, int bytes, void* stream) {
  if (nvol < 2 || nvol > 4) return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  const void* v[4] = {v0, v1, v2, v3};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(m2), static_cast<int*>(m3),
                  static_cast<int*>(m4)};
  return dispatch<WtaFn>(bytes, K, static_cast<const void* const*>(v), nvol, npix, K, uniq, sub,
                         static_cast<int* const*>(maps), static_cast<uint8_t*>(uok),
                         static_cast<cudaStream_t>(stream));
}

// nvol (2-4) (npix, 16) volumes of one type + the int32 (npix) shift map ->
// the int32 pack and du maps of the fused WTA; band 16 only, as the TPU kernel.
SVT_EXPORT int svt_banded_wta_fused(const void* v0, const void* v1, const void* v2, const void* v3, int nvol,
                                    const void* shift, void* pack, void* du, int npix, int K, int uniq, int bytes,
                                    void* stream) {
  if (nvol < 2 || nvol > 4 || K != 16 || (bytes != 2 && bytes != 4)) return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  const int blocks = (npix + kScanThreads - 1) / kScanThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s = static_cast<const int*>(shift);
  const auto pk = static_cast<int*>(pack), d = static_cast<int*>(du);
  if (bytes == 2) {
    using T = int16_t;
    banded_wta_fused_kernel<T><<<blocks, kScanThreads, 0, st>>>(
        static_cast<const T*>(v0), static_cast<const T*>(v1), static_cast<const T*>(v2), static_cast<const T*>(v3),
        nvol, npix, uniq, s, pk, d);
  } else {
    using T = int;
    banded_wta_fused_kernel<T><<<blocks, kScanThreads, 0, st>>>(
        static_cast<const T*>(v0), static_cast<const T*>(v1), static_cast<const T*>(v2), static_cast<const T*>(v3),
        nvol, npix, uniq, s, pk, d);
  }
  return cudaGetLastError();
}

// (P, H, W) int32 image -> (P, H / fy, W / fx) int32 box mean (trailing rows and
// columns that fill no block are dropped).
SVT_EXPORT int svt_downsample_box(const void* in, void* out, int P, int H, int W, int fy, int fx, void* stream) {
  if (fy < 1 || fx < 1 || fy * fx > (1 << 16)) return cudaErrorInvalidValue;
  const int Hc = H / fy, Wc = W / fx, npix = P * Hc * Wc;
  if (npix == 0) return cudaSuccess;
  downsample_box_kernel<<<(npix + kDownsampleThreads - 1) / kDownsampleThreads, kDownsampleThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(in), static_cast<int*>(out),
                                                               H, W, Hc, Wc, fy, fx, npix);
  return cudaGetLastError();
}
