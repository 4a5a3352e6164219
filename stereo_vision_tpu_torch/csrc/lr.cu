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
// sublane slices and selects the lookups in two stages; here one block per
// (frame, row) builds disp2 in shared memory with atomicMin (a min, so the
// order of the threads does not matter) and every thread then reads its
// two lookups by a direct index. Bounds on an H100 (bytes: each map read
// once, the mask written once): hier4x3 full res, 32 frames of 720 rows,
// 1152 valid columns: 233 MB, ~70 us at 3.35 TB/s; exact8, 4 frames, three
// maps in: 43 MB, ~13 us.

#include "common.cuh"

namespace {

constexpr int kSentinel = 1 << 30;
constexpr int kOob = -(1 << 10);
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lr_fail_kernel(const int* __restrict__ pack, const int* __restrict__ d16, uint8_t* __restrict__ fail, int W, int Wv,
               int ndisp, int max_diff) {
  extern __shared__ int disp2[];  // [W]
  const size_t row = blockIdx.x;
  const int* pk = pack + row * Wv;
  const int* dd = d16 + row * Wv;
  uint8_t* out = fail + row * Wv;
  for (int x2 = threadIdx.x; x2 < W; x2 += blockDim.x) disp2[x2] = kSentinel;
  __syncthreads();
  for (int xv = threadIdx.x; xv < Wv; xv += blockDim.x) {
    const int p = pk[xv];
    const int d = p & 2047;
    const int x2 = xv + ndisp - d;
    if (d < ndisp && x2 >= 0 && x2 < W) atomicMin(&disp2[x2], p);
  }
  __syncthreads();
  for (int xv = threadIdx.x; xv < Wv; xv += blockDim.x) {
    const int v16 = dd[xv];
    const int df = v16 >> 4, dc = (v16 + 15) >> 4;  // floor and ceil of v16 / 16
    const int x = xv + ndisp;
    bool both = true;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sh = i ? dc : df;
      const int c = x - sh;
      int v = kOob;
      if (sh >= -1 && sh <= ndisp && c >= 0 && c < W) {
        const int q = disp2[c];
        v = q >= kSentinel ? kOob : (q & 2047);
      }
      both &= v >= 0 && abs(v - sh) > max_diff;
    }
    out[xv] = both ? 1 : 0;
  }
}

// One block per (frame, row) of the unpacked maps; x = xv + min_x.
__global__ void __launch_bounds__(kThreads)
lr_fail_unpacked_kernel(const int* __restrict__ minS, const int* __restrict__ best, const float* __restrict__ disp,
                        uint8_t* __restrict__ fail, int W, int Wv, int min_x, int ndisp, int mindisp, int max_diff) {
  extern __shared__ int disp2[];  // [W]
  const size_t row = blockIdx.x;
  const int* ms = minS + row * Wv;
  const int* bs = best + row * Wv;
  const float* dv = disp + row * Wv;
  uint8_t* out = fail + row * Wv;
  const int maxD = mindisp + ndisp;
  for (int x2 = threadIdx.x; x2 < W; x2 += blockDim.x) disp2[x2] = kSentinel;
  __syncthreads();
  for (int xv = threadIdx.x; xv < Wv; xv += blockDim.x) {
    const int b = bs[xv];
    if (b < 0 || b >= ndisp) continue;
    const int x2 = xv + min_x - (b + mindisp);
    // cost * 2048 + disparity in wrapping int32 arithmetic, as the plain form.
    const int p = static_cast<int>(static_cast<unsigned>(ms[xv]) * 2048u + static_cast<unsigned>(b + mindisp));
    if (x2 >= 0 && x2 < W) atomicMin(&disp2[x2], p);
  }
  __syncthreads();
  for (int xv = threadIdx.x; xv < Wv; xv += blockDim.x) {
    const float d = dv[xv];
    const int df = static_cast<int>(floorf(d)), dc = static_cast<int>(ceilf(d));
    const int x = xv + min_x;
    bool both = true;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sh = i ? dc : df;
      const int c = x - sh;
      int v = kOob;
      if (sh >= mindisp - 1 && sh <= maxD && c >= 0 && c < W) {
        const int q = disp2[c];
        v = q >= kSentinel ? kOob : (q & 2047);
      }
      both &= v >= mindisp && abs(v - sh) > max_diff;
    }
    out[xv] = both ? 1 : 0;
  }
}

}  // namespace

// (rows, Wv) int32 pack (cost * 2048 + winner) and d16 of the valid columns
// x >= ndisp of rows of width W -> (rows, Wv) uint8 failure mask.
SVT_EXPORT int svt_lr_fail_packed(const void* pack, const void* d16, void* fail, int rows, int W, int Wv, int ndisp,
                                  int max_diff, void* stream) {
  if (ndisp < 1 || ndisp >= 2048 || Wv != W - ndisp) return cudaErrorInvalidValue;
  if (rows == 0 || Wv <= 0) return cudaSuccess;
  const size_t smem = (size_t)W * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(lr_fail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  lr_fail_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pack), static_cast<const int*>(d16), static_cast<uint8_t*>(fail), W, Wv, ndisp,
      max_diff);
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
  const size_t smem = (size_t)W * sizeof(int);
  cudaError_t e =
      cudaFuncSetAttribute(lr_fail_unpacked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  lr_fail_unpacked_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minS), static_cast<const int*>(best), static_cast<const float*>(disp),
      static_cast<uint8_t*>(fail), W, Wv, min_x, ndisp, mindisp, max_diff);
  return cudaGetLastError();
}
