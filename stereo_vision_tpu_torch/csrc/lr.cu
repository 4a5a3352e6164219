// Left-right consistency check of the hierarchical matcher's assembly.
//
// Replaces the kernel body stereo_vision_tpu/stereo/lr_pallas.py::_lr_kernel
// in its packed form (lr_fail_pallas_packed): from the WTA's packed
// (cost, winner) map and the 16x fixed-point disparity d16 of the valid
// columns x >= ndisp, the mask of pixels cv2's LR rule invalidates.
//
//   disp2[x2] = winner of the least packed value (cost * 2048 + d, so ties
//     go to the smaller d) among the valid left pixels x = x2 + d whose
//     winner is d: cv2's projection of the left disparities onto the right
//     view; empty -> -1024;
//   the pixel fails where both lookups disp2[x - floor(d16 / 16)] and
//     disp2[x - ceil(d16 / 16)] hold a disparity >= 0 that differs from the
//     lookup's own by more than max_diff (lookups outside the frame, or with
//     a shift outside [-1, ndisp], read -1024 and pass).
//
// The TPU kernel transposes 128-row blocks so that its shifts become
// sublane slices and selects the lookups in two stages; here one block per
// (frame, row) builds disp2 in shared memory with atomicMin (a min, so the
// order of the threads does not matter) and every thread then reads its
// two lookups by a direct index. Bound on an H100 (hier4x3 full res, 32
// frames of 720 rows, 1152 valid columns): two int32 maps in, one bool map
// out, 233 MB, ~70 us at 3.35 TB/s.

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
