// Shared helpers of the port's CUDA kernels (plain C interface, loaded with
// ctypes). Every C entry point returns the cudaError_t of its launches;
// svt_error_string names it for the Python wrapper's exception.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SVT_EXPORT extern "C" __attribute__((visibility("default")))

SVT_EXPORT const char* svt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace svt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

}  // namespace svt
