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

// A thread's own asynchronous copies of global rows (or columns) into a ring
// of shared memory (cp.async: the data goes to shared memory without passing through
// registers, and the thread waits only when it reads the slot). Each copy
// group is one row (column); cp_async_wait_ring(S) waits until at most S - 1 groups
// are pending, i.e. until the oldest of S in flight has landed.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_ring(int S) {
  switch (S) {
    case 2: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 8: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    case 16: asm volatile("cp.async.wait_group 15;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// Birchfield-Tomasi pieces shared by the exact and the banded cost kernels.

// SGBM's clipped x-Sobel of image row y at column x; columns 0 and W-1 are
// ftzero (stereo_vision_tpu/stereo/sgbm.py::_xsobel_clipped).
__device__ __forceinline__ int xsobel(const int* __restrict__ img, int H, int W, int y, int x, int ftzero) {
  if (x <= 0 || x >= W - 1) return ftzero;
  const int* rm = img + clampi(y - 1, 0, H - 1) * W;
  const int* r0 = img + y * W;
  const int* rp = img + clampi(y + 1, 0, H - 1) * W;
  const int d = 2 * (r0[x + 1] - r0[x - 1]) + (rm[x + 1] - rm[x - 1]) + (rp[x + 1] - rp[x - 1]);
  return clampi(d, -ftzero, ftzero) + ftzero;
}

// Value, low and high BT half-sample extrema from a sample and its two
// (edge-clamped) neighbours: vl = (v + v[-1]) >> 1, vr = (v + v[+1]) >> 1.
__device__ __forceinline__ void extrema(int v, int vm, int vp, int* out, int stride) {
  const int vl = (v + vm) >> 1, vr = (v + vp) >> 1;
  out[0] = v;
  out[stride] = min(min(vl, vr), v);
  out[2 * stride] = max(max(vl, vr), v);
}

__device__ __forceinline__ int bt(int l, int l0, int l1, int v, int v0, int v1) {
  const int c0 = max(max(0, l - v1), v0 - l);
  const int c1 = max(max(0, v - l1), l0 - v);
  return min(c0, c1);
}

}  // namespace svt
