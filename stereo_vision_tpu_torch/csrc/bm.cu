// Block matching (cv2.StereoBM semantics) fused into one pass.
//
// Replaces stereo_vision_tpu/stereo/bm_pallas.py::bm_stats_pallas (kernel
// body _bm_kernel): SAD over a bs x bs window for every disparity, texture
// threshold, winner-take-all (ties -> smallest d), cv2's integer uniqueness
// check, the modified-parabola subpixel step and the left range mask, from
// two prefiltered images to one float32 map of the window-centre region,
// (B, H-bs+1, W-bs+1), invalid = min_disparity - 1. The SAD cost volume
// never reaches device memory. Any min_disparity: the right sample of
// disparity index d is rp[x - s], s = max(min_disparity + d, 0), and 0 left
// of the frame (the reference's zero pad + clamped slice). All arithmetic is
// int32 (the TPU kernel's float32 booleans and reciprocal nudge were Mosaic
// workarounds); the subpixel division is __fdiv_rn and the final add
// __fadd_rn, as float32 does them on the reference.
//
// What bounds it on an H100: operations. Per (valid pixel, d) about 8
// 32-bit operations remain with running sums in both directions (an
// absolute difference, the vertical add and subtract, the horizontal add
// and subtract, min and argmin); at 1920x1080, D=128, 8 frames that is
// 17 G operations, ~0.25 ms at 67 T/s, against 0.06 ms for the bytes (two
// int32 images in, one float32 map out).
//
// Design (simple first): one block per (frame, strip of TX output columns,
// chunk of RY output rows). The block walks down its rows keeping, in
// shared memory, the vertical window sums V[column][d] of the strip plus
// its bs-1 halo columns (and the texture sums T[column]); each row step
// stages the entering and the leaving image rows in shared memory, adds the
// entering row's |lp - rp_s| and subtracts the leaving row's, recomputed
// rather than kept in a ring. Then each warp takes TX/8 consecutive output
// pixels with a running horizontal sum over d = k*32 + lane, and reduces
// min, argmin, uniqueness and the three subpixel samples with shuffles.
// Row chunks cost bs-1 warm-up rows each and give the grid enough blocks.
//
// Above 1024 disparities, and wherever the window sums of even an 8-column
// strip pass a block's shared memory, bm_wide_kernel takes the call: the
// same row walk, each output pixel's costs summed from V for one d at a
// time (d = lane, lane + 32, ...) in two passes (minimum and argmin, then
// uniqueness and the samples), V in shared memory or, where it does not
// fit, in a slot of device scratch a resident block, the blocks walking the
// (strip, row chunk, frame) items. No main path runs it.

#include <algorithm>

#include "common.cuh"

namespace {

using svt::kFullMask;
using svt::warp_min;
using svt::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBig = 1 << 30;  // cost of a padding disparity (d >= D)

// Floor division by 100, as the reference's // (any sign).
__device__ __forceinline__ int floor_div100(int a) {
  const int q = a / 100;
  return (a % 100 != 0 && a < 0) ? q - 1 : q;
}

// Row step of a strip's walk: stage the entering left and right rows y
// (and, where `leave`, the leaving rows y - bs) of the strip's NC left and
// NR right columns, then add the entering row's |lp - rp_s| to the window
// sums V[j][d] and its |lp - cap| to T[j], and subtract the leaving row's.
// Every thread of the block takes part.
__device__ __forceinline__ void bm_row_step(const int* __restrict__ L, const int* __restrict__ R, int* V, int* T,
                                            int* Ln, int* Lo, int* Rn, int* Ro, int W, int D, int mindisp, int bs,
                                            int cap, int NC, int NR, int smax, int x0, int y, bool leave) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous step has read V, T and the staged rows
  for (int j = threadIdx.x; j < NC; j += kThreads) {
    const int c = x0 + j;
    Ln[j] = c < W ? L[(size_t)y * W + c] : 0;
    if (leave) Lo[j] = c < W ? L[(size_t)(y - bs) * W + c] : 0;
  }
  for (int i = threadIdx.x; i < NR; i += kThreads) {
    const int c = x0 - smax + i;
    const bool in = c >= 0 && c < W;
    Rn[i] = in ? R[(size_t)y * W + c] : 0;
    if (leave) Ro[i] = in ? R[(size_t)(y - bs) * W + c] : 0;
  }
  __syncthreads();
  for (int j = warp; j < NC; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      const int i = j + smax - max(mindisp + d, 0);
      int v = V[j * D + d] + abs(Ln[j] - Rn[i]);
      if (leave) v -= abs(Lo[j] - Ro[i]);
      V[j * D + d] = v;
    }
  }
  for (int j = threadIdx.x; j < NC; j += kThreads) {
    int v = T[j] + abs(Ln[j] - cap);
    if (leave) v -= abs(Lo[j] - cap);
    T[j] = v;
  }
}

// KPL disparities per lane: d = k*32 + lane, k < KPL (D <= 32 * KPL).
template <int KPL>
__global__ void __launch_bounds__(kThreads)
bm_kernel(const int* __restrict__ lp, const int* __restrict__ rp, float* __restrict__ out, int H, int W, int D,
          int mindisp, int bs, int cap, int uniq, int tex_thr, int TX, int RY) {
  extern __shared__ int smem[];
  const int NC = TX + bs - 1;                                     // input columns of the strip
  const int smin = max(mindisp, 0), smax = max(mindisp + D - 1, 0);
  const int NR = NC + smax - smin;                                // right samples of a row
  int* V = smem;                                                  // [NC][D]
  int* T = V + NC * D;                                            // [NC]
  int* Ln = T + NC;                                               // [NC] entering left row
  int* Lo = Ln + NC;                                              // [NC] leaving left row
  int* Rn = Lo + NC;                                              // [NR] right columns x0 - smax ..
  int* Ro = Rn + NR;

  const int Hv = H - bs + 1, Wv = W - bs + 1;
  const int b = blockIdx.z, x0 = blockIdx.x * TX, yv0 = blockIdx.y * RY;
  const int nout = min(RY, Hv - yv0);
  const int* L = lp + (size_t)b * H * W;
  const int* R = rp + (size_t)b * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpw = TX / kWarps;  // output columns per warp

  for (int i = threadIdx.x; i < NC * D; i += kThreads) V[i] = 0;
  for (int i = threadIdx.x; i < NC; i += kThreads) T[i] = 0;

  for (int t = 0; t < nout + bs - 1; ++t) {
    const int y = yv0 + t;  // the entering row; row y - bs leaves the window from t = bs on
    bm_row_step(L, R, V, T, Ln, Lo, Rn, Ro, W, D, mindisp, bs, cap, NC, NR, smax, x0, y, t >= bs);
    if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)
    __syncthreads();

    const int yv = y - bs + 1;
    int cost[KPL];
    int tex = 0;
    for (int q = 0; q < cpw; ++q) {
      const int tc = warp * cpw + q;  // strip column of this output pixel
      if (q == 0) {
#pragma unroll
        for (int k = 0; k < KPL; ++k) cost[k] = 0;
        for (int w = 0; w < bs; ++w) {
#pragma unroll
          for (int k = 0; k < KPL; ++k) {
            const int d = k * 32 + lane;
            if (d < D) cost[k] += V[(tc + w) * D + d];
          }
          tex += T[tc + w];
        }
      } else {
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          const int d = k * 32 + lane;
          if (d < D) cost[k] += V[(tc - 1 + bs) * D + d] - V[(tc - 1) * D + d];
        }
        tex += T[tc - 1 + bs] - T[tc - 1];
      }
      int m = kBig;
#pragma unroll
      for (int k = 0; k < KPL; ++k) m = min(m, k * 32 + lane < D ? cost[k] : kBig);
      const int mn = warp_min(m);
      int bl = kBig;
#pragma unroll
      for (int k = 0; k < KPL; ++k)
        if (k * 32 + lane < D && cost[k] == mn) bl = min(bl, k * 32 + lane);
      const int best = warp_min(bl);
      const int thresh = mn + floor_div100(mn * uniq);
      bool offend = false;
      int c0 = 0, cn = 0, cp = 0;
      const int d0 = min(max(best, 1), D - 2);
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int d = k * 32 + lane;
        if (d < D) {
          offend |= abs(d - best) > 1 && cost[k] <= thresh;
          c0 += d == d0 ? cost[k] : 0;
          cn += d == d0 - 1 ? cost[k] : 0;
          cp += d == d0 + 1 ? cost[k] : 0;
        }
      }
      const bool unique_ok = !__any_sync(kFullMask, offend);
      c0 = warp_sum(c0);
      cn = warp_sum(cn);
      cp = warp_sum(cp);
      const int xv = x0 + tc;
      if (lane == 0 && xv < Wv) {
        const int denom = cp + cn - 2 * c0 + abs(cp - cn);
        float delta = 0.0f;
        if (best > 0 && best < D - 1 && denom != 0) delta = __fdiv_rn((float)(cn - cp), (float)denom);
        const float disp = __fadd_rn((float)(best + mindisp), delta);
        const bool ok = unique_ok && tex >= tex_thr && xv - (mindisp + D - 1) >= 0;
        out[((size_t)b * Hv + yv) * Wv + xv] = ok ? disp : (float)(mindisp - 1);
      }
    }
  }
}

size_t smem_bytes(int TX, int D, int bs, int mindisp) {
  const int NC = TX + bs - 1;
  const int NR = NC + max(mindisp + D - 1, 0) - max(mindisp, 0);
  return (size_t)(NC * D + 3 * NC + 2 * NR) * sizeof(int);
}

// The staged rows and texture sums of a strip (always shared memory):
// T [NC], Ln [NC], Lo [NC], Rn [NR], Ro [NR].
size_t stage_ints(int TX, int D, int bs, int mindisp) {
  const int NC = TX + bs - 1;
  const int NR = NC + max(mindisp + D - 1, 0) - max(mindisp, 0);
  return (size_t)3 * NC + 2 * NR;
}

// Any D; V at `scratch` + blockIdx.x * slot ints where given, else in shared
// memory after the staging; items (strip, row chunk, frame) = blockIdx.x,
// + gridDim.x, ...
__global__ void __launch_bounds__(kThreads)
bm_wide_kernel(const int* __restrict__ lp, const int* __restrict__ rp, float* __restrict__ out, int H, int W, int D,
               int mindisp, int bs, int cap, int uniq, int tex_thr, int TX, int RY, int* scratch, size_t slot, int nx,
               int ny, int items) {
  extern __shared__ int smem[];
  const int NC = TX + bs - 1;
  const int smin = max(mindisp, 0), smax = max(mindisp + D - 1, 0);
  const int NR = NC + smax - smin;
  int* T = smem;     // [NC]
  int* Ln = T + NC;  // [NC]
  int* Lo = Ln + NC;
  int* Rn = Lo + NC;  // [NR]
  int* Ro = Rn + NR;
  int* V = scratch ? scratch + blockIdx.x * slot : Ro + NR;  // [NC][D]
  const int Hv = H - bs + 1, Wv = W - bs + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpw = TX / kWarps;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bx = item % nx, by = item / nx % ny, b = item / (nx * ny);
    const int x0 = bx * TX, yv0 = by * RY;
    const int nout = min(RY, Hv - yv0);
    const int* L = lp + (size_t)b * H * W;
    const int* R = rp + (size_t)b * H * W;
    __syncthreads();  // the previous item has read V, T and the staged rows
    for (size_t i = threadIdx.x; i < (size_t)NC * D; i += kThreads) V[i] = 0;
    for (int i = threadIdx.x; i < NC; i += kThreads) T[i] = 0;

    for (int t = 0; t < nout + bs - 1; ++t) {
      const int y = yv0 + t;
      bm_row_step(L, R, V, T, Ln, Lo, Rn, Ro, W, D, mindisp, bs, cap, NC, NR, smax, x0, y, t >= bs);
      if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)
      __syncthreads();

      const int yv = y - bs + 1;
      for (int q = 0; q < cpw; ++q) {
        const int tc = warp * cpw + q;  // strip column of this output pixel
        const int xv = x0 + tc;
        auto cost = [&](int d) {
          int s = 0;
          for (int w = 0; w < bs; ++w) s += V[(size_t)(tc + w) * D + d];
          return s;
        };
        int tex = 0;
        for (int w = 0; w < bs; ++w) tex += T[tc + w];
        int m = kBig, arg = kBig;
        for (int d = lane; d < D; d += 32) {
          const int c = cost(d);
          if (c < m) m = c, arg = d;
        }
        const int mn = warp_min(m);
        const int best = warp_min(m == mn ? arg : kBig);
        const int thresh = mn + floor_div100(mn * uniq);
        bool offend = false;
        for (int d = lane; d < D; d += 32) offend |= abs(d - best) > 1 && cost(d) <= thresh;
        const bool unique_ok = !__any_sync(kFullMask, offend);
        const int d0 = min(max(best, 1), D - 2);
        auto sample = [&](int d) { return d >= 0 && d < D ? cost(d) : 0; };
        const int c0 = sample(d0), cn = sample(d0 - 1), cp = sample(d0 + 1);
        if (lane == 0 && xv < Wv) {
          const int denom = cp + cn - 2 * c0 + abs(cp - cn);
          float delta = 0.0f;
          if (best > 0 && best < D - 1 && denom != 0) delta = __fdiv_rn((float)(cn - cp), (float)denom);
          const float disp = __fadd_rn((float)(best + mindisp), delta);
          const bool ok = unique_ok && tex >= tex_thr && xv - (mindisp + D - 1) >= 0;
          out[((size_t)b * Hv + yv) * Wv + xv] = ok ? disp : (float)(mindisp - 1);
        }
      }
    }
  }
}

// The wide form's geometry: strip width TX (64, halved while V and the
// staging pass `optin`; V goes to scratch where even 8 columns pass it),
// row chunks RY, and the items.
struct WidePlan {
  int TX, RY, nx, ny, items, blocks;
  size_t slot, smem;  // ints of V a scratch slot (0: V in shared memory), bytes of shared memory
  WidePlan(int B, int H, int W, int D, int mindisp, int bs, int sms, int optin) {
    const int Hv = H - bs + 1, Wv = W - bs + 1;
    auto v_ints = [&](int tx) { return (size_t)(tx + bs - 1) * D; };
    TX = 64;
    while (TX > kWarps && (v_ints(TX) + stage_ints(TX, D, bs, mindisp)) * 4 > (size_t)optin) TX /= 2;
    const bool fits = (v_ints(TX) + stage_ints(TX, D, bs, mindisp)) * 4 <= (size_t)optin;
    if (!fits) TX = 64;
    nx = (Wv + TX - 1) / TX;
    RY = 64;
    while (RY > 16 && (long long)B * nx * ((Hv + RY - 1) / RY) < 2LL * sms) RY /= 2;
    ny = (Hv + RY - 1) / RY;
    const long long n = (long long)B * nx * ny;
    items = (int)std::min(n, (long long)INT32_MAX);
    blocks = fits ? items : (int)std::min(n, 2LL * sms);
    slot = fits ? 0 : (v_ints(TX) + 63) / 64 * 64;
    smem = (stage_ints(TX, D, bs, mindisp) + (fits ? v_ints(TX) : 0)) * 4;
  }
};

// Whether bm_kernel takes the call (D <= 1024 and an 8-column strip fits).
bool register_form(int D, int bs, int mindisp, int optin) {
  return D <= 1024 && smem_bytes(kWarps, D, bs, mindisp) <= (size_t)optin;
}

int device_attr(cudaDeviceAttr attr, int device) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, attr, device) == cudaSuccess ? v : -1;
}

template <int KPL>
cudaError_t launch(const int* lp, const int* rp, float* out, int B, int H, int W, int D, int mindisp, int bs,
                   int cap, int uniq, int tex_thr, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  // Strip width: 64 output columns (8 a warp), narrower only where the
  // window sums would not fit the block's shared memory.
  int TX = 64;
  while (TX > kWarps && smem_bytes(TX, D, bs, mindisp) > (size_t)smem_max) TX /= 2;
  const size_t smem = smem_bytes(TX, D, bs, mindisp);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  const int Hv = H - bs + 1, Wv = W - bs + 1;
  const int nx = (Wv + TX - 1) / TX;
  // Row chunks of 64 output rows, shorter until the grid has two blocks an SM.
  int RY = 64;
  while (RY > 16 && (long long)B * nx * ((Hv + RY - 1) / RY) < 2LL * sms) RY /= 2;
  e = cudaFuncSetAttribute(bm_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nx, (Hv + RY - 1) / RY, B);
  bm_kernel<KPL><<<grid, kThreads, smem, stream>>>(lp, rp, out, H, W, D, mindisp, bs, cap, uniq, tex_thr, TX, RY);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch svt_bm_disparity needs on `device` (0: none);
// -1 for a failed device query.
SVT_EXPORT long long svt_bm_scratch_bytes(int B, int H, int W, int D, int mindisp, int bs, int device) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, device);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (sms < 1 || optin < 0) return -1;
  if (D < 1 || bs < 1 || H < bs || W < bs || B == 0 || register_form(D, bs, mindisp, optin)) return 0;
  const WidePlan plan(B, H, W, D, mindisp, bs, sms, optin);
  return (long long)plan.blocks * (long long)plan.slot * 4;
}

// (B, H, W) int32 prefiltered left/right -> (B, H-bs+1, W-bs+1) float32
// disparity of the window centres (invalid = mindisp - 1). D <= 1024: KPL =
// ceil(D / 32) to 8 (D <= 256), then 16 and 32 disparities a lane; above
// 1024, or where an 8-column strip's window sums pass the shared memory,
// bm_wide_kernel (with `scratch`, svt_bm_scratch_bytes of it, where V
// does not fit).
SVT_EXPORT int svt_bm_disparity(const void* lp, const void* rp, void* out, int B, int H, int W, int D, int mindisp,
                                int bs, int cap, int uniq, int tex_thr, void* scratch, void* stream) {
  if (D < 1 || bs < 1 || H < bs || W < bs) return cudaErrorInvalidValue;
  const auto l = static_cast<const int*>(lp);
  const auto r = static_cast<const int*>(rp);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, dev);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (sms < 1 || optin < 0) return cudaErrorInvalidValue;
  if (!register_form(D, bs, mindisp, optin)) {
    if (B == 0) return cudaSuccess;
    const WidePlan plan(B, H, W, D, mindisp, bs, sms, optin);
    if (plan.slot && !scratch) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(bm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return e;
    bm_wide_kernel<<<plan.blocks, kThreads, plan.smem, st>>>(l, r, o, H, W, D, mindisp, bs, cap, uniq, tex_thr,
                                                              plan.TX, plan.RY, static_cast<int*>(scratch),
                                                              plan.slot, plan.nx, plan.ny, plan.items);
    return cudaGetLastError();
  }
  switch ((D + 31) / 32) {
    case 1: return launch<1>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 2: return launch<2>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 3: return launch<3>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 4: return launch<4>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 5: return launch<5>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 6: return launch<6>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 7: return launch<7>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    case 8: return launch<8>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
    default:
      if (D <= 512) return launch<16>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
      return launch<32>(l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, st);
  }
}
