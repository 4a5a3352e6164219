// Disparity speckle filter (cv2.filterSpeckles semantics, optional diameter cap).
//
// Replaces the kernel body stereo_vision_tpu/stereo/speckle_pallas.py::
// _speckle_kernel (speckle_filter_pallas). The function is the plain form's,
// stereo_vision_tpu_torch/stereo/postprocess.py::speckle_filter, on
// (P, H, W) float32 frames: 4-connected blobs of valid pixels (d > invalid)
// whose neighbours differ by <= max_diff are set to invalid where their size
// is <= S. With R rounds (R = S - 1, or the diameter cap):
//   init       the four neighbour masks, label = y * W + x, arrival round 0;
//   R rounds   label min-propagation; a pixel whose label drops records the
//              round (arrival round A);
//   parents    the first masked neighbour (in the plain form's _OFFS order)
//              with the same label and a smaller A; none = root (4); subtree
//              counts s = 1; taint seeded where a masked neighbour's label
//              differs (the blob did not converge in R rounds);
//   R rounds   up-sweep s = 1 + sum of the children's s, each with one taint
//              round; the last writes total = s at roots, 0 elsewhere;
//   R rounds   down-broadcast total from the parent, each with one taint
//              round; the last removes valid, untainted pixels whose total
//              is <= S and writes the output.
// 3R + 2 launches, one thread per pixel, frames on the grid. Every round
// reads the previous round's values of its neighbours, as the whole-array
// updates of the plain form and of the TPU kernel do, so label, count and
// taint ping-pong between two buffers: an update in place would change the
// arrival rounds, then the parent forest, then the totals. The masks are the
// plain form's float32 |d_q - d_p| <= max_diff (no fast-math flags).
//
// The TPU kernel keeps the whole frame in VMEM across a 3R+3-step grid and
// emulates booleans in float32; here the state lives in device memory (per
// pixel: int32 label x2, arrival round, count x2; uint8 masks, parent, taint
// x2) and the masks are bits of one byte. What bounds it on an H100: each
// round streams ~12-17 bytes per pixel of state (exact8: 4 x 720 x 1280
// pixels, 300 launches); the function itself reads one float map and writes
// one, so its bound is the operations of the 3R rounds (~42 per pixel and
// round). A later design keeps tiles of rounds in shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRoot = 4;
constexpr uint8_t kValidBit = 16;

// The plain form's _OFFS (dy, dx) and _OPP.
__device__ __constant__ int kDy[4] = {1, -1, 0, 0};
__device__ __constant__ int kDx[4] = {0, 0, 1, -1};
__device__ __constant__ int kOpp[4] = {1, 0, 3, 2};

struct Pixel {
  size_t p;  // flat index in (P, H, W)
  int y, x;
  bool ok;
};

// One thread per pixel: blockIdx.x is the (frame, row), blockIdx.y * kThreads
// + threadIdx.x the column.
__device__ __forceinline__ Pixel pixel(int H, int W) {
  Pixel px;
  px.x = blockIdx.y * kThreads + threadIdx.x;
  px.y = blockIdx.x % H;
  px.ok = px.x < W;
  px.p = (size_t)blockIdx.x * W + px.x;
  return px;
}

__device__ __forceinline__ size_t nb(const Pixel& px, int i, int W) {
  return px.p + (ptrdiff_t)kDy[i] * W + kDx[i];
}

__global__ void __launch_bounds__(kThreads)
speckle_init(const float* __restrict__ disp, uint8_t* __restrict__ mask, int* __restrict__ lab, int* __restrict__ A,
             int H, int W, float max_diff, float invalid) {
  const Pixel px = pixel(H, W);
  if (!px.ok) return;
  const float d = disp[px.p];
  const bool valid = d > invalid;
  uint8_t bits = valid ? kValidBit : 0;
  if (valid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = px.y + kDy[i], xx = px.x + kDx[i];
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const float q = disp[nb(px, i, W)];
      if (q > invalid && fabsf(q - d) <= max_diff) bits |= 1 << i;
    }
  }
  mask[px.p] = bits;
  lab[px.p] = px.y * W + px.x;
  A[px.p] = 0;
}

// Round r of label min-propagation: lab_out = min over the masked
// neighbours' lab_in; A = r where the label dropped.
__global__ void __launch_bounds__(kThreads)
speckle_propagate(const uint8_t* __restrict__ mask, const int* __restrict__ lab_in, int* __restrict__ lab_out,
                  int* __restrict__ A, int H, int W, int r) {
  const Pixel px = pixel(H, W);
  if (!px.ok) return;
  const uint8_t bits = mask[px.p];
  const int l = lab_in[px.p];
  int m = l;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (bits & (1 << i)) m = min(m, lab_in[nb(px, i, W)]);
  lab_out[px.p] = m;
  if (m < l) A[px.p] = r;
}

// Parent direction, subtree count 1 and the taint seed.
__global__ void __launch_bounds__(kThreads)
speckle_parents(const uint8_t* __restrict__ mask, const int* __restrict__ lab, const int* __restrict__ A,
                uint8_t* __restrict__ pdir, int* __restrict__ s, uint8_t* __restrict__ taint, int H, int W) {
  const Pixel px = pixel(H, W);
  if (!px.ok) return;
  const uint8_t bits = mask[px.p];
  const int l = lab[px.p], a = A[px.p];
  int parent = kRoot;
  bool seed = false;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if (!(bits & (1 << i))) continue;
    const size_t q = nb(px, i, W);
    const int lq = lab[q];
    if (lq == l && A[q] < a) parent = i;  // the lowest qualifying direction wins
    seed |= lq != l;
  }
  pdir[px.p] = static_cast<uint8_t>(parent);
  s[px.p] = 1;
  taint[px.p] = seed ? 1 : 0;
}

__device__ __forceinline__ uint8_t taint_round(const Pixel& px, uint8_t bits, const uint8_t* __restrict__ taint_in,
                                               int W) {
  uint8_t t = taint_in[px.p];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (bits & (1 << i)) t |= taint_in[nb(px, i, W)];
  return t;
}

// One up-sweep round (s = 1 + the children's s; a child q of p is a masked
// neighbour whose parent direction points back at p) and one taint round.
// The last round writes total = s at the roots and 0 elsewhere.
__global__ void __launch_bounds__(kThreads)
speckle_up(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ pdir, const int* __restrict__ s_in,
           int* __restrict__ s_out, const uint8_t* __restrict__ taint_in, uint8_t* __restrict__ taint_out, int H,
           int W, int last) {
  const Pixel px = pixel(H, W);
  if (!px.ok) return;
  const uint8_t bits = mask[px.p];
  int sum = 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!(bits & (1 << i))) continue;
    const size_t q = nb(px, i, W);
    if (pdir[q] == kOpp[i]) sum += s_in[q];
  }
  s_out[px.p] = last && pdir[px.p] != kRoot ? 0 : sum;
  taint_out[px.p] = taint_round(px, bits, taint_in, W);
}

// One down-broadcast round (total from the parent) and one taint round. The
// last round writes the filtered disparity instead of the state.
__global__ void __launch_bounds__(kThreads)
speckle_down(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ pdir, const int* __restrict__ t_in,
             int* __restrict__ t_out, const uint8_t* __restrict__ taint_in, uint8_t* __restrict__ taint_out,
             const float* __restrict__ disp, float* __restrict__ out, int H, int W, int S, float invalid, int last) {
  const Pixel px = pixel(H, W);
  if (!px.ok) return;
  const uint8_t bits = mask[px.p];
  const int parent = pdir[px.p];
  const int total = parent == kRoot ? t_in[px.p] : t_in[nb(px, parent, W)];
  const uint8_t t = taint_round(px, bits, taint_in, W);
  if (last) {
    const bool remove = (bits & kValidBit) && !t && total <= S;
    out[px.p] = remove ? invalid : disp[px.p];
  } else {
    t_out[px.p] = total;
    taint_out[px.p] = t;
  }
}

}  // namespace

// (P, H, W) float32 disp -> out, R rounds, windows of size <= S removed.
// Workspace: ws32 holds 5 * P*H*W int32 (label x2, arrival round, count x2),
// ws8 4 * P*H*W bytes (masks, parent, taint x2).
SVT_EXPORT int svt_speckle_filter(const void* disp, void* out, void* ws32, void* ws8, int P, int H, int W, int S, int R,
                                  float max_diff, float invalid, void* stream) {
  if (P < 0 || H < 0 || W < 0 || R < 1 || S < 1) return cudaErrorInvalidValue;
  const size_t n = (size_t)P * H * W;
  if (n == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float*>(disp);
  const auto o = static_cast<float*>(out);
  int* lab[2] = {static_cast<int*>(ws32), static_cast<int*>(ws32) + n};
  int* A = lab[1] + n;
  int* s[2] = {A + n, A + 2 * n};
  uint8_t* mask = static_cast<uint8_t*>(ws8);
  uint8_t* pdir = mask + n;
  uint8_t* taint[2] = {pdir + n, pdir + 2 * n};
  const dim3 grid(P * H, (W + kThreads - 1) / kThreads);
  cudaError_t e;
#define SVT_LAUNCH(...)                                         \
  __VA_ARGS__;                                                  \
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  SVT_LAUNCH(speckle_init<<<grid, kThreads, 0, st>>>(d, mask, lab[0], A, H, W, max_diff, invalid))
  int c = 0;
  for (int r = 1; r <= R; ++r, c ^= 1) {
    SVT_LAUNCH(speckle_propagate<<<grid, kThreads, 0, st>>>(mask, lab[c], lab[c ^ 1], A, H, W, r))
  }
  SVT_LAUNCH(speckle_parents<<<grid, kThreads, 0, st>>>(mask, lab[c], A, pdir, s[0], taint[0], H, W))
  c = 0;
  for (int r = 0; r < R; ++r, c ^= 1) {
    SVT_LAUNCH(speckle_up<<<grid, kThreads, 0, st>>>(mask, pdir, s[c], s[c ^ 1], taint[c], taint[c ^ 1], H, W,
                                                       r == R - 1))
  }
  for (int r = 0; r < R; ++r, c ^= 1) {
    SVT_LAUNCH(speckle_down<<<grid, kThreads, 0, st>>>(mask, pdir, s[c], s[c ^ 1], taint[c], taint[c ^ 1], d, o, H,
                                                         W, S, invalid, r == R - 1))
  }
#undef SVT_LAUNCH
  return cudaSuccess;
}
