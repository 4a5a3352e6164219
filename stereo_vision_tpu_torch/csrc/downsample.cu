// Box downsampling of the hierarchical matcher's image pyramid.
//
// Replaces stereo_vision_tpu/stereo/banded_pallas.py:395 _downsample_kernel
// (downsample_box_pack:416, pallas_call at :435), which the JAX hier path
// calls once an image and a level. Each output pixel is the integer sum of
// its fy x fx block, rounded once: round(sum / (fy * fx)) in float32, half to
// even (the reference's float32 division and round; the sum is exact).
// Trailing rows and columns that fill no block are dropped.
//
//   downsample_pyramid_kernel: both images and every level of the pyramid
//     in one launch, where the factors nest (every factor a power of two, and
//     the levels ordered by fy also ordered by fx: every main path's (4, 4)
//     and (2, 2));
//   downsample_box_kernel: one level, a thread an output pixel, both images
//     (or one) a launch: the one-level entry, and the pyramid's levels where
//     they do not nest.
//
// What bounds it on an H100: bytes. At hier4x3 and hier4x8 (32 frames of
// 1280x720, levels (4, 4) and (2, 2)) the work as the JAX kernel splits it,
// four launches that each read a 118 MB image set, moves 546 MB: 0.163 ms at
// 3.35 TB/s. Each image read once and the outputs written once move
// 2 x 118 + 2 x (29.5 + 7.4) = 310 MB: 0.092 ms. At hier16x3 (8 frames, the
// level (4, 4) alone) 63 MB: 0.019 ms.
//
// Design of the pyramid kernel: a thread takes 4 columns (one 16-byte word a
// row) of TY rows, TY the largest fy, and issues all TY loads before it adds
// anything; a warp reads 512 contiguous bytes a row. It holds the finest
// sums (1 x 1 at first) and, level by level from the finest, adds them up in
// place: columns within its word, rows within its TY, then columns across
// the lanes of a warp (shuffles) where fx > 4. Each level is rounded from
// its integer sums and stored (16 or 8 bytes a thread where the row allows),
// so that a coarse sum never comes from rounded finer values.

#include "common.cuh"

namespace {

constexpr int kBoxThreads = 256;
constexpr int kPyrRows = 8;  // row tiles a block: blocks of 32 x 8 threads
constexpr int kMaxLevels = 8;

// One thread per output pixel of (nimg * P, Hc, Wc): image z < P of `a`, the
// rest of `b`.
__global__ void __launch_bounds__(kBoxThreads)
downsample_box_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out, int P, int H,
                      int W, int Hc, int Wc, int fy, int fx, long long npix) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const long long per = (long long)Hc * Wc;
  const int z = (int)(p / per);
  const int rem = (int)(p - z * per);
  const int y = rem / Wc, x = rem - y * Wc;
  const int* img = z < P ? a + (size_t)z * H * W : b + (size_t)(z - P) * H * W;
  const int* src = img + (size_t)y * fy * W + (size_t)x * fx;
  int sum = 0;
  for (int i = 0; i < fy; ++i)
    for (int j = 0; j < fx; ++j) sum += src[(size_t)i * W + j];
  out[p] = static_cast<int>(rintf(__fdiv_rn(static_cast<float>(sum), static_cast<float>(fy * fx))));
}

struct PyrLevel {
  int* out;        // (2P, Hc, Wc): the left frames, then the right
  int Hc, Wc;
  int ly, lx;      // log2 of fy and fx
};

struct PyrArgs {
  const int* left;
  const int* right;
  int P, H, W;
  int nrt;         // row tiles of TY rows an image
  int nlev;
  PyrLevel lev[kMaxLevels];  // finest first: ly and lx never decrease
};

// Rounds sum / 2^(ly + lx): the power of two's reciprocal is exact, so the
// product is the reference's float32 quotient.
__device__ __forceinline__ int box_mean(int sum, int ly, int lx) {
  return static_cast<int>(rintf(__fmul_rn(static_cast<float>(sum), __int_as_float((127 - ly - lx) << 23))));
}

// Image z (the left frames, then the right), row tile ry, columns 4t ..
// 4t + 3: every level's outputs there. The whole warp runs it (shuffles).
template <int TY>
__device__ __forceinline__ void pyramid_tile(const PyrArgs& a, bool vec, int z, int ry, int t) {
  const int* img = z < a.P ? a.left + (size_t)z * a.H * a.W : a.right + (size_t)(z - a.P) * a.H * a.W;
  const int x0 = 4 * t, y0 = TY * ry;

  // Every load first. Pixels past the frame read 0: they fall in blocks
  // that are not stored.
  int s[TY][4];
#pragma unroll
  for (int r = 0; r < TY; ++r) {
    const int* row = img + (size_t)(y0 + r) * a.W + x0;
    if (y0 + r < a.H && vec && x0 + 4 <= a.W) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(row));
      s[r][0] = w.x, s[r][1] = w.y, s[r][2] = w.z, s[r][3] = w.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = y0 + r < a.H && x0 + c < a.W ? __ldg(row + c) : 0;
    }
  }

  // s[r][c] holds the sums of blocks 2^cy x 2^cx (r < TY >> cy, c < 4 >> cx,
  // or c = 0 once cx >= 2: the warp's lanes then hold partial sums).
  int cy = 0, cx = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {  // unrolled: a.lev read at fixed offsets
    if (l >= a.nlev) break;
    const PyrLevel L = a.lev[l];
    for (; cx < L.lx && cx < 2; ++cx) {
#pragma unroll
      for (int r = 0; r < TY; ++r) {
        if (cx == 0) {
          s[r][0] += s[r][1];
          s[r][1] = s[r][2] + s[r][3];
        } else {
          s[r][0] += s[r][1];
        }
      }
    }
    for (; cy < L.ly; ++cy) {
#pragma unroll
      for (int r = 0; r < TY / 2; ++r)
        if (r < (TY >> (cy + 1))) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = s[2 * r][c] + s[2 * r + 1][c];
        }
    }
    for (; cx < L.lx; ++cx) {  // fx > 4: the lanes of an aligned group of fx / 4
#pragma unroll
      for (int r = 0; r < TY; ++r)
        if (r < (TY >> cy)) s[r][0] += __shfl_xor_sync(svt::kFullMask, s[r][0], 1 << (cx - 2));
    }

    // Store: TY >> ly rows of 4 >> lx outputs (or one, from the group's first lane).
    const int ny = TY >> L.ly;
    const int oy0 = ry * ny;
    if (L.lx >= 2 && (t & ((1 << (L.lx - 2)) - 1)) != 0) continue;
    const int ox = L.lx >= 2 ? t >> (L.lx - 2) : x0 >> L.lx;
    int* o = L.out + (size_t)z * L.Hc * L.Wc + ox;
#pragma unroll
    for (int k = 0; k < TY; ++k) {
      if (k >= ny || oy0 + k >= L.Hc) break;
      int* q = o + (size_t)(oy0 + k) * L.Wc;
      if (L.lx == 0 && L.Wc % 4 == 0 && ox + 4 <= L.Wc) {
        *reinterpret_cast<int4*>(q) = make_int4(box_mean(s[k][0], L.ly, 0), box_mean(s[k][1], L.ly, 0),
                                                box_mean(s[k][2], L.ly, 0), box_mean(s[k][3], L.ly, 0));
      } else if (L.lx == 1 && L.Wc % 2 == 0 && ox + 2 <= L.Wc) {
        *reinterpret_cast<int2*>(q) = make_int2(box_mean(s[k][0], L.ly, 1), box_mean(s[k][1], L.ly, 1));
      } else {
        const int n = L.lx >= 2 ? 1 : 4 >> L.lx;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < n && ox + c < L.Wc) q[c] = box_mean(s[k][c], L.ly, L.lx);
      }
    }
  }
}

template <int TY>
__global__ void __launch_bounds__(32 * kPyrRows)
downsample_pyramid_kernel(const PyrArgs a, int vec) {
  const int ry = blockIdx.y * kPyrRows + threadIdx.y;  // one row tile a warp
  if (ry >= a.nrt) return;
  for (int z = blockIdx.z; z < 2 * a.P; z += gridDim.z) pyramid_tile<TY>(a, vec, z, ry, blockIdx.x * 32 + threadIdx.x);
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// (P, H, W) int32 image(s) -> (nimg * P, H / fy, W / fx) int32 box mean: `a`
// alone (b null) or `a` then `b` in one launch.
SVT_EXPORT int svt_downsample_box(const void* a, const void* b, void* out, int P, int H, int W, int fy, int fx,
                                  void* stream) {
  if (fy < 1 || fx < 1 || (long long)fy * fx > (1 << 16) || P < 0 || H < 0 || W < 0) return cudaErrorInvalidValue;
  const long long npix = (long long)(b ? 2 : 1) * P * (H / fy) * (W / fx);
  if (npix == 0) return cudaSuccess;
  const long long blocks = (npix + kBoxThreads - 1) / kBoxThreads;
  downsample_box_kernel<<<(unsigned)blocks, kBoxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), static_cast<int*>(out), P, H, W, H / fy, W / fx, fy,
      fx, npix);
  return cudaGetLastError();
}

// (P, H, W) int32 left and right frames -> level l's (2P, H / fy[l],
// W / fx[l]) int32 box means (left frames first) in outs[l], every level in
// one launch. The levels must nest (banded_cuda.pyramid_nests): powers of
// two, fy at most 16 and fx at most 128, finest first with fy and fx never
// decreasing, at most 8; else cudaErrorInvalidValue.
SVT_EXPORT int svt_downsample_pyramid(const void* left, const void* right, int P, int H, int W, int nlev,
                                      const int* fy, const int* fx, void* const* outs, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || P < 0 || H < 0 || W < 0) return cudaErrorInvalidValue;
  PyrArgs a{static_cast<const int*>(left), static_cast<const int*>(right), P, H, W, 0, nlev, {}};
  int Hn = 0, Wn = 0;  // rows and columns the stored blocks cover
  for (int l = 0; l < nlev; ++l) {
    const int ly = log2_exact(fy[l]), lx = log2_exact(fx[l]);
    if (ly < 0 || lx < 0 || ly > 4 || lx > 7) return cudaErrorInvalidValue;
    if (l > 0 && (ly < a.lev[l - 1].ly || lx < a.lev[l - 1].lx)) return cudaErrorInvalidValue;
    a.lev[l] = PyrLevel{static_cast<int*>(outs[l]), H / fy[l], W / fx[l], ly, lx};
    if (a.lev[l].Hc > 0 && a.lev[l].Wc > 0) {
      Hn = max(Hn, a.lev[l].Hc * fy[l]);
      Wn = max(Wn, a.lev[l].Wc * fx[l]);
    }
  }
  if (P == 0 || Hn == 0) return cudaSuccess;
  const int ly = a.lev[nlev - 1].ly, TY = 1 << ly;
  a.nrt = (Hn + TY - 1) / TY;
  const int vec = W % 4 == 0 && reinterpret_cast<size_t>(left) % 16 == 0 && reinterpret_cast<size_t>(right) % 16 == 0;
  const int words = (Wn + 3) / 4;
  const dim3 grid((words + 31) / 32, (a.nrt + kPyrRows - 1) / kPyrRows, min(2 * P, 65535)),
      block(32, kPyrRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ly) {
    case 0: downsample_pyramid_kernel<1><<<grid, block, 0, st>>>(a, vec); break;
    case 1: downsample_pyramid_kernel<2><<<grid, block, 0, st>>>(a, vec); break;
    case 2: downsample_pyramid_kernel<4><<<grid, block, 0, st>>>(a, vec); break;
    case 3: downsample_pyramid_kernel<8><<<grid, block, 0, st>>>(a, vec); break;
    default: downsample_pyramid_kernel<16><<<grid, block, 0, st>>>(a, vec); break;
  }
  return cudaGetLastError();
}
