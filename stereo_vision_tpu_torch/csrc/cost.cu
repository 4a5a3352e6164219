// Windowed Birchfield-Tomasi cost volume for exact SGBM.
//
// Replaces stereo_vision_tpu/stereo/cost_pallas.py::cost_volume_pallas
// (kernel body _cost_kernel): clipped x-Sobel channel + raw channel, BT
// half-sample extrema of both, pixel cost sobel_BT + (raw_BT >> 2), then a
// block_size x block_size box sum with replicate borders over the FULL
// width, emitted only for columns x >= x_off. Output (B, H, W - x_off, D)
// int16, or int32 where the window's bound or the SGM scans need it (one
// template, both storage types). A disparity index d reads the right column
// x - max(d + mindisp, 0): the reference clamps a negative shift to 0.
//
// What bounds it on an H100: the int16 output, B*H*(W-x_off)*D*2 bytes
// (212 MB a 720p frame at D=128, about 63 us at 3.35 TB/s); the inputs are
// two int32 images. The TPU kernel shifted whole rows through VMEM with
// log2(D) masked sublane shifts because Mosaic has no gather; here a right
// sample x-d is a direct shared-memory index.
//
// Design (simple first): one block per (frame, output row, tile of TX
// output columns), all D disparities. For each of the block_size source
// rows the block stages the left row's values + half-extrema (TX + 2r
// columns) and the right row's values + half-extrema (the TX + 2r + D - 1
// columns the tile's disparities reach) in shared memory, then adds every
// (column, d) pixel cost into a shared column-sum V; the box's horizontal
// pass then sums block_size neighbours of V. Every value is int32. Each
// pixel cost is recomputed by the block_size output rows that need it
// (a rolling row window per block is the obvious next step).

#include "common.cuh"

namespace {

using svt::bt;
using svt::clampi;
using svt::extrema;
using svt::xsobel;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const int* __restrict__ left, const int* __restrict__ right, T* __restrict__ out,
            int H, int W, int D, int mindisp, int bs, int ftzero, int x_off, int TX) {
  extern __shared__ int smem[];
  const int r = bs / 2;
  const int NC = TX + 2 * r;      // V columns: full-frame x0 - r .. x0 + TX - 1 + r (clamped)
  const int NRmax = TX + 2 * r + D;
  int* sL = smem;                 // [6][NC]: sobel v/u0/u1, raw v/u0/u1
  int* sR = sL + 6 * NC;          // [6][NRmax]
  int* V = sR + 6 * NRmax;        // [NC][D] column sums over the window rows

  const int b = blockIdx.z, y = blockIdx.y;
  const int x0 = x_off + blockIdx.x * TX;
  const int Wo = W - x_off;
  const int cmin = clampi(x0 - r, 0, W - 1);
  const int cmax = clampi(x0 + TX - 1 + r, 0, W - 1);
  const int qlo = cmin - mindisp - (D - 1);  // lowest right column (may be < 0)
  const int NR = cmax - cmin + D;            // covers c - max(d + mindisp, 0) for every mindisp
  const int* L = left + (size_t)b * H * W;
  const int* R = right + (size_t)b * H * W;

  for (int i = threadIdx.x; i < NC * D; i += blockDim.x) V[i] = 0;

  for (int k = 0; k < bs; ++k) {
    const int yy = clampi(y + k - r, 0, H - 1);
    __syncthreads();  // the previous row's staging is consumed
    for (int j = threadIdx.x; j < NC; j += blockDim.x) {
      const int c = clampi(x0 - r + j, 0, W - 1);
      const int cm = max(c - 1, 0), cp = min(c + 1, W - 1);
      extrema(xsobel(L, H, W, yy, c, ftzero), xsobel(L, H, W, yy, cm, ftzero),
              xsobel(L, H, W, yy, cp, ftzero), sL + j, NC);
      const int* row = L + yy * W;
      extrema(row[c], row[cm], row[cp], sL + 3 * NC + j, NC);
    }
    // Right samples left of column 0 replicate column 0 (the reference pads
    // the row by edge replication before taking the half-extrema).
    for (int i = threadIdx.x; i < NR; i += blockDim.x) {
      const int q = qlo + i;
      const int qc = clampi(q, 0, W - 1), qm = clampi(q - 1, 0, W - 1), qp = clampi(q + 1, 0, W - 1);
      extrema(xsobel(R, H, W, yy, qc, ftzero), xsobel(R, H, W, yy, qm, ftzero),
              xsobel(R, H, W, yy, qp, ftzero), sR + i, NRmax);
      const int* row = R + yy * W;
      extrema(row[qc], row[qm], row[qp], sR + 3 * NRmax + i, NRmax);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < NC * D; idx += blockDim.x) {
      const int j = idx / D, d = idx - j * D;
      const int c = clampi(x0 - r + j, 0, W - 1);
      const int i = (c - cmin) + mindisp + (D - 1) - max(d + mindisp, 0);  // right column c - max(d + mindisp, 0)
      const int cs = bt(sL[j], sL[NC + j], sL[2 * NC + j], sR[i], sR[NRmax + i], sR[2 * NRmax + i]);
      const int cr = bt(sL[3 * NC + j], sL[4 * NC + j], sL[5 * NC + j],
                        sR[3 * NRmax + i], sR[4 * NRmax + i], sR[5 * NRmax + i]);
      V[idx] += cs + (cr >> 2);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TX * D; idx += blockDim.x) {
    const int t = idx / D, d = idx - t * D;
    const int x = x0 + t;
    if (x >= W) continue;
    int s = 0;
    for (int k = 0; k < bs; ++k) s += V[(t + k) * D + d];
    out[(((size_t)b * H + y) * Wo + (x - x_off)) * D + d] = static_cast<T>(s);
  }
}

// Output columns a block: 32 to D = 128, 16 to 256, 8 above (up to 1024,
// where the column sums of 8 + 2r columns take 1024 values each: 57.7 KB at
// block 5).
int tile_for(int D) { return D <= 128 ? 32 : D <= 256 ? 16 : 8; }

size_t smem_bytes(int D, int bs) {
  const int TX = tile_for(D), r = bs / 2;
  const int NC = TX + 2 * r, NRmax = TX + 2 * r + D;
  return (size_t)(6 * NC + 6 * NRmax + NC * D) * sizeof(int);
}

template <typename T>
cudaError_t launch(const int* left, const int* right, T* out, int B, int H, int W, int D, int mindisp, int bs,
                   int ftzero, int x_off, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, bs);
  cudaError_t e = cudaFuncSetAttribute(cost_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int TX = tile_for(D);
  const dim3 grid((W - x_off + TX - 1) / TX, H, B);
  cost_kernel<T><<<grid, kThreads, smem, stream>>>(left, right, out, H, W, D, mindisp, bs, ftzero, x_off, TX);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block of the cost kernel takes at D, bs.
SVT_EXPORT long long svt_cost_volume_smem(int D, int bs) { return (long long)smem_bytes(D, bs); }

// (B, H, W) int32 left/right -> (B, H, W - x_off, D) windowed cost, int16
// (out_bytes 2) or int32 (out_bytes 4). mindisp + D >= 1, D <= 1024.
SVT_EXPORT int svt_cost_volume(const void* left, const void* right, void* out, int B, int H, int W, int D,
                               int mindisp, int bs, int ftzero, int x_off, int out_bytes, void* stream) {
  if (bs < 1 || bs % 2 == 0 || mindisp + D < 1 || D > svt::kMaxRange) return cudaErrorInvalidValue;
  const auto l = static_cast<const int*>(left), r = static_cast<const int*>(right);
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2)
    return launch(l, r, static_cast<int16_t*>(out), B, H, W, D, mindisp, bs, ftzero, x_off, st);
  if (out_bytes == 4) return launch(l, r, static_cast<int*>(out), B, H, W, D, mindisp, bs, ftzero, x_off, st);
  return cudaErrorInvalidValue;
}
