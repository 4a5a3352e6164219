// Band-limited SGBM core of the hierarchical matcher (matcher="sgbm_hier").
//
// Replaces the kernel bodies of stereo_vision_tpu/stereo/banded_pallas.py
// that banded_stats_pack chains:
//   _pix_kernel + _aligned_box_kernel(_srows) -> banded_cost_kernel
//   _vert_kernel (without diagonals)          -> banded_vertical_kernel
//   _vert_kernel (with diagonals, 8 paths)    -> banded_vertical_diag_kernel
//   _horiz_kernel                             -> banded_horizontal_kernel
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
// Layout: banded volumes (P, H, Wv, K) int16, frames on the grid. The TPU
// kernels' 128-lane frame packing, float32-for-int and tile-entry delta
// rows are not carried over.
//
// What bounds them on an H100 (hier4x3 full-res level, 32 frames of
// 1280x720, K=4, 1152 valid columns; one int16 volume = 212 MB): the cost
// kernel writes one volume (~63 us at 3.35 TB/s); vertical reads one and
// writes two (~190 us); each horizontal reads one and writes one
// (~127 us); the WTA reads three and writes four int32 maps and a bool map
// (~318 us). The scans are also dependent chains of H (or Wv) steps. The
// 8-path vertical (hier4x8) reads one volume and writes two, as vertical
// does, with three carry sets per direction. The fused WTA (hier16x3 full
// level: 8 frames, K=16, three 212 MB volumes and a 26.5 MB shift map in,
// two 26.5 MB int32 maps out) is bytes-bound at ~0.21 ms; its operations
// take under 0.02 ms at 67 T/s.
//
// Design (right and simple first):
//   cost: one block per (frame, output row, tile of TX columns). The block
//     stages the shift map of its bs x (TX + bs - 1) window, then, one
//     source row at a time, the left row's and the needed right columns'
//     values and BT half-extrema (both channels), and forms every per-pixel
//     banded cost of the window in shared memory (each neighbour at its OWN
//     band s(q) + j, a direct indexed load). The aligned row pass and then
//     the aligned column pass (centre = the row-pass sum) run from shared
//     memory. Rows and columns clamp at the image edge, for cost and s.
//   vertical: one thread per (frame, column, direction) walks the rows with
//     its K carries in registers (no diagonals: the down and up scans are
//     independent per column), prefetching the next row.
//   vertical with diagonals: a diagonal carry moves one column per row, so
//     one block per (frame, direction) walks the rows; each thread owns CPT
//     columns (CPT = ceil(Wv / 1024)), keeps their vertical carries in
//     registers, prefetches the next row's cost, and exchanges the two
//     diagonal carry sets with its neighbours through a ping-pong pair of
//     rows (one __syncthreads per row) in shared memory, or in an
//     L2-resident device scratch where 8 * Wv * K bytes exceed it. One
//     launch replaces the per-row launches a row-parallel design would take
//     (the exact path's vertical takes 720).
//   horizontal: one thread per (frame, row) walks the columns with its K
//     carries in registers; tiles of columns are staged through shared
//     memory so that the loads and stores of a block are coalesced.
//   wta: one thread per pixel sums the 2-4 volumes in int32 and reduces
//     over the K lanes. The fused form shares that reduction and the
//     subpixel step, reads the pixel's shift and writes the LR check's pack
//     (minS * 2048 + best + s) and d16 + 32768 * unique_ok; the TPU kernel's
//     8-rows-a-step (W, 128) lane layout and its group-sum matmuls have no
//     counterpart here.
//   downsample: one thread per output pixel; the TPU kernel's 0/1 pooling
//     matmul becomes an integer sum, the float32 division and the
//     half-to-even round stay.
// Lane shifts by a runtime delta use a barrel shifter over compile-time
// offsets (log2 K stages), so the carries stay in registers.

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using svt::bt;
using svt::clampi;
using svt::extrema;
using svt::xsobel;

constexpr int kBig = 1 << 29;  // out-of-band carry lane
constexpr int kCostThreads = 256;
constexpr int kScanThreads = 128;
constexpr int kRowsPerBlock = 64;  // horizontal: rows (threads) per block

// ------------------------------------------------------------------ cost

// align_window for one lane: a neighbour's value re-indexed into the centre
// pixel's band, or the centre's own value where there is no source.
__device__ __forceinline__ int window_lane(const int* a, int delta, const int* ctr, int lane, int G, int K) {
  if (delta > G || delta < -G) return ctr[lane];
  if (delta == G) return lane + G < K ? a[lane + G] : ctr[lane];
  if (delta == -G) return lane - G >= 0 ? a[lane - G] : ctr[lane];
  return a[lane];
}

__global__ void __launch_bounds__(kCostThreads)
banded_cost_kernel(const int* __restrict__ left, const int* __restrict__ right, const int* __restrict__ shift,
                   int16_t* __restrict__ out, int H, int W, int K, int G, int ndisp, int bs, int ftzero,
                   int min_x, int stride, int TX, int NRcap) {
  extern __shared__ int smem[];
  __shared__ int dlo, dhi;
  const int r = bs / 2, NC = TX + 2 * r;
  int* sS = smem;               // [bs][NC] shift at (clamped row, clamped column)
  int* sL = sS + bs * NC;       // [6][NC] left: sobel v/u0/u1, raw v/u0/u1
  int* sR = sL + 6 * NC;        // [6][NRcap] right, the same channels
  int* pix = sR + 6 * NRcap;    // [bs][NC][K] per-pixel banded cost
  int* acc = pix + bs * NC * K; // [NC][K] aligned row-pass sums

  const int b = blockIdx.z, y = blockIdx.y;
  const int x0 = min_x + blockIdx.x * TX;
  const int Wo = W - min_x;
  const int* L = left + (size_t)b * H * W;
  const int* R = right + (size_t)b * H * W;
  const int* S = shift + (size_t)b * H * W;

  if (threadIdx.x == 0) {
    dlo = INT_MAX;
    dhi = INT_MIN;
  }
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < bs * NC; i += blockDim.x) {
    const int k = i / NC, j = i - k * NC;
    const int sv = S[clampi(y + k - r, 0, H - 1) * W + clampi(x0 - r + j, 0, W - 1)];
    sS[i] = sv;
    lo = min(lo, clampi(sv, 0, ndisp - 1));
    hi = max(hi, clampi(sv + stride * (K - 1), 0, ndisp - 1));
  }
  if (lo <= hi) {
    atomicMin(&dlo, lo);
    atomicMax(&dhi, hi);
  }
  __syncthreads();
  // Right columns c - d for c in [cmin, cmax], d in [dlo, dhi]: NR <= NC + ndisp - 1.
  const int cmin = clampi(x0 - r, 0, W - 1), cmax = clampi(x0 + TX - 1 + r, 0, W - 1);
  const int qlo = cmin - dhi;
  const int NR = cmax - dlo - qlo + 1;

  for (int k = 0; k < bs; ++k) {
    const int yy = clampi(y + k - r, 0, H - 1);
    if (k > 0) __syncthreads();  // the previous row's staging is consumed
    for (int j = threadIdx.x; j < NC; j += blockDim.x) {
      const int c = clampi(x0 - r + j, 0, W - 1);
      const int cm = max(c - 1, 0), cp = min(c + 1, W - 1);
      extrema(xsobel(L, H, W, yy, c, ftzero), xsobel(L, H, W, yy, cm, ftzero), xsobel(L, H, W, yy, cp, ftzero),
              sL + j, NC);
      const int* row = L + yy * W;
      extrema(row[c], row[cm], row[cp], sL + 3 * NC + j, NC);
    }
    // Right samples left of column 0 replicate column 0 (the reference pads
    // the row by edge replication before taking the half-extrema).
    for (int i = threadIdx.x; i < NR; i += blockDim.x) {
      const int q = qlo + i;
      const int qc = clampi(q, 0, W - 1), qm = clampi(q - 1, 0, W - 1), qp = clampi(q + 1, 0, W - 1);
      extrema(xsobel(R, H, W, yy, qc, ftzero), xsobel(R, H, W, yy, qm, ftzero), xsobel(R, H, W, yy, qp, ftzero),
              sR + i, NRcap);
      const int* row = R + yy * W;
      extrema(row[qc], row[qm], row[qp], sR + 3 * NRcap + i, NRcap);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < NC * K; idx += blockDim.x) {
      const int j = idx / K, lane = idx - j * K;
      const int c = clampi(x0 - r + j, 0, W - 1);
      const int d = clampi(sS[k * NC + j] + stride * lane, 0, ndisp - 1);
      const int i = c - d - qlo;
      const int cs = bt(sL[j], sL[NC + j], sL[2 * NC + j], sR[i], sR[NRcap + i], sR[2 * NRcap + i]);
      const int cr = bt(sL[3 * NC + j], sL[4 * NC + j], sL[5 * NC + j], sR[3 * NRcap + i], sR[4 * NRcap + i],
                        sR[5 * NRcap + i]);
      pix[(k * NC + j) * K + lane] = cs + (cr >> 2);
    }
  }
  __syncthreads();
  // Row pass: acc(y, c) = sum over window rows of the aligned pixel costs;
  // the centre is the pixel's own cost.
  for (int idx = threadIdx.x; idx < NC * K; idx += blockDim.x) {
    const int j = idx / K, lane = idx - j * K;
    const int* ctr = pix + (r * NC + j) * K;
    const int sc = sS[r * NC + j];
    int sum = 0;
    for (int k = 0; k < bs; ++k) sum += window_lane(pix + (k * NC + j) * K, sc - sS[k * NC + j], ctr, lane, G, K);
    acc[idx] = sum;
  }
  __syncthreads();
  // Column pass over the row-pass sums; the centre is the row-pass sum at p.
  for (int idx = threadIdx.x; idx < TX * K; idx += blockDim.x) {
    const int t = idx / K, lane = idx - t * K;
    const int x = x0 + t;
    if (x >= W) continue;
    const int* ctr = acc + (t + r) * K;
    const int sc = sS[r * NC + t + r];
    int sum = 0;
    for (int dx = 0; dx < bs; ++dx) sum += window_lane(acc + (t + dx) * K, sc - sS[r * NC + t + dx], ctr, lane, G, K);
    out[(((size_t)b * H + y) * Wo + (x - min_x)) * K + lane] = static_cast<int16_t>(sum);
  }
}

// ----------------------------------------------------------------- scans

// K int16 lanes as raw 8- or 16-byte words: a load kept in flight while
// other work runs, unpacked to int32 lanes where it is used.
template <int K>
struct RawLanes {
  static_assert(K == 4 || K % 8 == 0, "K is 4 or a multiple of 8");
  static constexpr int kPer = K == 4 ? 4 : 8;  // lanes per word
  using Word = typename std::conditional<K == 4, int2, int4>::type;
  Word w[K / kPer];

  __device__ __forceinline__ void load(const int16_t* p) {
#pragma unroll
    for (int i = 0; i < K / kPer; ++i) w[i] = reinterpret_cast<const Word*>(p)[i];
  }
  __device__ __forceinline__ void unpack(int (&v)[K]) const {
#pragma unroll
    for (int i = 0; i < K / kPer; ++i) {
      const int16_t* h = reinterpret_cast<const int16_t*>(&w[i]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[kPer * i + k] = h[k];
    }
  }
};

// No __restrict__ on the pointers of these two: the diagonal scan reads
// carries that other threads of its block wrote.
template <int K>
__device__ __forceinline__ void load_lanes(const int16_t* p, int (&v)[K]) {
  RawLanes<K> r;
  r.load(p);
  r.unpack(v);
}

template <int K>
__device__ __forceinline__ void store_lanes(int16_t* p, const int (&v)[K]) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int i = 0; i < K / 8; ++i) {
      alignas(16) int16_t h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = static_cast<int16_t>(v[8 * i + k]);
      reinterpret_cast<int4*>(p)[i] = *reinterpret_cast<const int4*>(h);
    }
  } else {
    alignas(8) int16_t h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = static_cast<int16_t>(v[k]);
    *reinterpret_cast<int2*>(p) = *reinterpret_cast<const int2*>(h);
  }
}

template <int K>
__host__ __device__ constexpr int log2_of() {
  int n = 0;
  while ((1 << n) < K) ++n;
  return n;
}

// a[k] <- a[k + sh], kBig where k + sh is outside [0, K): a barrel shifter
// over the bits of |sh|, each stage a shift by a compile-time offset.
template <int K>
__device__ __forceinline__ void shift_lanes(int (&a)[K], int sh) {
  if (sh >= K || sh <= -K) {
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = kBig;
    return;
  }
  constexpr int kBits = log2_of<K>();
  if (sh > 0) {
#pragma unroll
    for (int i = 0; i < kBits; ++i) {
      const int bit = 1 << i;
      if (sh & bit) {
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = k + bit < K ? a[k + bit] : kBig;
      }
    }
  } else if (sh < 0) {
    const int m = -sh;
#pragma unroll
    for (int i = 0; i < kBits; ++i) {
      const int bit = 1 << i;
      if (m & bit) {
#pragma unroll
        for (int k = K - 1; k >= 0; --k) a[k] = k - bit >= 0 ? a[k - bit] : kBig;
      }
    }
  }
}

// align_band (fill kBig; kDiag: align_band(diag=True), which also shifts
// by +-2G when 2G < K) then _update_banded, in place on the carry L.
template <int K, bool kDiag = false>
__device__ __forceinline__ void banded_step(const int (&c)[K], int (&L)[K], int delta, int G, int P1, int P2) {
  const bool two = kDiag && 2 * G < K;
  const int reach = two ? 2 * G : G;
  if (delta > reach || delta < -reach) {
#pragma unroll
    for (int k = 0; k < K; ++k) L[k] = c[k];  // no lane in band: the border rule
    return;
  }
  if (delta == G) {
    shift_lanes<K>(L, G);
  } else if (delta == -G) {
    shift_lanes<K>(L, -G);
  } else if (two && delta == 2 * G) {
    shift_lanes<K>(L, 2 * G);
  } else if (two && delta == -2 * G) {
    shift_lanes<K>(L, -2 * G);
  }
  int m = L[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, L[k]);
  if (m >= kBig) {
#pragma unroll
    for (int k = 0; k < K; ++k) L[k] = c[k];
    return;
  }
  int prev = kBig;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int cur = L[k];
    const int nxt = k + 1 < K ? L[k + 1] : kBig;
    const int cand = min(min(cur, m + P2), min(prev, nxt) + P1);
    L[k] = c[k] + cand - m;
    prev = cur;
  }
}

// One thread per (frame, column, direction): blockIdx.z = 0 scans down,
// 1 scans up; the delta is s(y) - s(previous row visited).
template <int K>
__global__ void __launch_bounds__(kScanThreads)
banded_vertical_kernel(const int16_t* __restrict__ C, const int* __restrict__ shift, int16_t* __restrict__ out_dn,
                       int16_t* __restrict__ out_up, int H, int Wv, int G, int P1, int P2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Wv) return;
  const int b = blockIdx.y, up = blockIdx.z;
  const int16_t* Cb = C + (size_t)b * H * Wv * K;
  int16_t* Ob = (up ? out_up : out_dn) + (size_t)b * H * Wv * K;
  const int* Sb = shift + (size_t)b * H * Wv;
  const int step = up ? -1 : 1;
  int y = up ? H - 1 : 0;
  int L[K], c[K], cn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = 0;
  load_lanes<K>(Cb + ((size_t)y * Wv + x) * K, cn);
  int sn = Sb[(size_t)y * Wv + x], sprev = sn;
  for (int t = 0; t < H; ++t, y += step) {
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = cn[k];
    const int sy = sn;
    if (t + 1 < H) {
      load_lanes<K>(Cb + ((size_t)(y + step) * Wv + x) * K, cn);
      sn = Sb[(size_t)(y + step) * Wv + x];
    }
    banded_step<K>(c, L, sy - sprev, G, P1, P2);
    store_lanes<K>(Ob + ((size_t)y * Wv + x) * K, L);
    sprev = sy;
  }
}

constexpr int kDiagMaxThreads = 1024;

// One block per (frame, direction): blockIdx.y = 0 scans down, 1 up (the
// y-flipped volume with the same column shifts). Thread t owns the columns
// x = t + j * blockDim.x, j < CPT. Per row, each column updates its vertical
// carry (predecessor (y', x)), its (1,1) diagonal carry (predecessor
// (y', x - 1)) and its (-1,1) one (predecessor (y', x + 1)), y' the row
// visited before, and stores their sum. Carry buffer: [2 rows][2 sets][Wv][K]
// int16 (a carry is at most cost_bound + P2), in shared memory, or at
// scratch + (frame * 2 + direction) * 4 * Wv * K when scratch is given.
template <int K, int CPT>
__global__ void __launch_bounds__(kDiagMaxThreads)
banded_vertical_diag_kernel(const int16_t* __restrict__ C, const int* __restrict__ shift,
                            int16_t* __restrict__ out_dn, int16_t* __restrict__ out_up, int16_t* scratch, int H,
                            int Wv, int G, int P1, int P2) {
  extern __shared__ __align__(16) int16_t carry_smem[];
  const int b = blockIdx.x, up = blockIdx.y;
  const size_t plane = (size_t)Wv * K;
  int16_t* carry = scratch ? scratch + ((size_t)b * 2 + up) * 4 * plane : carry_smem;
  const int16_t* Cb = C + (size_t)b * H * plane;
  int16_t* Ob = (up ? out_up : out_dn) + (size_t)b * H * plane;
  const int* Sb = shift + (size_t)b * H * Wv;
  const int step = up ? -1 : 1;
  int y = up ? H - 1 : 0;

  int Lv[CPT][K], sprev[CPT];
  RawLanes<K> nxt[CPT];
  int snxt[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int x = threadIdx.x + j * blockDim.x;
    if (x < Wv) {
      nxt[j].load(Cb + ((size_t)y * Wv + x) * K);
      snxt[j] = Sb[(size_t)y * Wv + x];
    }
  }
  for (int t = 0; t < H; ++t, y += step) {
    RawLanes<K> cur[CPT];
    int scur[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      cur[j] = nxt[j];
      scur[j] = snxt[j];
    }
    if (t + 1 < H) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int x = threadIdx.x + j * blockDim.x;
        if (x < Wv) {
          nxt[j].load(Cb + ((size_t)(y + step) * Wv + x) * K);
          snxt[j] = Sb[(size_t)(y + step) * Wv + x];
        }
      }
    }
    const int16_t* rd = carry + (size_t)(t & 1) * 2 * plane;  // the previous row's diagonal carries
    int16_t* wr = carry + (size_t)((t + 1) & 1) * 2 * plane;
    const int* sp = Sb + (size_t)(y - step) * Wv;  // the previous row's shifts (t > 0)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int x = threadIdx.x + j * blockDim.x;
      if (x >= Wv) continue;
      int c[K], Ld[K], Lu[K];
      cur[j].unpack(c);
      const int sy = scur[j];
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) Lv[j][k] = Ld[k] = Lu[k] = c[k];
      } else {
        banded_step<K>(c, Lv[j], sy - sprev[j], G, P1, P2);
        if (x > 0) {
          load_lanes<K>(rd + (size_t)(x - 1) * K, Ld);
          banded_step<K, true>(c, Ld, sy - sp[x - 1], G, P1, P2);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) Ld[k] = c[k];  // a zero carry from outside the frame
        }
        if (x + 1 < Wv) {
          load_lanes<K>(rd + plane + (size_t)(x + 1) * K, Lu);
          banded_step<K, true>(c, Lu, sy - sp[x + 1], G, P1, P2);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) Lu[k] = c[k];
        }
      }
      sprev[j] = sy;
      store_lanes<K>(wr + (size_t)x * K, Ld);
      store_lanes<K>(wr + plane + (size_t)x * K, Lu);
#pragma unroll
      for (int k = 0; k < K; ++k) Ld[k] += Lv[j][k] + Lu[k];
      store_lanes<K>(Ob + ((size_t)y * Wv + x) * K, Ld);
    }
    __syncthreads();
  }
}

// One thread per (frame, row): the L->R (reverse: R->L) scan. Tiles of T
// columns of the block's rows are staged through shared memory.
template <int K>
__global__ void __launch_bounds__(kRowsPerBlock)
banded_horizontal_kernel(const int16_t* __restrict__ C, const int* __restrict__ shift, int16_t* __restrict__ out,
                         int rows, int Wv, int G, int P1, int P2, int reverse) {
  constexpr int T = K >= 128 ? 1 : 128 / K;  // columns per tile
  constexpr int PITCH = T * K + 2;           // int16 per staged row: an odd word pitch
  __shared__ int16_t tile[kRowsPerBlock * PITCH];
  __shared__ int stile[kRowsPerBlock * (T + 1)];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, rows - row0);
  const int me = threadIdx.x;
  const int ntiles = (Wv + T - 1) / T;
  int L[K], c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = 0;
  int sprev = 0;
  for (int ti = 0; ti < ntiles; ++ti) {
    const int xs = (reverse ? ntiles - 1 - ti : ti) * T;
    const int nx = min(T, Wv - xs), per = nx * K;
    __syncthreads();  // the previous tile is written out
    for (int i = threadIdx.x; i < nrows * per; i += blockDim.x) {
      const int rr = i / per, e = i - rr * per;
      tile[rr * PITCH + e] = C[((size_t)(row0 + rr) * Wv + xs) * K + e];
    }
    for (int i = threadIdx.x; i < nrows * nx; i += blockDim.x) {
      const int rr = i / nx, e = i - rr * nx;
      stile[rr * (T + 1) + e] = shift[(size_t)(row0 + rr) * Wv + xs + e];
    }
    __syncthreads();
    if (me < nrows) {
      for (int j = 0; j < nx; ++j) {
        const int e = reverse ? nx - 1 - j : j;
        int16_t* cell = tile + me * PITCH + e * K;
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = cell[k];
        const int sx = stile[me * (T + 1) + e];
        banded_step<K>(c, L, ti == 0 && j == 0 ? 0 : sx - sprev, G, P1, P2);
#pragma unroll
        for (int k = 0; k < K; ++k) cell[k] = static_cast<int16_t>(L[k]);
        sprev = sx;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * per; i += blockDim.x) {
      const int rr = i / per, e = i - rr * per;
      out[((size_t)(row0 + rr) * Wv + xs) * K + e] = tile[rr * PITCH + e];
    }
  }
}

// S = the int32 sum of the nvol (2-4) volumes' K lanes at pixel p.
template <int K>
__device__ __forceinline__ void sum_volumes(const int16_t* const (&vols)[4], int nvol, int p, int (&S)[K]) {
  int t[K];
  load_lanes<K>(vols[0] + (size_t)p * K, S);
  for (int j = 1; j < nvol; ++j) {
    load_lanes<K>(vols[j] + (size_t)p * K, t);
#pragma unroll
    for (int k = 0; k < K; ++k) S[k] += t[k];
  }
}

struct WtaStats {
  int mn, bst;  // min and argmin over the lanes (ties -> smallest k)
  int a, z, c;  // the samples at d0 - 1, d0, d0 + 1, d0 = clip(best, 1, K - 2)
  bool ok;      // band-local uniqueness
};

template <int K>
__device__ __forceinline__ WtaStats wta_reduce(const int (&S)[K], int uniq) {
  WtaStats w{S[0], 0, 0, 0, 0, true};
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (S[k] < w.mn) {
      w.mn = S[k];
      w.bst = k;
    }
  if (uniq > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) w.ok &= !(abs(k - w.bst) > 1 && w.mn * (100 + uniq) > S[k] * 100);
  }
  const int d0 = min(max(w.bst, 1), K - 2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w.a = k == d0 - 1 ? S[k] : w.a;
    w.z = k == d0 ? S[k] : w.z;
    w.c = k == d0 + 1 ? S[k] : w.c;
  }
  return w;
}

// The subpixel parabola in lane units x16; the edges keep 16 * best.
template <int K>
__device__ __forceinline__ int subpixel16(const WtaStats& w) {
  const int denom2 = max(w.a + w.c - 2 * w.z, 1);
  const int q = ((w.a - w.c) * 16 + denom2) / (2 * denom2);  // C division truncates, as the reference
  return w.bst > 0 && w.bst < K - 1 ? w.bst * 16 + q : w.bst * 16;
}

// One thread per pixel: minS, best, the uniqueness verdict, and either the
// samples a, z, c or, with sub, the subpixel parabola.
template <int K>
__global__ void __launch_bounds__(kScanThreads)
banded_wta_kernel(const int16_t* __restrict__ v0, const int16_t* __restrict__ v1, const int16_t* __restrict__ v2,
                  const int16_t* __restrict__ v3, int nvol, int npix, int uniq, int sub, int* __restrict__ minS,
                  int* __restrict__ best, int* __restrict__ m2, int* __restrict__ m3, int* __restrict__ m4,
                  uint8_t* __restrict__ uok) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int16_t* const vols[4] = {v0, v1, v2, v3};
  int S[K];
  sum_volumes<K>(vols, nvol, p, S);
  const WtaStats w = wta_reduce<K>(S, uniq);
  minS[p] = w.mn;
  best[p] = w.bst;
  uok[p] = w.ok ? 1 : 0;
  if (sub) {
    m2[p] = subpixel16<K>(w);
  } else {
    m2[p] = w.a;
    m3[p] = w.z;
    m4[p] = w.c;
  }
}

// The fused form: one thread per pixel writes the LR check's
// pack = minS * 2048 + (best + s) and du = (sub16 + 16 * s) + 32768 * unique_ok,
// s the pixel's shift, in [0, ndisp - K] with 16 * ndisp < 32768 (the
// wrapper checks ndisp), so that best + s fits the pack's 11 bits and d16
// stays below the uniqueness bit; minS < 4 * 2^15 keeps the pack in int32.
template <int K>
__global__ void __launch_bounds__(kScanThreads)
banded_wta_fused_kernel(const int16_t* __restrict__ v0, const int16_t* __restrict__ v1,
                        const int16_t* __restrict__ v2, const int16_t* __restrict__ v3, int nvol, int npix, int uniq,
                        const int* __restrict__ shift, int* __restrict__ pack, int* __restrict__ du) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int16_t* const vols[4] = {v0, v1, v2, v3};
  int S[K];
  sum_volumes<K>(vols, nvol, p, S);
  const WtaStats w = wta_reduce<K>(S, uniq);
  const int s = shift[p];
  pack[p] = w.mn * 2048 + w.bst + s;
  du[p] = subpixel16<K>(w) + 16 * s + (w.ok ? 32768 : 0);
}

template <int K>
cudaError_t scans(int which, const int16_t* C, const int* s, int16_t* o0, int16_t* o1, int P, int H, int Wv,
                  int G, int P1, int P2, int reverse, cudaStream_t st) {
  if (which == 0) {
    const dim3 grid((Wv + kScanThreads - 1) / kScanThreads, P, 2);
    banded_vertical_kernel<K><<<grid, kScanThreads, 0, st>>>(C, s, o0, o1, H, Wv, G, P1, P2);
  } else {
    const int rows = P * H;
    banded_horizontal_kernel<K><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kRowsPerBlock, 0, st>>>(
        C, s, o0, rows, Wv, G, P1, P2, reverse);
  }
  return cudaGetLastError();
}

cudaError_t scans_for(int K, int which, const int16_t* C, const int* s, int16_t* o0, int16_t* o1, int P, int H,
                      int Wv, int G, int P1, int P2, int reverse, cudaStream_t st) {
  switch (K) {
    case 4: return scans<4>(which, C, s, o0, o1, P, H, Wv, G, P1, P2, reverse, st);
    case 8: return scans<8>(which, C, s, o0, o1, P, H, Wv, G, P1, P2, reverse, st);
    case 16: return scans<16>(which, C, s, o0, o1, P, H, Wv, G, P1, P2, reverse, st);
    case 32: return scans<32>(which, C, s, o0, o1, P, H, Wv, G, P1, P2, reverse, st);
    case 64: return scans<64>(which, C, s, o0, o1, P, H, Wv, G, P1, P2, reverse, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int K, int CPT>
cudaError_t diag_launch(const int16_t* C, const int* s, int16_t* dn, int16_t* up, int16_t* scratch, int P, int H,
                        int Wv, int G, int P1, int P2, cudaStream_t st) {
  const int threads = ((Wv + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t smem = scratch ? 0 : (size_t)8 * Wv * K;
  cudaError_t e = cudaFuncSetAttribute(banded_vertical_diag_kernel<K, CPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  banded_vertical_diag_kernel<K, CPT><<<dim3(P, 2), threads, smem, st>>>(C, s, dn, up, scratch, H, Wv, G, P1, P2);
  return cudaGetLastError();
}

template <int K>
cudaError_t diag_for_cpt(const int16_t* C, const int* s, int16_t* dn, int16_t* up, int16_t* scratch, int P, int H,
                         int Wv, int G, int P1, int P2, cudaStream_t st) {
  const int cpt = (Wv + kDiagMaxThreads - 1) / kDiagMaxThreads;
  switch (cpt) {
    case 1: return diag_launch<K, 1>(C, s, dn, up, scratch, P, H, Wv, G, P1, P2, st);
    case 2: return diag_launch<K, 2>(C, s, dn, up, scratch, P, H, Wv, G, P1, P2, st);
    case 3:
    case 4: return diag_launch<K, 4>(C, s, dn, up, scratch, P, H, Wv, G, P1, P2, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t wta(const int16_t* const* v, int nvol, int npix, int uniq, int sub, int* const* maps, uint8_t* uok,
                cudaStream_t st) {
  banded_wta_kernel<K><<<(npix + kScanThreads - 1) / kScanThreads, kScanThreads, 0, st>>>(
      v[0], v[1], v[2], v[3], nvol, npix, uniq, sub, maps[0], maps[1], maps[2], maps[3], maps[4], uok);
  return cudaGetLastError();
}

// ------------------------------------------------------------- downsample

// One thread per output pixel of (P, H / fy, W / fx): the integer sum of its
// fy x fx block, then round(sum / (fy * fx)) in float32, half to even (the
// reference's float32 division and round; the sum is exact).
__global__ void __launch_bounds__(kCostThreads)
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

// (P, H, W) int32 left/right + (P, H, W) int32 shift map -> (P, H, W - min_x, K)
// int16 windowed banded cost at disparity clamp(s + stride * k, 0, ndisp - 1).
SVT_EXPORT int svt_banded_cost(const void* left, const void* right, const void* shift, void* out, int P, int H,
                               int W, int K, int G, int ndisp, int bs, int ftzero, int min_x, int stride,
                               void* stream) {
  if (stride < 1) return cudaErrorInvalidValue;
  const int TX = K <= 8 ? 64 : K == 16 ? 32 : K == 32 ? 16 : 8;
  const int NC = TX + 2 * (bs / 2), NRcap = NC + ndisp;
  const size_t smem = (size_t)(bs * NC + 6 * NC + 6 * NRcap + bs * NC * K + NC * K) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(banded_cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W - min_x + TX - 1) / TX, H, P);
  banded_cost_kernel<<<grid, kCostThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(left), static_cast<const int*>(right), static_cast<const int*>(shift),
      static_cast<int16_t*>(out), H, W, K, G, ndisp, bs, ftzero, min_x, stride, TX, NRcap);
  return cudaGetLastError();
}

// (P, H, Wv, K) int16 cost + (P, H, Wv) shift map -> the down and up vertical
// direction volumes (int16).
SVT_EXPORT int svt_banded_vertical(const void* C, const void* shift, void* dn, void* up, int P, int H, int Wv, int K,
                                   int G, int P1, int P2, void* stream) {
  return scans_for(K, 0, static_cast<const int16_t*>(C), static_cast<const int*>(shift), static_cast<int16_t*>(dn),
                   static_cast<int16_t*>(up), P, H, Wv, G, P1, P2, 0, static_cast<cudaStream_t>(stream));
}

// Bytes of device scratch that svt_banded_vertical_diag needs for P frames on
// `device`: 0 where a block's carries (8 * Wv * K bytes) fit the device's
// opt-in shared memory per block, else those bytes for each (frame,
// direction) block; -1 for a width the kernel does not take (Wv > 4096) or a
// failed device query.
SVT_EXPORT long long svt_banded_vertical_diag_scratch_bytes(int P, int Wv, int K, int device) {
  if (Wv < 1 || Wv > 4 * kDiagMaxThreads) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  const long long carries = 8LL * Wv * K;
  return carries <= optin ? 0 : 2LL * P * carries;
}

// (P, H, Wv, K) int16 cost + (P, H, Wv) shift map -> the down and up sets of the
// 8-path vertical (each the int16 sum of its vertical and two diagonal
// carries). scratch: null for the carries in shared memory, else the device
// memory that svt_banded_vertical_diag_scratch_bytes asks for. Wv <= 4096.
SVT_EXPORT int svt_banded_vertical_diag(const void* C, const void* shift, void* dn, void* up, void* scratch, int P,
                                        int H, int Wv, int K, int G, int P1, int P2, void* stream) {
  if (Wv < 1 || Wv > 4 * kDiagMaxThreads) return cudaErrorInvalidValue;
  if (P == 0 || H == 0) return cudaSuccess;
  const auto c = static_cast<const int16_t*>(C);
  const auto s = static_cast<const int*>(shift);
  const auto d = static_cast<int16_t*>(dn), u = static_cast<int16_t*>(up), w = static_cast<int16_t*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: return diag_for_cpt<4>(c, s, d, u, w, P, H, Wv, G, P1, P2, st);
    case 8: return diag_for_cpt<8>(c, s, d, u, w, P, H, Wv, G, P1, P2, st);
    case 16: return diag_for_cpt<16>(c, s, d, u, w, P, H, Wv, G, P1, P2, st);
    case 32: return diag_for_cpt<32>(c, s, d, u, w, P, H, Wv, G, P1, P2, st);
    case 64: return diag_for_cpt<64>(c, s, d, u, w, P, H, Wv, G, P1, P2, st);
    default: return cudaErrorInvalidValue;
  }
}

// (P, H, Wv, K) int16 cost + (P, H, Wv) shift map -> one horizontal direction volume.
SVT_EXPORT int svt_banded_horizontal(const void* C, const void* shift, void* out, int P, int H, int Wv, int K, int G,
                                     int P1, int P2, int reverse, void* stream) {
  return scans_for(K, 1, static_cast<const int16_t*>(C), static_cast<const int*>(shift), static_cast<int16_t*>(out),
                   nullptr, P, H, Wv, G, P1, P2, reverse, static_cast<cudaStream_t>(stream));
}

// nvol (2-4) int16 (npix, K) volumes -> minS, best and either sub16 (sub) or
// sm, s0, sp (int32), and the uniqueness verdict (uint8). m3/m4 and v2/v3
// may be null when unused.
SVT_EXPORT int svt_banded_wta(const void* v0, const void* v1, const void* v2, const void* v3, int nvol, void* minS,
                              void* best, void* m2, void* m3, void* m4, void* uok, int npix, int K, int uniq,
                              int sub, void* stream) {
  if (nvol < 2 || nvol > 4) return cudaErrorInvalidValue;
  const int16_t* v[4] = {static_cast<const int16_t*>(v0), static_cast<const int16_t*>(v1),
                         static_cast<const int16_t*>(v2), static_cast<const int16_t*>(v3)};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(m2), static_cast<int*>(m3),
                  static_cast<int*>(m4)};
  const auto u = static_cast<uint8_t*>(uok);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: return wta<4>(v, nvol, npix, uniq, sub, maps, u, st);
    case 8: return wta<8>(v, nvol, npix, uniq, sub, maps, u, st);
    case 16: return wta<16>(v, nvol, npix, uniq, sub, maps, u, st);
    case 32: return wta<32>(v, nvol, npix, uniq, sub, maps, u, st);
    case 64: return wta<64>(v, nvol, npix, uniq, sub, maps, u, st);
    default: return cudaErrorInvalidValue;
  }
}

// nvol (2-4) int16 (npix, 16) volumes + the int32 (npix) shift map -> the int32
// pack and du maps of the fused WTA; band 16 only, as the TPU kernel.
SVT_EXPORT int svt_banded_wta_fused(const void* v0, const void* v1, const void* v2, const void* v3, int nvol,
                                    const void* shift, void* pack, void* du, int npix, int K, int uniq,
                                    void* stream) {
  if (nvol < 2 || nvol > 4 || K != 16) return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  banded_wta_fused_kernel<16><<<(npix + kScanThreads - 1) / kScanThreads, kScanThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(v0), static_cast<const int16_t*>(v1), static_cast<const int16_t*>(v2),
      static_cast<const int16_t*>(v3), nvol, npix, uniq, static_cast<const int*>(shift), static_cast<int*>(pack),
      static_cast<int*>(du));
  return cudaGetLastError();
}

// (P, H, W) int32 image -> (P, H / fy, W / fx) int32 box mean (trailing rows and
// columns that fill no block are dropped).
SVT_EXPORT int svt_downsample_box(const void* in, void* out, int P, int H, int W, int fy, int fx, void* stream) {
  if (fy < 1 || fx < 1 || fy * fx > (1 << 16)) return cudaErrorInvalidValue;
  const int Hc = H / fy, Wc = W / fx, npix = P * Hc * Wc;
  if (npix == 0) return cudaSuccess;
  downsample_box_kernel<<<(npix + kCostThreads - 1) / kCostThreads, kCostThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(in), static_cast<int*>(out),
                                                               H, W, Hc, Wc, fy, fx, npix);
  return cudaGetLastError();
}
