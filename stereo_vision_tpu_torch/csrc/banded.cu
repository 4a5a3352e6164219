// Band-limited SGBM core of the hierarchical matcher (matcher="sgbm_hier").
//
// Replaces the kernel bodies of stereo_vision_tpu/stereo/banded_pallas.py
// that banded_stats_pack chains:
//   _pix_kernel + _aligned_box_kernel(_srows) -> banded_cost_kernel
//   _vert_kernel (without diagonals)          -> banded_vertical_kernel
//   _vert_kernel (with diagonals, 8 paths)    -> banded_diag.cuh
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
// Layout: banded volumes (P, H, Wv, K) of T, frames on the grid; T is int16
// where the wrappers find that the volumes' bound fits it and int32
// otherwise, and every kernel is one template over T. K is any multiple of 4
// from 4 to 64 (banded.cuh: kernels are instantiated at the next power of
// two and take K at run time). The TPU kernels' 128-lane frame packing,
// float32-for-int and tile-entry delta rows are not carried over.
//
// What bounds them on an H100 (hier4x3 full-res level, 32 frames of
// 1280x720, K=4, 1152 valid columns; one int16 volume = 212 MB): the cost
// kernel writes one volume (~63 us at 3.35 TB/s); vertical reads one and
// writes two (~190 us); each horizontal reads one and writes one
// (~127 us); the WTA reads three and writes four int32 maps and a bool map
// (~318 us). The scans are also dependent chains of H (or Wv) steps. The
// fused WTA (hier16x3 full level: 8 frames, K=16, three 212 MB volumes and
// a 26.5 MB shift map in, two 26.5 MB int32 maps out) is bytes-bound at
// ~0.21 ms; its operations take under 0.02 ms at 67 T/s.
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
//     independent per column), prefetching the next row. Lane shifts by a
//     runtime delta use a barrel shifter over compile-time offsets.
//   horizontal: see banded_horizontal_kernel.
//   wta: one thread per pixel sums the 2-4 volumes in int32 and reduces
//     over the K lanes. The fused form shares that reduction and the
//     subpixel step, reads the pixel's shift and writes the LR check's pack
//     (minS * 2048 + best + s) and d16 + 32768 * unique_ok; the TPU kernel's
//     8-rows-a-step (W, 128) lane layout and its group-sum matmuls have no
//     counterpart here.
//   downsample: one thread per output pixel; the TPU kernel's 0/1 pooling
//     matmul becomes an integer sum, the float32 division and the
//     half-to-even round stay.

#include <climits>

#include "banded.cuh"

namespace {

using svt::bt;
using svt::clampi;
using svt::extrema;
using svt::kBig;
using svt::xsobel;

constexpr int kCostThreads = 256;
constexpr int kScanThreads = 128;

// ------------------------------------------------------------------ cost

// align_window for one lane: a neighbour's value re-indexed into the centre
// pixel's band, or the centre's own value where there is no source.
__device__ __forceinline__ int window_lane(const int* a, int delta, const int* ctr, int lane, int G, int K) {
  if (delta > G || delta < -G) return ctr[lane];
  if (delta == G) return lane + G < K ? a[lane + G] : ctr[lane];
  if (delta == -G) return lane - G >= 0 ? a[lane - G] : ctr[lane];
  return a[lane];
}

template <typename T>
__global__ void __launch_bounds__(kCostThreads)
banded_cost_kernel(const int* __restrict__ left, const int* __restrict__ right, const int* __restrict__ shift,
                   T* __restrict__ out, int H, int W, int K, int G, int ndisp, int bs, int ftzero, int min_x,
                   int stride, int TX, int NRcap) {
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
    out[(((size_t)b * H + y) * Wo + (x - min_x)) * K + lane] = static_cast<T>(sum);
  }
}

int cost_tile(int K) { return K <= 8 ? 64 : K <= 16 ? 32 : K <= 32 ? 16 : 8; }

size_t cost_smem(int K, int ndisp, int bs) {
  const int NC = cost_tile(K) + 2 * (bs / 2), NRcap = NC + ndisp;
  return (size_t)(bs * NC + 6 * NC + 6 * NRcap + bs * NC * K + NC * K) * sizeof(int);
}

template <typename T>
cudaError_t cost_launch(const int* left, const int* right, const int* shift, T* out, int P, int H, int W, int K,
                        int G, int ndisp, int bs, int ftzero, int min_x, int stride, cudaStream_t st) {
  const size_t smem = cost_smem(K, ndisp, bs);
  cudaError_t e = cudaFuncSetAttribute(banded_cost_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int TX = cost_tile(K);
  const int NRcap = TX + 2 * (bs / 2) + ndisp;
  const dim3 grid((W - min_x + TX - 1) / TX, H, P);
  banded_cost_kernel<T><<<grid, kCostThreads, smem, st>>>(left, right, shift, out, H, W, K, G, ndisp, bs, ftzero,
                                                          min_x, stride, TX, NRcap);
  return cudaGetLastError();
}

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

// Replaces banded_pallas.py:1144 banded_reduce_pack -> _horiz_kernel:759:
// the L->R (reverse: R->L) banded SGM recurrence of every (frame, row),
// the carry realigned by s(x) - s(x -+ 1) (0 at the first column).
//
// What bounds it: bytes. It reads the cost volume and the shift map once
// and writes one volume: at the hier16x3 full level (8 frames of 720 rows,
// 1152 columns, K=16, int16) 2 x 212 MB + 26.5 MB, ~0.135 ms at 3.35 TB/s;
// its ~10 operations a lane and step take ~0.03 ms at 67 T/s.
//
// The recurrence is a chain of Wv dependent steps per row, so the design is
// about that chain. A group of GS = min(KP, 32) threads owns one (frame,
// row) and thread t holds lanes t + GS * j, j < KP / GS (two above K=32),
// so the card holds rows x GS threads (92,160 at the hier16x3 full level)
// where one thread a row held 5,760. Per column step, with every shuffle
// inside the group:
//   - the carry's lanes k + sh, k + sh - 1 and k + sh + 1 (sh = +-G or 0)
//     come by three independent __shfl_sync, kBig outside [0, K), which
//     gives the realigned carry and its d -+ 1 neighbours at once;
//   - its minimum over the band is log2(GS) __shfl_xor_sync steps, or one
//     __reduce_min_sync where the group is the warp (under a group's mask
//     the warp's groups take their __reduce_min_sync in turns);
//   - the update is a few integer operations per lane.
// Each thread loads and stores its own lanes: a group's K lanes of one
// column are contiguous (32 bytes at K=16 int16), so each access is whole
// sectors. Loads run U columns ahead through a register ring, so that a
// column's cost and shift arrive while earlier columns' steps run; they are
// unconditional (a lane past the band or a column past the row reads an
// in-bounds neighbour it never uses) and sign-extend in the load itself, so
// that no instruction waits on them before their column's step (a select
// or a conversion placed right after a load stalls the whole chain). Every
// lane of the group reads the shift map at the same address, one broadcast
// a column. At most 64 registers a thread keep all of a level's groups
// resident in one wave. What holds it back (PERF.md): at K=16 the chain of
// a step's shuffles, minimum and update, row by row; at K <= 8 a warp's
// load or store touches 32 / GS rows, so the time grows with the frames.
// Both directions and both storage types are one template.
constexpr int kHorizThreads = 128;
constexpr int kHorizBlocksPerSM = 8;
constexpr int kHorizAhead = 4;  // U: columns loaded ahead of the step chain

// A read-only load of a T lane, sign-extended to int32 by the load itself.
__device__ __forceinline__ int load_lane(const int16_t* p) {
  int v;
  asm("ld.global.nc.s16 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int load_lane(const int* p) { return __ldg(p); }

template <typename T, int GS, int LPT>
__global__ void __launch_bounds__(kHorizThreads, kHorizBlocksPerSM)
banded_horizontal_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out, int rows,
                         int Wv, int K, int G, int P1, int P2, int reverse) {
  constexpr int U = kHorizAhead;
  constexpr int kLogGS = svt::log2_of<GS>();
  const int lane = threadIdx.x & 31;
  const int t = lane & (GS - 1);
  const int warp_row0 = (blockIdx.x * kHorizThreads + (threadIdx.x & ~31)) / GS;
  if (warp_row0 >= rows) return;  // whole warp
  const int gid = warp_row0 + lane / GS;
  const bool live = gid < rows;  // a group past the last row shadows it and stores nothing
  const size_t row = live ? gid : rows - 1;
  const T* crow = C + row * Wv * K;
  T* orow = out + row * Wv * K;
  const int* srow = shift + row * Wv;

  bool valid[LPT];
  int L[LPT], lofs[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    valid[j] = t + GS * j < K;
    lofs[j] = min(t + GS * j, K - 1);  // the lane a thread loads (past the band: a neighbour, unused)
    L[j] = valid[j] ? 0 : kBig;        // the zero carry; lanes past the band hold kBig
  }
  // Column of the ti-th step in scan order, clamped into the row.
  auto column = [&](int ti) {
    const int c = min(ti, Wv - 1);
    return reverse ? Wv - 1 - c : c;
  };

  // The register ring: costs and shifts of columns [base, base + U) in scan order.
  int cn[U][LPT], sn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int x = column(u);
    sn[u] = __ldg(srow + x);
#pragma unroll
    for (int j = 0; j < LPT; ++j) cn[u][j] = load_lane(crow + (size_t)x * K + lofs[j]);
  }
  int sprev = sn[0];  // delta 0 at the first column

  for (int base = 0; base < Wv; base += U) {
    int cc[U][LPT], sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u] = sn[u];
#pragma unroll
      for (int j = 0; j < LPT; ++j) cc[u][j] = cn[u][j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = column(base + U + u);
      sn[u] = __ldg(srow + x);
#pragma unroll
      for (int j = 0; j < LPT; ++j) cn[u][j] = load_lane(crow + (size_t)x * K + lofs[j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ti = base + u;
      if (ti >= Wv) break;  // uniform: every group has the same Wv
      const int delta = sc[u] - sprev;
      sprev = sc[u];
      const bool reset = delta > G || delta < -G;
      const int sh = delta == G ? G : delta == -G ? -G : 0;
      // Lanes k + sh + o of the carry, o = -1, 0, +1: a[o + 1][j].
      int a[3][LPT];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const int q = t + sh + o - 1;
        const int src = q & (GS - 1), e0 = q >> kLogGS;  // floor division
        int v[LPT];
#pragma unroll
        for (int e = 0; e < LPT; ++e) v[e] = __shfl_sync(svt::kFullMask, L[e], src, GS);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const int e = j + e0;
          int r = kBig;
#pragma unroll
          for (int f = 0; f < LPT; ++f) r = e == f ? v[f] : r;
          a[o][j] = r;
        }
      }
      int m = kBig;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int k = t + GS * j;
        if (!valid[j]) a[1][j] = kBig;
        if (k == 0) a[0][j] = kBig;       // no lane below the band
        if (k + 1 >= K) a[2][j] = kBig;  // no lane above it
        m = min(m, a[1][j]);
      }
      if constexpr (GS == 32) {
        m = __reduce_min_sync(svt::kFullMask, m);
      } else {
#pragma unroll
        for (int o = GS / 2; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(svt::kFullMask, m, o, GS));
      }
      const bool border = reset || m >= kBig;
      const int x = column(ti);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int cand = min(min(a[1][j], m + P2), min(a[0][j], a[2][j]) + P1);
        L[j] = !valid[j] ? kBig : border ? cc[u][j] : cc[u][j] + cand - m;
        if (live && valid[j]) orow[(size_t)x * K + t + GS * j] = static_cast<T>(L[j]);
      }
    }
  }
}

template <typename T, int GS, int LPT>
cudaError_t horizontal_launch(const T* C, const int* s, T* out, int rows, int Wv, int K, int G, int P1, int P2,
                              int reverse, cudaStream_t st) {
  const long long threads = (long long)rows * GS;
  const long long blocks = (threads + kHorizThreads - 1) / kHorizThreads;
  banded_horizontal_kernel<T, GS, LPT><<<(unsigned)blocks, kHorizThreads, 0, st>>>(C, s, out, rows, Wv, K, G, P1,
                                                                                   P2, reverse);
  return cudaGetLastError();
}

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

struct WtaStats {
  int mn, bst;  // min and argmin over the lanes (ties -> smallest k)
  int a, z, c;  // the samples at d0 - 1, d0, d0 + 1, d0 = clip(best, 1, K - 2)
  bool ok;      // band-local uniqueness
};

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

// The subpixel parabola in lane units x16; the edges keep 16 * best.
__device__ __forceinline__ int subpixel16(const WtaStats& w, int K) {
  const int denom2 = max(w.a + w.c - 2 * w.z, 1);
  const int q = ((w.a - w.c) * 16 + denom2) / (2 * denom2);  // C division truncates, as the reference
  return w.bst > 0 && w.bst < K - 1 ? w.bst * 16 + q : w.bst * 16;
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
    return horizontal_launch<T, GS, KP / GS>(static_cast<const T*>(C), s, static_cast<T*>(out), rows, Wv, K, G, P1,
                                             P2, reverse, st);
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

// Bytes of dynamic shared memory a block of the banded cost kernel takes.
SVT_EXPORT long long svt_banded_cost_smem(int K, int ndisp, int bs) { return (long long)cost_smem(K, ndisp, bs); }

// (P, H, W) int32 left/right + (P, H, W) int32 shift map -> (P, H, W - min_x, K)
// windowed banded cost at disparity clamp(s + stride * k, 0, ndisp - 1),
// int16 (bytes 2) or int32 (bytes 4).
SVT_EXPORT int svt_banded_cost(const void* left, const void* right, const void* shift, void* out, int P, int H,
                               int W, int K, int G, int ndisp, int bs, int ftzero, int min_x, int stride, int bytes,
                               void* stream) {
  if (stride < 1 || K < 1 || bs < 1 || bs % 2 == 0) return cudaErrorInvalidValue;
  const auto l = static_cast<const int*>(left), r = static_cast<const int*>(right), s = static_cast<const int*>(shift);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bytes == 2)
    return cost_launch(l, r, s, static_cast<int16_t*>(out), P, H, W, K, G, ndisp, bs, ftzero, min_x, stride, st);
  if (bytes == 4)
    return cost_launch(l, r, s, static_cast<int*>(out), P, H, W, K, G, ndisp, bs, ftzero, min_x, stride, st);
  return cudaErrorInvalidValue;
}

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
  downsample_box_kernel<<<(npix + kCostThreads - 1) / kCostThreads, kCostThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(in), static_cast<int*>(out),
                                                               H, W, Hc, Wc, fy, fx, npix);
  return cudaGetLastError();
}
