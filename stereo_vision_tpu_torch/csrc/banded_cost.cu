// The banded cost of the hierarchical matcher (matcher="sgbm_hier"):
// banded_cost_kernel, in a source of its own beside banded.cu, at every band
// K >= 1, int16 or int32 output (a pixel's lanes lane_stride(K) apart; the
// lanes from K to the next multiple of 4 are computed as if the band went
// on, and no kernel reads them). The lane, shift and
// window semantics are banded.cu's (header).

#include <climits>

#include "banded.cuh"

namespace {

using svt::bt;
using svt::clampi;
using svt::extrema;

constexpr int kCostThreads = 256;

// Replaces banded_pallas.py:377 banded_pixel_cost_pack -> _pix_kernel:152
// and aligned_box_packed -> _aligned_box_kernel:481 / _srows:512: the
// per-pixel banded BT cost of every window pixel q at its OWN band
// (clamp(s(q) + stride * j, 0, ndisp - 1)), aligned into the centre's band
// by rows (centre = the pixel's own cost), then by columns (centre = the
// row-pass sum), for x >= min_x.
//
// What bounds it: bytes. At the hier4x3 full level (32 frames of 1280x720,
// K=4, 1152 columns) it writes a 212 MB int16 volume and reads the int32
// images and shift map once: 0.169 ms at 3.35 TB/s. What holds it back
// (PERF.md): instruction issue, ~170 integer instructions an output lane at
// K=4 (the Sobel and channels of each row are shared by only 4 lanes there)
// with a barrier between phases.
//
// Design: a block owns (frame, tile of TX columns, strip of kCostStrip
// output rows) and walks down the strip, so that each source row enters it
// once and each per-pixel cost is computed once per block (the window's
// bs - 1 halo rows and columns are the only work done twice). Source row k
// of the strip is image row clamp(y0 - r + k). Per source row, three
// phases with a __syncthreads after each:
//   A. the next image row (left: the window's columns +-2; right: the
//      columns the strip's shifts reach, [cmin - dhi, cmax - dlo], at most
//      NC + ndisp - 1 of them, +-2) enters a 4-row ring of raw image rows,
//      and row k's shifts a ring of bs rows, both from registers that were
//      loaded one row earlier (so that their latency hides behind a row's
//      work), then the loads for the row after are issued; row k + 1's
//      clipped x-Sobel, once a pixel, into one of two Sobel rows; row k's
//      six BT channels (Sobel and raw: value, half-minimum, half-maximum)
//      from the neighbours in shared memory;
//   B. row k's per-pixel banded costs into a ring of bs rows (int16: at most
//      2 ftzero + 63, and the plain form stores int16 too);
//   C. once the ring holds an output row's window: the aligned row pass into
//      the row-pass sums, then (D.) the aligned column pass over them,
//      written with one vector store of 4 lanes a thread (8 bytes in int16,
//      16 in int32).
// The rings are lane-major ([lane][column]) and a phase hands out (column,
// 4-lane chunk) items column-fastest, so that a warp's shared-memory
// accesses fall on 32 consecutive words; a window term realigns a chunk
// once (none where the neighbour's shift equals the centre's) and selects
// each lane from the neighbour or the centre. TX = min(256, 2048 / KP)
// columns give each of the 256 threads one or two items a phase. Rows and columns clamp at the image edge, for the cost and
// for s; a right sample left of column 0 replicates column 0. Where a
// configuration's rings do not fit the shared memory, the tile shrinks
// (cost_tile); where even a one-column tile's do not (a wide band at a large
// block: K = 256 from block 21 at ndisp 256), banded_cost_scratch_kernel
// runs the same block over rings in device scratch, one slot of the layout
// a resident block (two an SM), each block walking the (tile, strip, frame)
// items blockIdx.x, + gridDim.x, ...
constexpr int kCostStrip = 32;  // output rows a block walks down
constexpr int kRawAhead = 4;    // raw image values a thread holds in flight (more: loaded at once)
constexpr int kShiftAhead = 2;  // shifts a thread holds in flight (more: loaded at once)

// Sums the window term of one neighbour into the 4 lanes lane0.. of a chunk:
// align_window for each lane (the neighbour's lane + sh, or the centre's own
// value c4 where there is no source or |delta| > G). `a` is the
// neighbour's lane 0, its lanes `stride` apart.
template <typename V>
__device__ __forceinline__ void window4(const V* a, int stride, int delta, const int (&c4)[4], int lane0, int G, int K,
                                        int (&sum)[4]) {
  if (delta == 0) {  // the neighbour's band is the centre's
#pragma unroll
    for (int l = 0; l < 4; ++l) sum[l] += static_cast<int>(a[(lane0 + l) * stride]);
    return;
  }
  const bool reset = delta > G || delta < -G;
  const int sh = delta == G ? G : delta == -G ? -G : 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int q = lane0 + l + sh;
    sum[l] += !reset && q >= 0 && q < K ? static_cast<int>(a[q * stride]) : c4[l];
  }
}

// Byte offsets of a cost block's shared memory for a tile of TX columns
// (NC = TX + bs - 1 window columns; right columns at most NC + ndisp + 3)
// and band K (its rings hold K rounded up to 4 lanes).
struct CostLayout {
  int NC, NCr, NRcap;
  size_t acc, pix, rawL, rawR, sob, chL, chR, ring, range, bytes;
  __host__ __device__ CostLayout(int TX, int band, int ndisp, int bs) {
    const int K = svt::lane_stride(band);
    NC = TX + bs - 1;
    NCr = NC + 4;
    NRcap = NC + ndisp + 4;
    size_t o = 0;
    acc = o;  // [K][NC] int: row-pass sums
    o += (size_t)K * NC * 4;
    pix = o;  // [bs][K][NC] int16: the ring of per-pixel costs
    o += ((size_t)bs * K * NC * 2 + 15) / 16 * 16;
    rawL = o;  // [4][NCr] raw left rows
    o += (size_t)4 * NCr * 4;
    rawR = o;  // [4][NRcap] raw right rows
    o += (size_t)4 * NRcap * 4;
    sob = o;  // [2][NCr + NRcap] two rows of Sobel, left then right
    o += (size_t)2 * (NCr + NRcap) * 4;
    chL = o;  // [6][NC] left channels
    o += (size_t)6 * NC * 4;
    chR = o;  // [6][NRcap] right channels
    o += (size_t)6 * NRcap * 4;
    ring = o;  // [bs][NC] the ring of shifts
    o += (size_t)bs * NC * 4;
    range = o;  // dlo, dhi
    o += 2 * 4;
    bytes = o;
  }
};

// SGBM's clipped x-Sobel at column x of the row r0 (rows rm above, rp
// below), the rows held from column base on; columns 0 and W-1 are ftzero.
__device__ __forceinline__ int ring_sobel(const int* rm, const int* r0, const int* rp, int base, int x, int W,
                                          int ftzero) {
  if (x <= 0 || x >= W - 1) return ftzero;
  const int i = x - base;
  const int d = 2 * (r0[i + 1] - r0[i - 1]) + (rm[i + 1] - rm[i - 1]) + (rp[i + 1] - rp[i - 1]);
  return clampi(d, -ftzero, ftzero) + ftzero;
}

// The next (4-lane chunk, column) item of a thread: nt columns on, column-
// fastest over n columns.
__device__ __forceinline__ void next_item(int& ch, int& j, int nt, int n) {
  j += nt;
  while (j >= n) {
    j -= n;
    ++ch;
  }
}

__device__ __forceinline__ void store4(int16_t* p, const int (&v)[4]) {
  *reinterpret_cast<short4*>(p) = make_short4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// One block's work: the output rows of strip `strip` and the TX columns of
// tile `tile` of frame b, its rings at `cost_smem` (shared memory, or a slot
// of device scratch laid out alike).
template <typename T>
__device__ __forceinline__ void cost_block(unsigned char* cost_smem, const int* __restrict__ left,
                                           const int* __restrict__ right, const int* __restrict__ shift,
                                           T* __restrict__ out, int H, int W, int K, int G, int ndisp, int bs,
                                           int ftzero, int min_x, int stride, int TX, int tile, int strip, int b) {
  const CostLayout lay(TX, K, ndisp, bs);
  int* acc = reinterpret_cast<int*>(cost_smem + lay.acc);
  int16_t* pix = reinterpret_cast<int16_t*>(cost_smem + lay.pix);
  int* rawL = reinterpret_cast<int*>(cost_smem + lay.rawL);
  int* rawR = reinterpret_cast<int*>(cost_smem + lay.rawR);
  int* sob = reinterpret_cast<int*>(cost_smem + lay.sob);
  int* chL = reinterpret_cast<int*>(cost_smem + lay.chL);
  int* chR = reinterpret_cast<int*>(cost_smem + lay.chR);
  int* ring = reinterpret_cast<int*>(cost_smem + lay.ring);
  int* range = reinterpret_cast<int*>(cost_smem + lay.range);
  const int NC = lay.NC, NCr = lay.NCr, NRcap = lay.NRcap, NS = NCr + NRcap;
  // The window spans -r .. r1 = bs - 1 - r about its centre (r = bs / 2; an
  // even block reaches one less below and to the right, as the reference's).
  // KS lanes a pixel in memory, computed in KC chunks of 4; lanes k >= K
  // are no window term's source (window4).
  const int KS = svt::lane_stride(K);
  const int r = bs / 2, r1 = bs - 1 - r, KC = KS / 4, tid = threadIdx.x, nt = blockDim.x;
  const size_t plane = (size_t)KS * NC;  // one row of the cost ring

  const int x0 = min_x + tile * TX;
  const int y0 = strip * kCostStrip, y1 = min(y0 + kCostStrip, H);
  const int nsrc = y1 - y0 + bs - 1;
  const int Wo = W - min_x;
  const int* L = left + (size_t)b * H * W;
  const int* R = right + (size_t)b * H * W;
  const int* S = shift + (size_t)b * H * W;
  const int cmin = clampi(x0 - r, 0, W - 1), cmax = clampi(x0 + TX - 1 + r1, 0, W - 1);
  auto src_row = [&](int k) { return clampi(y0 - r + k, 0, H - 1); };

  // The disparities the strip's shifts reach: [dlo, dhi].
  if (tid == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = tid; i < nsrc * NC; i += nt) {
    const int k = i / NC, j = i - k * NC;
    const int sv = __ldg(S + (size_t)src_row(k) * W + clampi(x0 - r + j, 0, W - 1));
    lo = min(lo, clampi(sv, 0, ndisp - 1));
    hi = max(hi, clampi(sv + stride * (KS - 1), 0, ndisp - 1));
  }
  lo = __reduce_min_sync(svt::kFullMask, lo);
  hi = __reduce_max_sync(svt::kFullMask, hi);
  if ((tid & 31) == 0 && lo <= hi) {
    atomicMin(range, lo);
    atomicMax(range + 1, hi);
  }
  __syncthreads();
  const int qlo = cmin - range[1], qhi = cmax - range[0];  // right columns (below 0: column 0)
  // Columns held: raw rows [*rlo, *rhi], Sobel [*slo, *shi] (left l, right r).
  const int lrlo = max(cmin - 2, 0), lrhi = min(cmax + 2, W - 1);
  const int lslo = max(cmin - 1, 0), lshi = min(cmax + 1, W - 1);
  const int rrlo = clampi(qlo - 2, 0, W - 1), rrhi = clampi(qhi + 2, 0, W - 1);
  const int rslo = clampi(qlo - 1, 0, W - 1), rshi = clampi(qhi + 1, 0, W - 1);
  const int nLr = lrhi - lrlo + 1, nRr = rrhi - rrlo + 1, nraw = nLr + nRr;
  const int nLs = lshi - lslo + 1, nRs = rshi - rslo + 1;
  const int nLc = cmax - cmin + 1, nRc = qhi - qlo + 1;

  // Raw image rows: value i of row `row` (left columns, then right).
  auto raw_at = [&](int row, int i) {
    return i < nLr ? __ldg(L + (size_t)row * W + lrlo + i) : __ldg(R + (size_t)row * W + rrlo + i - nLr);
  };
  auto raw_slot = [&](int row, int i) -> int& {
    return i < nLr ? rawL[(row & 3) * NCr + i] : rawR[(row & 3) * NRcap + i - nLr];
  };
  auto shift_at = [&](int k, int j) { return __ldg(S + (size_t)src_row(k) * W + clampi(x0 - r + j, 0, W - 1)); };
  // Sobel of source row k into Sobel row k & 1 (its raw rows in the ring).
  auto sobel_row = [&](int k) {
    const int yy = src_row(k);
    const int am = max(yy - 1, 0) & 3, a0 = yy & 3, ap = min(yy + 1, H - 1) & 3;
    int* srow = sob + (k & 1) * NS;
    for (int i = tid; i < nLs + nRs; i += nt) {
      if (i < nLs) {
        srow[i] = ring_sobel(rawL + am * NCr, rawL + a0 * NCr, rawL + ap * NCr, lrlo, lslo + i, W, ftzero);
      } else {
        srow[NCr + i - nLs] =
            ring_sobel(rawR + am * NRcap, rawR + a0 * NRcap, rawR + ap * NRcap, rrlo, rslo + i - nLs, W, ftzero);
      }
    }
  };

  // Prologue: rows clamp(yy0 - 1) .. yy0 + 2 into the raw ring, the Sobel of
  // source row 0; in flight: the next raw row and source row 0's shifts.
  const int yy0 = src_row(0);
  int loaded = min(yy0 + 2, H - 1);  // the last row in the raw ring
  for (int row = max(yy0 - 1, 0); row <= loaded; ++row)
    for (int i = tid; i < nraw; i += nt) raw_slot(row, i) = raw_at(row, i);
  int pf_raw[kRawAhead], pf_s[kShiftAhead];
  auto fetch_raw = [&](int row) {
#pragma unroll
    for (int u = 0; u < kRawAhead; ++u) {
      const int i = tid + u * nt;
      if (i < nraw) pf_raw[u] = raw_at(row, i);
    }
  };
  auto fetch_shift = [&](int k) {
#pragma unroll
    for (int u = 0; u < kShiftAhead; ++u) {
      const int j = tid + u * nt;
      if (j < NC) pf_s[u] = shift_at(k, j);
    }
  };
  if (loaded + 1 < H) fetch_raw(loaded + 1);
  fetch_shift(0);
  __syncthreads();
  sobel_row(0);
  __syncthreads();

  for (int k = 0; k < nsrc; ++k) {
    const int yy = src_row(k);
    // A. The prefetched rows into the rings, the next loads in flight; the
    // Sobel of row k + 1 and the channels of row k.
    const int want = min(yy + 3, H - 1);  // the Sobel of row k + 2 needs rows up to yy + 3
    if (want > loaded) {  // want == loaded + 1
      ++loaded;
#pragma unroll
      for (int u = 0; u < kRawAhead; ++u) {
        const int i = tid + u * nt;
        if (i < nraw) raw_slot(loaded, i) = pf_raw[u];
      }
      for (int i = tid + kRawAhead * nt; i < nraw; i += nt) raw_slot(loaded, i) = raw_at(loaded, i);
      if (loaded + 1 < H) fetch_raw(loaded + 1);
    }
    int* srow = ring + (k % bs) * NC;
#pragma unroll
    for (int u = 0; u < kShiftAhead; ++u) {
      const int j = tid + u * nt;
      if (j < NC) srow[j] = pf_s[u];
    }
    for (int j = tid + kShiftAhead * nt; j < NC; j += nt) srow[j] = shift_at(k, j);
    if (k + 1 < nsrc) fetch_shift(k + 1);
    if (k + 1 < nsrc) sobel_row(k + 1);
    const int* sl = sob + (k & 1) * NS - lslo;  // Sobel of row k by column (left)
    const int* sr = sob + (k & 1) * NS + NCr - rslo;
    for (int i = tid; i < nLc + nRc; i += nt) {
      if (i < nLc) {
        const int c = cmin + i, cm = max(c - 1, 0), cp = min(c + 1, W - 1);
        extrema(sl[c], sl[cm], sl[cp], chL + i, NC);
        const int* raw = rawL + (yy & 3) * NCr - lrlo;
        extrema(raw[c], raw[cm], raw[cp], chL + 3 * NC + i, NC);
      } else {
        const int iq = i - nLc, q = qlo + iq;
        const int qc = clampi(q, 0, W - 1), qm = clampi(q - 1, 0, W - 1), qp = clampi(q + 1, 0, W - 1);
        extrema(sr[qc], sr[qm], sr[qp], chR + iq, NRcap);
        const int* raw = rawR + (yy & 3) * NRcap - rrlo;
        extrema(raw[qc], raw[qm], raw[qp], chR + 3 * NRcap + iq, NRcap);
      }
    }
    __syncthreads();
    // B. Row k's per-pixel banded costs into the cost ring.
    int16_t* prow = pix + (size_t)(k % bs) * plane;
    for (int ch = tid / NC, j = tid % NC; ch < KC; next_item(ch, j, nt, NC)) {
      const int lane0 = 4 * ch;
      const int il = clampi(x0 - r + j, 0, W - 1) - cmin;
      const int sv = srow[j];
      const int l0 = chL[il], l1 = chL[NC + il], l2 = chL[2 * NC + il];
      const int l3 = chL[3 * NC + il], l4 = chL[4 * NC + il], l5 = chL[5 * NC + il];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int d = clampi(sv + stride * (lane0 + l), 0, ndisp - 1);
        const int i = il + cmin - d - qlo;
        const int cs = bt(l0, l1, l2, chR[i], chR[NRcap + i], chR[2 * NRcap + i]);
        const int cr = bt(l3, l4, l5, chR[3 * NRcap + i], chR[4 * NRcap + i], chR[5 * NRcap + i]);
        prow[(lane0 + l) * NC + j] = static_cast<int16_t>(cs + (cr >> 2));
      }
    }
    __syncthreads();
    if (k < bs - 1) continue;  // the ring does not hold a window yet
    // C. Row pass for output row y = y0 + k - (bs - 1): its window is ring
    // rows k - (bs - 1) .. k, its centre k - r1.
    const int y = y0 + k - (bs - 1), cslot = (k - r1) % bs, first = (k - (bs - 1)) % bs;
    const int* crow = ring + cslot * NC;
    for (int ch = tid / NC, j = tid % NC; ch < KC; next_item(ch, j, nt, NC)) {
      const int lane0 = 4 * ch;
      const int sc = crow[j];
      const int16_t* ctr = pix + cslot * plane + j;
      const int c4[4] = {ctr[lane0 * NC], ctr[(lane0 + 1) * NC], ctr[(lane0 + 2) * NC], ctr[(lane0 + 3) * NC]};
      int sum[4] = {0, 0, 0, 0};
      int slot = first;
      for (int dy = 0; dy < bs; ++dy) {
        window4(pix + slot * plane + j, NC, sc - ring[slot * NC + j], c4, lane0, G, K, sum);
        slot = slot + 1 == bs ? 0 : slot + 1;
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[(lane0 + l) * NC + j] = sum[l];
    }
    __syncthreads();
    // D. Column pass over the row-pass sums; the centre is the sum at x.
    for (int ch = tid / TX, t = tid % TX; ch < KC; next_item(ch, t, nt, TX)) {
      const int lane0 = 4 * ch;
      const int x = x0 + t;
      if (x >= W) continue;
      const int sc = crow[t + r];
      const int* ctr = acc + t + r;
      const int c4[4] = {ctr[lane0 * NC], ctr[(lane0 + 1) * NC], ctr[(lane0 + 2) * NC], ctr[(lane0 + 3) * NC]};
      int sum[4] = {0, 0, 0, 0};
      for (int dx = 0; dx < bs; ++dx) window4(acc + t + dx, NC, sc - crow[t + dx], c4, lane0, G, K, sum);
      store4(out + (((size_t)b * H + y) * Wo + (x - min_x)) * KS + lane0, sum);
    }
    if (r == 0) __syncthreads();  // bs 1: the next row's shifts take this row's ring slot
  }
}

template <typename T>
__global__ void __launch_bounds__(kCostThreads, 4)
banded_cost_kernel(const int* __restrict__ left, const int* __restrict__ right, const int* __restrict__ shift,
                   T* __restrict__ out, int H, int W, int K, int G, int ndisp, int bs, int ftzero, int min_x,
                   int stride, int TX) {
  extern __shared__ __align__(16) unsigned char cost_smem[];
  cost_block<T>(cost_smem, left, right, shift, out, H, W, K, G, ndisp, bs, ftzero, min_x, stride, TX, blockIdx.x,
                blockIdx.y, blockIdx.z);
}

// The block over rings in device scratch: slot blockIdx.x of `slot` bytes,
// items (tile, strip, frame) = blockIdx.x, + gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kCostThreads, 2)
banded_cost_scratch_kernel(const int* __restrict__ left, const int* __restrict__ right,
                           const int* __restrict__ shift, T* __restrict__ out, unsigned char* scratch, size_t slot,
                           int H, int W, int K, int G, int ndisp, int bs, int ftzero, int min_x, int stride, int TX,
                           int ntiles, int nstrips, int items) {
  unsigned char* rings = scratch + blockIdx.x * slot;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    cost_block<T>(rings, left, right, shift, out, H, W, K, G, ndisp, bs, ftzero, min_x, stride, TX, item % ntiles,
                  item / ntiles % nstrips, item / (ntiles * nstrips));
    __syncthreads();  // the next item reuses the slot
  }
}

// The tile width for band K: TX = 2048 / KP columns (KP the power of two at
// or above K; 256 at most), halved until the block's shared memory fits
// `optin` bytes, then evened out over the Wo output columns. 0: no tile fits.
// (The scratch form takes the widest tile: optin LLONG_MAX.)
int cost_tile(int K, int ndisp, int bs, int Wo, long long optin) {
  int kp = 4;
  while (kp < K) kp *= 2;
  int tx = min(256, max(1, 2048 / kp));
  while (tx > 0 && (long long)CostLayout(tx, K, ndisp, bs).bytes > optin) tx /= 2;
  if (tx == 0) return 0;
  const int tiles = (Wo + tx - 1) / tx;
  return (Wo + tiles - 1) / tiles;
}

template <typename T>
cudaError_t cost_launch(const int* left, const int* right, const int* shift, T* out, int P, int H, int W, int K,
                        int G, int ndisp, int bs, int ftzero, int min_x, int stride, int TX, cudaStream_t st) {
  const size_t smem = CostLayout(TX, K, ndisp, bs).bytes;
  cudaError_t e = cudaFuncSetAttribute(banded_cost_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W - min_x + TX - 1) / TX, (H + kCostStrip - 1) / kCostStrip, P);
  banded_cost_kernel<T><<<grid, kCostThreads, smem, st>>>(left, right, shift, out, H, W, K, G, ndisp, bs, ftzero,
                                                          min_x, stride, TX);
  return cudaGetLastError();
}

// The scratch form's geometry: its tile, slot bytes, items and blocks.
struct ScratchPlan {
  int TX, ntiles, nstrips, items, blocks;
  size_t slot;
  ScratchPlan(int P, int H, int Wo, int K, int ndisp, int bs, int sms) {
    TX = cost_tile(K, ndisp, bs, Wo, LLONG_MAX);
    ntiles = (Wo + TX - 1) / TX;
    nstrips = (H + kCostStrip - 1) / kCostStrip;
    items = P * ntiles * nstrips;
    blocks = min(items, 2 * sms);
    slot = (CostLayout(TX, K, ndisp, bs).bytes + 255) / 256 * 256;
  }
};

int multiprocessors(int device) {
  int sms = 0;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess ? sms : -1;
}

template <typename T>
cudaError_t cost_scratch_launch(const int* left, const int* right, const int* shift, T* out, unsigned char* scratch,
                                int P, int H, int W, int K, int G, int ndisp, int bs, int ftzero, int min_x,
                                int stride, cudaStream_t st) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int sms = multiprocessors(dev);
  if (sms < 1) return cudaErrorInvalidValue;
  const ScratchPlan plan(P, H, W - min_x, K, ndisp, bs, sms);
  banded_cost_scratch_kernel<T><<<plan.blocks, kCostThreads, 0, st>>>(
      left, right, shift, out, scratch, plan.slot, H, W, K, G, ndisp, bs, ftzero, min_x, stride, plan.TX,
      plan.ntiles, plan.nstrips, plan.items);
  return cudaGetLastError();
}

}  // namespace

// The tile width the banded cost kernel takes for band K, ndisp, block bs and
// Wo output columns on `device` (its shared memory per block); 0 where no
// tile fits (svt_banded_cost then takes device scratch), -1 for a failed
// device query.
SVT_EXPORT int svt_banded_cost_tile(int K, int ndisp, int bs, int Wo, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return cost_tile(K, ndisp, bs, Wo, optin);
}

// Bytes of device scratch svt_banded_cost needs where svt_banded_cost_tile
// finds no tile: a slot of the block's layout for each of two blocks an SM
// (fewer where there are fewer items); -1 for a failed device query.
SVT_EXPORT long long svt_banded_cost_scratch_bytes(int P, int H, int Wo, int K, int ndisp, int bs, int device) {
  const int sms = multiprocessors(device);
  if (sms < 1) return -1;
  if (P == 0 || H == 0 || Wo <= 0) return 0;
  const ScratchPlan plan(P, H, Wo, K, ndisp, bs, sms);
  return (long long)plan.blocks * (long long)plan.slot;
}

// (P, H, W) int32 left/right + (P, H, W) int32 shift map -> (P, H, W - min_x, K)
// windowed banded cost at disparity clamp(s + stride * k, 0, ndisp - 1),
// int16 (bytes 2) or int32 (bytes 4), in tiles of TX columns
// (svt_banded_cost_tile) with the rings in shared memory, or with `scratch`
// (svt_banded_cost_scratch_bytes of it; TX then unused) in device scratch.
// K >= 1; a pixel of `out` holds lane_stride(K) lanes, its first K the band's.
SVT_EXPORT int svt_banded_cost(const void* left, const void* right, const void* shift, void* out, int P, int H,
                               int W, int K, int G, int ndisp, int bs, int ftzero, int min_x, int stride, int TX,
                               int bytes, void* scratch, void* stream) {
  if (stride < 1 || K < 1 || bs < 1) return cudaErrorInvalidValue;
  if (P == 0 || H == 0 || min_x >= W) return cudaSuccess;
  if (TX < 1 && !scratch) return cudaErrorInvalidValue;
  const auto l = static_cast<const int*>(left), r = static_cast<const int*>(right), s = static_cast<const int*>(shift);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<unsigned char*>(scratch);
  if (sc && bytes == 2)
    return cost_scratch_launch(l, r, s, static_cast<int16_t*>(out), sc, P, H, W, K, G, ndisp, bs, ftzero, min_x,
                               stride, st);
  if (sc && bytes == 4)
    return cost_scratch_launch(l, r, s, static_cast<int*>(out), sc, P, H, W, K, G, ndisp, bs, ftzero, min_x, stride,
                               st);
  if (bytes == 2)
    return cost_launch(l, r, s, static_cast<int16_t*>(out), P, H, W, K, G, ndisp, bs, ftzero, min_x, stride, TX, st);
  if (bytes == 4)
    return cost_launch(l, r, s, static_cast<int*>(out), P, H, W, K, G, ndisp, bs, ftzero, min_x, stride, TX, st);
  return cudaErrorInvalidValue;
}

