// Semi-global aggregation and winner-take-all for exact SGBM.
//
// Replaces the kernel bodies of stereo_vision_tpu/stereo/sgm_pallas.py:
//   _vertical_kernel   -> vertical_cluster (3 down + 3 up directions; the
//                         sgm_reduce_pallas and aggregate_8_pallas sites;
//                         its register form and its cluster form)
//   _horizontal_kernel -> horizontal_scan (L->R, or R->L; both sites)
//   _wta4_kernel       -> wta_kernel     (sum of 2-4 direction volumes ->
//                                         min/argmin/uniqueness/subpixel samples)
//   _wta_kernel        -> wta_stats_kernel (the same from one int32 volume,
//                                         wta_stats_pallas)
//   _horizontal_rl_wta_kernel -> horizontal_rl_wta (the R->L scan fused with
//                                         the WTA over four directions)
//
// Layout: one warp owns the D disparities of one pixel, VPL = D/32 (rounded
// up to 1, 2, 4, 8, 16 or 32; D <= 1024) consecutive disparities per lane,
// d = lane*VPL + k. The main paths run VPL <= 8; 16 and 32 are the wide
// ranges' (their registers and spills are in PERF.md). Above 1024 each
// kernel has a form whose warp walks the range in steps of 32 with its
// carry in device memory (wide_range.cuh): the *_wide kernels below.
// The d +- 1 neighbours of an SGM step come from the lane's own registers or
// one shuffle; min over d is a 5-step shuffle reduction, so no step needs a
// block barrier. Disparities d >= D hold a large sentinel that no min takes.
// All arithmetic is int32 (the TPU kernels' float32 was a Mosaic workaround).
// Costs, carries and direction volumes are stored as T: int16 where the
// wrappers find that 3 * (cost_bound + P2) (or cost_bound + P2 for a single
// direction) fits it, int32 otherwise; every kernel is one template over T.
//
// What bounds them on an H100 (720p, D=128, per frame, int16 volumes of
// 212 MB): vertical reads the cost once and writes two volumes (637 MB,
// ~190 us); each horizontal reads the cost and writes one volume (425 MB,
// ~127 us); WTA reads four volumes (850 MB, ~254 us); the one-volume WTA
// reads an int32 volume (425 MB, ~127 us); the fused R->L scan + WTA reads
// the cost and three volumes (850 MB) and writes only the maps. The scans
// are also latency-bound chains: H (or W) dependent steps.
//
// Vertical design (redesigned for Hopper, twice): a diagonal moves one
// column per row, so whatever owns a column strip needs its neighbours'
// edge carries every row. The first design launched once a row (720
// launches an exact8 call, 9.3 us each, carries round-tripping through L2).
// vertical_cluster makes it one launch: a thread block cluster per (frame,
// set) whose blocks split the columns and walk all H rows.
//
// What bounded that cluster kernel was neither bytes nor the barrier but
// instruction issue and SM coverage: each column step loaded and stored
// its three carries in shared memory with their address and border
// arithmetic and 16x2 adds (__vadd2 / __vsub2, several instructions each),
// ~330 instructions a column; and its carry rows (1.5 KB a column) held a
// block to 72 or 144 columns, so 8 frames (16 chains) ran as 3 waves of 7,
// 7 and 2 clusters of 16 (9.3 ms a call, 6.1x its bytes' time). The
// register form (vertical_cluster<N, CPW>) keeps every carry of a
// warp's CPW columns in registers for the whole scan, normalized (L - min
// L, no minimum carried), with plain 32-bit adds where no halfword can
// carry; only a warp's two edge carries leave it, pushed into its
// neighbours' shared memory with st.async on an mbarrier (no fence on the
// volume's stores, no cluster-wide barrier a row); one block an SM, and
// the plan (sgm_cuda.register_plan) splits each chain over a cluster and
// the cluster's warps from the clusters the card holds at once. ~92
// instructions a column; at 8 frames one wave of clusters of 6 over 96 SMs
// runs into HBM (2.4 ms a call against 2.3 ms for torch's copy of the same
// bytes). Which form runs where:
//  - register form: int16, with diagonals, D = 64, 128 or 256 (every
//    lane's 2N values real), P1 <= 0x7fff, W within 16 blocks of the
//    widest warps the card's registers allow (3072 columns at D = 128):
//    every main path (exact8, aggregate_8);
//  - the cluster kernel below (carry rows in shared memory, or in scratch
//    where they do not fit): int32, no diagonals, the other D up to 1024
//    (VPL 1, 16, 32 among them) and wider rows;
//  - above 1024 disparities, a launch a row (vertical_step_wide).
//
// Horizontal design: one warp per (frame, row) keeps its carry in registers
// and walks the W columns, prefetching the next column's costs.
//
// WTA design: one warp per pixel sums the volumes in registers; ties in the
// argmin go to the smallest d. The fused R->L kernel (redesigned for
// Hopper, see horizontal_rl_wta) is the R->L scan with that reduction at
// every column, the fourth direction volume never stored: a ring of columns
// in shared memory ahead of the scan, the reduction beside the next step
// (sgm_cuda._FUSED_RL_WTA picks the form).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "wide_range.cuh"

namespace cg = cooperative_groups;

namespace {

using svt::kFullMask;
using svt::warp_min;
using svt::warp_sum;

constexpr int kBig = 1 << 29;  // out-of-range d±1 neighbour
constexpr int kWarps = 8;      // warps per block

// VPL consecutive values of type T as raw words (16 bytes at most each).
template <typename T, int VPL>
struct Words {
  static constexpr int kBytes = VPL * (int)sizeof(T);
  static constexpr int kWordBytes = kBytes >= 16 ? 16 : kBytes;
  static constexpr int kN = kBytes / kWordBytes;
  using Word = typename std::conditional<
      kWordBytes == 16, int4,
      typename std::conditional<kWordBytes == 8, int2,
                                typename std::conditional<kWordBytes == 4, int, int16_t>::type>::type>::type;
};

// Load the lane's VPL values of one pixel's D-vector; entries d >= D get fill.
template <typename T, int VPL>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int D, int lane, int (&v)[VPL], int fill) {
  const int d0 = lane * VPL;
  if (d0 + VPL <= D && D % VPL == 0) {  // aligned vector access
    using W = Words<T, VPL>;
    typename W::Word w[W::kN];
#pragma unroll
    for (int i = 0; i < W::kN; ++i) w[i] = reinterpret_cast<const typename W::Word*>(p + d0)[i];
    const T* s = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int k = 0; k < VPL; ++k) v[k] = s[k];
  } else {
#pragma unroll
    for (int k = 0; k < VPL; ++k) v[k] = d0 + k < D ? p[d0 + k] : fill;
  }
}

template <typename T, int VPL>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int D, int lane, const int (&v)[VPL]) {
  const int d0 = lane * VPL;
  if (d0 + VPL <= D && D % VPL == 0) {
    using W = Words<T, VPL>;
    typename W::Word w[W::kN];
    T* s = reinterpret_cast<T*>(w);
#pragma unroll
    for (int k = 0; k < VPL; ++k) s[k] = static_cast<T>(v[k]);
#pragma unroll
    for (int i = 0; i < W::kN; ++i) reinterpret_cast<typename W::Word*>(p + d0)[i] = w[i];
  } else {
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (d0 + k < D) p[d0 + k] = static_cast<T>(v[k]);
  }
}

// Zero carry (the border rule): L = 0 for real d, sentinel for padding.
template <int VPL>
__device__ __forceinline__ void zero_carry(int D, int lane, int (&L)[VPL]) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) L[k] = lane * VPL + k < D ? 0 : kBig;
}

// One SGM step: L'[d] = c[d] + min(L[d], L[d-1]+P1, L[d+1]+P1, minL+P2) - minL.
// Returns min over d of L'. Padding entries of L' keep the sentinel.
template <int VPL>
__device__ __forceinline__ int sgm_step(const int (&c)[VPL], const int (&L)[VPL], int minL, int P1, int P2,
                                        int D, int lane, int (&Ln)[VPL]) {
  int below = __shfl_up_sync(kFullMask, L[VPL - 1], 1);  // L at d = lane*VPL - 1
  int above = __shfl_down_sync(kFullMask, L[0], 1);      // L at d = lane*VPL + VPL
  if (lane == 0) below = kBig;
  if (lane == 31) above = kBig;
  int m = kBig;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int Lm = k == 0 ? below : L[k - 1];
    const int Lp = k == VPL - 1 ? above : L[k + 1];
    const int cand = min(min(L[k], minL + P2), min(Lm, Lp) + P1);
    Ln[k] = lane * VPL + k < D ? c[k] + cand - minL : kBig;
    m = min(m, Ln[k]);
  }
  return warp_min(m);
}

// ------------------------------------------------ the vertical scans

// The cluster form (every vertical scan the register form below does not
// take). One thread block cluster per (frame, set): blockIdx.y = frame, blockIdx.z
// = set (0: the down set on rows 0..H-1; 1: the up set on rows H-1..0, the
// reference's y-flipped scan with the SAME column shifts), blockIdx.x = the
// block's rank in its cluster of CS blocks, which owns columns rank * SW ..
// rank * SW + SW - 1. Every block walks all H rows; a warp takes a column at
// a time (d over its lanes, VPL a lane, as the other scans). Its three
// carries (dir 0 vertical, 1 from x-1, 2 from x+1) of the previous row are
// read from a ping-pong pair of carry rows, [slot][dir][column][d], in the
// block's shared memory (or, where they do not fit, in a slot of device
// scratch), and those of the columns beside the strip from the neighbour
// blocks' (distributed shared memory). A row: the strip's two edge columns
// first, then barrier.cluster.arrive.release, the interior columns, the
// block barrier, and barrier.cluster.wait.acquire before the next row reads
// the neighbours' edge carries, so the interior columns hide the cluster
// barrier. A predecessor outside the frame, and every carry at the first
// row, is the zero carry.

__host__ __device__ constexpr int vertical_warps(int vpl) { return vpl <= 4 ? 32 : vpl == 8 ? 16 : 8; }

// The packed int16 step: a lane's VPL values as N = VPL / 2 words of two
// unsigned 16-bit halves (d = lane * VPL + 2w, + 1; D % VPL == 0, so lanes
// from lane_out = D / VPL on hold none, and their values are never stored,
// taken into the minimum or seen as a neighbour), every real value below
// kPackedOut (int16 storage of three carries bounds each by cost_bound + P2
// < 2^15 / 3, and minL + P2 by 2^15 * 2 / 3),
// and d >= D at kPackedOut, so that kPackedOut + P1 never wraps (P1 <=
// kPackedOut). L'[d] = c + min(L, L[d-1] + P1, L[d+1] + P1, minL + P2) - minL
// in four 16x2 operations a word, the neighbours by byte permutes and a
// shuffle at the lane's ends; returns min over d of L'.
constexpr unsigned kPackedOut = 0x7fffu;
constexpr unsigned kPackedOut2 = 0x7fff7fffu;

template <int N>
__device__ __forceinline__ int sgm_step_packed(const unsigned (&c)[N], const unsigned (&L)[N], int minL, int P1,
                                               int P2, int lane, int lane_out, unsigned (&Ln)[N]) {
  unsigned below = __shfl_up_sync(kFullMask, L[N - 1], 1);  // its high half: L at d = lane * VPL - 1
  unsigned above = __shfl_down_sync(kFullMask, L[0], 1);    // its low half: L at d = lane * VPL + VPL
  if (lane == 0) below = kPackedOut2;
  if (lane + 1 >= lane_out) above = kPackedOut2;  // lanes from lane_out on hold no disparity
  unsigned Lm[N + 1];  // Lm[w]: L at d - 1 of word w; Lm[w + 1] is L at d + 1 of word w
  Lm[0] = __byte_perm(below, L[0], 0x5432);
#pragma unroll
  for (int w = 1; w < N; ++w) Lm[w] = __byte_perm(L[w - 1], L[w], 0x5432);
  Lm[N] = __byte_perm(L[N - 1], above, 0x5432);
  const unsigned m2 = (unsigned)minL * 0x10001u, p1 = (unsigned)P1 * 0x10001u;
  const unsigned mp2 = (unsigned)(minL + P2) * 0x10001u;
  unsigned lo = 0xffffffffu;
#pragma unroll
  for (int w = 0; w < N; ++w) {
    const unsigned cand = __viaddmin_u16x2(__vminu2(Lm[w], Lm[w + 1]), p1, __vminu2(L[w], mp2));
    Ln[w] = __vadd2(__vsub2(cand, m2), c[w]);  // cand >= minL: no borrow
    lo = __vminu2(lo, Ln[w]);
  }
  return (int)__reduce_min_sync(kFullMask, lane < lane_out ? min(lo & 0xffffu, lo >> 16) : 0xffffffffu);
}

// A lane's N words of a D-vector of int16 at p (D % (2N) == 0); lanes past D
// read nothing and get `fill`.
template <int N>
__device__ __forceinline__ void load_words(const int16_t* p, int D, int lane, unsigned (&w)[N], unsigned fill) {
  if (lane * 2 * N >= D) {
#pragma unroll
    for (int k = 0; k < N; ++k) w[k] = fill;
  } else if constexpr (N == 1) {
    w[0] = reinterpret_cast<const unsigned*>(p)[lane];
  } else if constexpr (N == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(p)[lane];
    w[0] = v.x, w[1] = v.y;
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(p)[lane];
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_words(int16_t* p, int D, int lane, const unsigned (&w)[N]) {
  if (lane * 2 * N >= D) return;
  if constexpr (N == 1)
    reinterpret_cast<unsigned*>(p)[lane] = w[0];
  else if constexpr (N == 2)
    reinterpret_cast<uint2*>(p)[lane] = make_uint2(w[0], w[1]);
  else
    reinterpret_cast<uint4*>(p)[lane] = make_uint4(w[0], w[1], w[2], w[3]);
}

struct VerticalArgs {
  const void* C;
  void* s_dn;
  void* s_up;
  void* scratch;  // the carry rows of every block where they are not in shared memory
  int B, H, W, D, P1, P2, with_diag;
  int SW;  // columns a block
};

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Bytes of a block's carry rows (T [2][3][SW][D]) and their minima (int [2][3][SW]).
__host__ __device__ constexpr size_t carry_bytes(int SW, int D, int elem) {
  return round16((size_t)6 * SW * D * elem) + round16((size_t)6 * SW * 4);
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// kPacked: the packed int16 step (sgm_step_packed; int16, VPL 2, 4 or 8,
// D % VPL == 0, with diagonals); else the int32 step of the other scans.
// kSmem: the carry rows in shared memory (else in scratch), so that the
// compiler addresses this block's as shared memory.
template <typename T, int VPL, bool kPacked, bool kSmem>
__global__ void __launch_bounds__(vertical_warps(VPL) * 32)
vertical_cluster(VerticalArgs a) {
  static_assert(!kPacked || (std::is_same<T, int16_t>::value && VPL % 2 == 0 && VPL <= 8), "packed: int16, VPL 2-8");
  constexpr int N = kPacked ? VPL / 2 : VPL;  // registers a lane holds of a D-vector
  using Reg = typename std::conditional<kPacked, unsigned, int>::type;
  extern __shared__ __align__(16) unsigned char vsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), CS = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y, set = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, NW = blockDim.x >> 5;
  const int H = a.H, W = a.W, D = a.D, SW = a.SW;
  const int x0 = rank * SW, n = max(0, min(SW, W - x0));  // this block's columns
  const size_t cset = (size_t)6 * SW * D;
  const size_t region = carry_bytes(SW, D, sizeof(T));
  unsigned char* mine = kSmem ? vsm : static_cast<unsigned char*>(a.scratch) +
                                         ((size_t)(set * a.B + b) * CS + rank) * region;
  // The carry rows and minima of this block and of its neighbours.
  auto carries = [&](unsigned char* base) { return reinterpret_cast<T*>(base); };
  auto minima = [&](unsigned char* base) { return reinterpret_cast<int*>(base + round16(cset * sizeof(T))); };
  unsigned char* left = nullptr;
  unsigned char* right = nullptr;
  if (rank > 0) left = kSmem ? cluster.map_shared_rank(mine, rank - 1) : mine - region;
  if (rank + 1 < CS) right = kSmem ? cluster.map_shared_rank(mine, rank + 1) : mine + region;
  T* car = carries(mine);
  int* mins = minima(mine);

  const T* C = static_cast<const T*>(a.C) + (size_t)b * H * W * D;
  T* S = static_cast<T*>(set ? a.s_up : a.s_dn) + (size_t)b * H * W * D;
  const int ndir = a.with_diag ? 3 : 1;
  auto row_of = [&](int i) { return set == 0 ? i : H - 1 - i; };

  // Roles: with three warps or more, warp 0 takes the strip's first column
  // and warp 1 its last (the columns whose carries the neighbour blocks
  // read), the other warps the interior. The edge warps arrive at the
  // cluster barrier with release semantics once their carries are stored,
  // before their sums; the interior warps arrive relaxed, before their
  // columns, so that no arrival waits for the interior's stores to drain.
  const bool roles = NW >= 3;
  const bool edge_warp = roles && warp < 2;
  const int last = n - 1;
  // This warp's columns of a row: j0, j0 + dj, ... below j1.
  const int j0 = edge_warp ? (warp == 0 ? 0 : last > 0 ? last : n) : roles ? warp - 1 : warp;
  const int dj = edge_warp ? n : roles ? NW - 2 : NW;
  const int j1 = edge_warp ? n : roles ? last : n;

  // A lane's registers of a D-vector: packed words, or int32 values (entries
  // past D at `fill` / kBig).
  auto load = [&](const T* p, Reg (&r)[N], bool carry) {
    if constexpr (kPacked)
      load_words<N>(p, D, lane, r, carry ? kPackedOut2 : 0u);
    else
      load_vec<T, VPL>(p, D, lane, r, carry ? kBig : 0);
  };
  auto store = [&](T* p, const Reg (&r)[N]) {
    if constexpr (kPacked)
      store_words<N>(p, D, lane, r);
    else
      store_vec<T, VPL>(p, D, lane, r);
  };
  Reg pad[N];  // the zero carry: 0, and the padding's out-of-range value
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (kPacked)
      pad[k] = lane * VPL >= D ? kPackedOut2 : 0u;
    else
      pad[k] = lane * VPL + k < D ? 0 : kBig;
  }
  // The packed step's lanes: those past D hold no disparity (D % VPL == 0),
  // and the last that does sees the padding above it.
  const int lane_out = D / VPL;

  // Column j of row step i: its ndir carries from the previous row's (loads,
  // steps, stores, so that the steps' reductions overlap), their sum in acc.
  // Offsets are int elements from the row's bases (carries: [slot][dir][SW][D]).
  Reg acc[N];
  const int SWD = SW * D;
  const T* crow = nullptr;  // this row's costs of column 0 of the strip
  int prv3 = 0, cur3 = 0;   // the previous and this row's carry slot, times 3
  auto column = [&](int i, int j) {
    Reg c[N], L[3][N], Ln[3][N];
    int m[3], mn[3];
    const int jo = j * D;
    load(crow + jo, c, false);
#pragma unroll
    for (int dir = 0; dir < 3; ++dir) {
      if (dir >= ndir) break;
      const int dd = dir == 1 ? -1 : dir == 2 ? 1 : 0, pj = j + dd;  // the predecessor's column
      if (i == 0 || x0 + pj < 0 || x0 + pj >= W) {
#pragma unroll
        for (int k = 0; k < N; ++k) L[dir][k] = pad[k];
        m[dir] = 0;
      } else if (pj < 0 || pj >= SW) {  // a neighbour block's edge column
        unsigned char* base = pj < 0 ? left : right;
        const int col = pj < 0 ? SW - 1 : 0;
        load(carries(base) + (prv3 + dir) * SWD + col * D, L[dir], true);
        m[dir] = minima(base)[(prv3 + dir) * SW + col];
      } else {
        load(car + (prv3 + dir) * SWD + jo + dd * D, L[dir], true);
        m[dir] = mins[(prv3 + dir) * SW + pj];
      }
    }
#pragma unroll
    for (int dir = 0; dir < 3; ++dir) {
      if (dir >= ndir) break;
      if constexpr (kPacked)
        mn[dir] = sgm_step_packed<N>(c, L[dir], m[dir], a.P1, a.P2, lane, lane_out, Ln[dir]);
      else
        mn[dir] = sgm_step<VPL>(c, L[dir], m[dir], a.P1, a.P2, D, lane, Ln[dir]);
    }
#pragma unroll
    for (int dir = 0; dir < 3; ++dir) {
      if (dir >= ndir) break;
      store(car + (cur3 + dir) * SWD + jo, Ln[dir]);
      if (lane == 0) mins[(cur3 + dir) * SW + j] = mn[dir];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (kPacked)
        acc[k] = ndir == 3 ? __vadd2(Ln[0][k], __vadd2(Ln[1][k], Ln[2][k])) : Ln[0][k];
      else
        acc[k] = ndir == 3 ? Ln[0][k] + Ln[1][k] + Ln[2][k] : Ln[0][k];
    }
  };
  cluster.sync();  // every block of the cluster runs before any reads another's shared memory
  const bool diag = ndir == 3;
  const bool early = roles && !edge_warp;  // arrives before its columns
  for (int i = 0; i < H; ++i) {
    if (diag && early) cluster_arrive_relaxed();
    crow = C + ((size_t)row_of(i) * W + x0) * D;
    cur3 = (i & 1) * 3;
    prv3 = 3 - cur3;
    T* srow = S + ((size_t)row_of(i) * W + x0) * D;
    for (int j = j0; j < j1; j += dj) {
      column(i, j);
      if (edge_warp && diag) cluster_arrive();  // the edge carries are written
      store(srow + j * D, acc);
    }
    if (diag && !early && !edge_warp) cluster_arrive();  // one or two warps a block: after every column
    if (diag && edge_warp && j0 >= j1) cluster_arrive();  // an edge warp without a column
    __syncthreads();
    if (diag) cluster_wait();
  }
}

// ------------------------------------------------ the register form of #2

// vertical_cluster's register form: the packed int16 step with diagonals at
// D = 64 N (N = 1, 2, 4 words a lane, every lane's 2N values real). A
// cluster of CS blocks a (frame, set), one block an SM; warp g of the chain
// (block rank * NW + warp) owns columns g * CPW .. g * CPW + CPW - 1 (the
// last warps fewer or none) for the whole scan and keeps their three
// carries in registers, each as H = L - min L (so that no minimum is
// carried: L' = c + min(H, H[d-1] + P1, H[d+1] + P1, P2), H' = L' - min L').
// The only carries that leave a warp are its edges' (its last column's x-1
// carry, its first column's x+1 carry): at each row the warp pushes them
// with st.async into its neighbour warps' inboxes (shared memory, across
// blocks the cluster's), each inbox a ping-pong pair of slots whose
// mbarrier counts the bytes in. A row: wait for the neighbours' edges of
// the previous row, the warp's two edge columns, their st.async, then the
// interior columns, which hide the neighbours' latency. No fence orders the
// volume's stores and no barrier spans the cluster: a warp waits only for
// its two neighbours. The interior's costs are loaded a column ahead from
// L2, where the previous row prefetched them; the sums stream out
// evict-first. Every value a half holds is below 2^15 (int16 storage of
// three carries: c + P2 < 2^15 / 3), so the sums and differences of packed
// words are plain 32-bit adds with no carry between halves.
constexpr int kRegMaxCluster = 16;

// Threads a block of the register form may have at N words a lane and CPW
// columns a warp: the launch bound that leaves registers for the 3N x CPW
// words of carries a lane holds.
__host__ __device__ constexpr int reg_threads(int N, int CPW) {
  return 3 * N * CPW <= 72 ? 512 : 3 * N * CPW <= 108 ? 384 : 256;
}
// The columns a warp the form is built for: 1-12, 14 and 16 at one or two
// words a lane, 1-8 at four.
__host__ __device__ constexpr bool reg_built(int N, int CPW) {
  return CPW >= 1 && (N >= 4 ? CPW <= 8 : CPW <= 12 || CPW == 14 || CPW == 16);
}

// Shared-memory addresses (32-bit) and the mbarrier / st.async operations
// of the register form's edge exchange.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address in the cluster's shared window of `addr` in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Arrive on the mbarrier, expecting `bytes` of transactions for its phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the phase of the given parity has completed (acquire, cluster
// scope: the bytes came from other blocks' st.async).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, "
        "p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// A lane's N words into the cluster's shared memory at `addr`, completing
// their bytes on the mbarrier at `bar` (both in the receiver's block).
template <int N>
__device__ __forceinline__ void st_async(uint32_t addr, const unsigned (&w)[N], uint32_t bar) {
  if constexpr (N == 1)
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];" ::"r"(addr), "r"(w[0]),
                 "r"(bar)
                 : "memory");
  else if constexpr (N == 2)
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];" ::"r"(addr),
                 "r"(w[0]), "r"(w[1]), "r"(bar)
                 : "memory");
  else
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(
                     addr),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(bar)
                 : "memory");
}

// A lane's N words to device memory, evict-first (st.global.cs).
template <int N>
__device__ __forceinline__ void st_stream(int16_t* p, const unsigned (&w)[N]) {
  if constexpr (N == 1)
    __stcs(reinterpret_cast<unsigned*>(p), w[0]);
  else if constexpr (N == 2)
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
  else
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

// Bring the line at p into L2 (no register waits for it).
__device__ __forceinline__ void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// The register form's value beyond d = 0 and d = D - 1: at least P2 (int16
// storage of three carries keeps P2 < 2^15 / 3), so that no minimum takes
// it, and small enough that it + P1 + c never passes 16 bits.
constexpr unsigned kRegEdge = 10923;  // ceil(2^15 / 3)

// One normalized packed step from the predecessor's carry Hp over the
// costs c: L' (Ln, the real values, for the sum) and H' = L' - min L' (Hn).
// pc and p2c are P1 + c and P2 + c, halfword by halfword. The sentinel
// beyond the lane's edges is a halfword maximum rather than a predicate:
// edge_lo holds it in the high half on lane 0 (the value below d = 0; lane
// 0's shuffle returns its own word, whose halves are below the sentinel),
// edge_hi in the low half on lane 31 (the value above d = D - 1), zero
// elsewhere.
template <int N>
__device__ __forceinline__ void reg_step(const unsigned (&c)[N], const unsigned (&pc)[N], const unsigned (&p2c)[N],
                                         const unsigned (&Hp)[N], unsigned edge_lo, unsigned edge_hi,
                                         unsigned (&Ln)[N], unsigned (&Hn)[N]) {
  const unsigned below = __vmaxu2(__shfl_up_sync(kFullMask, Hp[N - 1], 1), edge_lo);  // high half: H at d - 1
  const unsigned above = __vmaxu2(__shfl_down_sync(kFullMask, Hp[0], 1), edge_hi);    // low half: H at d + 2N
  unsigned Hm[N + 1];  // Hm[w]: H at d - 1 of word w; Hm[w + 1]: H at d + 1
  Hm[0] = __byte_perm(below, Hp[0], 0x5432);
#pragma unroll
  for (int w = 1; w < N; ++w) Hm[w] = __byte_perm(Hp[w - 1], Hp[w], 0x5432);
  Hm[N] = __byte_perm(Hp[N - 1], above, 0x5432);
  unsigned lo = 0;
#pragma unroll
  for (int w = 0; w < N; ++w) {
    // c + min(H, H[d-1] + P1, H[d+1] + P1, P2) = min(min(H[d-1], H[d+1]) + P1 + c, min(H + c, P2 + c))
    Ln[w] = __viaddmin_u16x2(__vminu2(Hm[w], Hm[w + 1]), pc[w], __viaddmin_u16x2(Hp[w], c[w], p2c[w]));
    lo = w == 0 ? Ln[0] : __vminu2(lo, Ln[w]);
  }
  lo = __vminu2(lo, __byte_perm(lo, 0, 0x1032));  // both halves: the lane's minimum
  const unsigned m = __reduce_min_sync(kFullMask, lo);
#pragma unroll
  for (int w = 0; w < N; ++w) Hn[w] = Ln[w] - m;
}

struct RegArgs {
  const int16_t* C;
  int16_t* s_dn;
  int16_t* s_up;
  int H, W, P1, P2;
};

// A lane's N words of one carry, as one shared-memory access.
template <int N>
struct __align__(4 * N) RegVec {
  unsigned w[N];
};

template <int N, int CPW>
__global__ void __launch_bounds__(reg_threads(N, CPW), 1) vertical_cluster(const RegArgs a) {
  using V = RegVec<N>;
  extern __shared__ __align__(16) unsigned char vsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, set = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, NW = blockDim.x >> 5;
  const int H = a.H, W = a.W;
  constexpr int D = 64 * N;  // every lane holds 2N disparities
  // This warp's first column and its columns, through the warp's reduction
  // so that the compiler sees values the whole warp shares (its branches on
  // them then keep the warp converged).
  const int x0 = static_cast<int>(__reduce_min_sync(kFullMask, static_cast<unsigned>((rank * NW + warp) * CPW)));
  const int nv = max(0, min(CPW, W - x0));
  // This warp's inboxes, [slot][side][lane] words, side 0 from its left
  // neighbour (that warp's last column's x-1 carry), side 1 from its right
  // (its first column's x+1 carry), and their mbarriers [slot][side]: kBox
  // bytes a warp. A sender writes a row's edge into slot row & 1 of its
  // neighbour's inbox with st.async, which completes the transaction bytes
  // its receiver expects on the mbarrier beside it.
  constexpr int kData = 2 * 2 * 32 * (int)sizeof(V), kBox = kData + 4 * 8;
  const uint32_t box = smem_u32(vsm) + warp * kBox;
  const bool has_left = nv > 0 && x0 > 0, has_right = nv == CPW && x0 + CPW < W;
  if (lane == 0)
    for (int k = 0; k < 4; ++k) mbar_init(box + kData + 8 * k);
  fence_mbar_init();
  cluster.sync();  // every block's mbarriers are ready before any st.async
  // The left neighbour's side-1 inbox (slot 0) and mbarrier, the right's side-0.
  const int gl = rank * NW + warp - 1, gr = rank * NW + warp + 1;
  const uint32_t to_left = has_left ? map_rank(smem_u32(vsm) + (gl % NW) * kBox, gl / NW) : 0;
  const uint32_t to_right = has_right ? map_rank(smem_u32(vsm) + (gr % NW) * kBox, gr / NW) : 0;
  const uint32_t lane_off = lane * (uint32_t)sizeof(V);

  const unsigned edge_lo = lane == 0 ? kRegEdge << 16 : 0u, edge_hi = lane == 31 ? kRegEdge : 0u;
  const unsigned p1 = static_cast<unsigned>(a.P1) * 0x10001u, p2 = static_cast<unsigned>(a.P2) * 0x10001u;
  const long long rs = static_cast<long long>(W) * D;  // a row's values
  const long long start = ((long long)b * H + (set ? H - 1 : 0)) * rs + (long long)x0 * D;
  // A lane's words of column j at base + j * D.
  const int16_t* cp = a.C + start + lane * 2 * N;
  int16_t* sp = (set ? a.s_up : a.s_dn) + start + lane * 2 * N;
  const long long step = set ? -rs : rs;
  auto load = [&](const int16_t* p, unsigned (&w)[N]) {
    const V v = *reinterpret_cast<const V*>(p);
#pragma unroll
    for (int q = 0; q < N; ++q) w[q] = v.w[q];
  };

  unsigned H0[CPW][N], H1[CPW][N], H2[CPW][N];  // the carries, L - min L
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int w = 0; w < N; ++w) H0[j][w] = H1[j][w] = H2[j][w] = 0;
  // The costs of the two edge columns of the coming row; the interior's are
  // loaded a column ahead, from L2, where the row before prefetched them
  // (one row ahead: further, the prefetched rows and the stores crowd L2).
  unsigned ce0[N] = {}, ce1[N] = {};
  if (nv > 0) load(cp, ce0);
  if (nv == CPW && CPW > 1) load(cp + (CPW - 1) * D, ce1);

  // One row; kTail: a warp with fewer than CPW columns (its others stay the
  // zero carry, which is what a column past the frame gives).
  auto row = [&](int i, auto tail) {
    constexpr bool kTail = decltype(tail)::value;
    unsigned lb[N], rb[N];  // column x0 - 1's x-1 carry, column x0 + CPW's x+1 carry
#pragma unroll
    for (int w = 0; w < N; ++w) lb[w] = rb[w] = 0;
    if (i > 0) {  // the neighbours' edges of the previous row
      const uint32_t slot = ((i - 1) & 1) * (kData / 2), parity = ((i - 1) >> 1) & 1;
      if (has_left) {
        mbar_wait(box + kData + (((i - 1) & 1) * 2 + 0) * 8, parity);
        const V v = *reinterpret_cast<const V*>(vsm + warp * kBox + slot + lane_off);
#pragma unroll
        for (int w = 0; w < N; ++w) lb[w] = v.w[w];
      }
      if (has_right) {
        mbar_wait(box + kData + (((i - 1) & 1) * 2 + 1) * 8, parity);
        const V v = *reinterpret_cast<const V*>(vsm + warp * kBox + slot + 32 * sizeof(V) + lane_off);
#pragma unroll
        for (int w = 0; w < N; ++w) rb[w] = v.w[w];
      }
    }
    const bool more = i + 1 < H;
    if (more && lane == 0) {  // this row's edges from the neighbours, read at the next
      if (has_left) mbar_expect(box + kData + ((i & 1) * 2 + 0) * 8, 32 * sizeof(V));
      if (has_right) mbar_expect(box + kData + ((i & 1) * 2 + 1) * 8, 32 * sizeof(V));
    }
    unsigned N0[CPW][N], N1[CPW][N], N2[CPW][N];
    const int16_t* next = cp + (more ? step : 0);  // the last row's loads stay in its own
    auto column = [&](int j, const unsigned (&c)[N]) {
      if (kTail && j >= nv) {
#pragma unroll
        for (int w = 0; w < N; ++w) N0[j][w] = H0[j][w], N1[j][w] = H1[j][w], N2[j][w] = H2[j][w];
        return;
      }
      unsigned pc[N], p2c[N], in1[N], in2[N], L0[N], L1[N], L2[N];
#pragma unroll
      for (int w = 0; w < N; ++w) {
        pc[w] = p1 + c[w];
        p2c[w] = p2 + c[w];
        in1[w] = j == 0 ? lb[w] : H1[j > 0 ? j - 1 : 0][w];
        in2[w] = j == CPW - 1 ? rb[w] : H2[j < CPW - 1 ? j + 1 : j][w];
      }
      reg_step<N>(c, pc, p2c, H0[j], edge_lo, edge_hi, L0, N0[j]);
      reg_step<N>(c, pc, p2c, in1, edge_lo, edge_hi, L1, N1[j]);
      reg_step<N>(c, pc, p2c, in2, edge_lo, edge_hi, L2, N2[j]);
      V acc;
#pragma unroll
      for (int w = 0; w < N; ++w) acc.w[w] = L0[w] + L1[w] + L2[w];
      st_stream<N>(sp + j * D, acc.w);  // read by a later kernel, not from L2 by this one
      if (more) prefetch_l2(next + j * D);
    };
    unsigned cn[N] = {};  // the next interior column's costs
    if (CPW > 2 && (!kTail || nv > 1)) load(cp + D, cn);
    column(0, ce0);
    if (CPW > 1) column(CPW - 1, ce1);
    if (more) {  // the edges, into the neighbours' inboxes (slot i & 1)
      const uint32_t slot = (i & 1) * (kData / 2);
      if (has_right)
        st_async<N>(to_right + slot + lane_off, N1[CPW - 1], to_right + kData + ((i & 1) * 2 + 0) * 8);
      if (has_left)
        st_async<N>(to_left + slot + 32 * sizeof(V) + lane_off, N2[0], to_left + kData + ((i & 1) * 2 + 1) * 8);
    }
#pragma unroll
    for (int j = 1; j < CPW - 1; ++j) {
      unsigned c[N];
#pragma unroll
      for (int w = 0; w < N; ++w) c[w] = cn[w];
      if (j + 1 < CPW - 1 && (!kTail || j + 1 < nv)) load(cp + (j + 1) * D, cn);
      column(j, c);
    }
    if (!kTail || nv > 0) load(next, ce0);
    if (CPW > 1 && !kTail) load(next + (CPW - 1) * D, ce1);
#pragma unroll
    for (int j = 0; j < CPW; ++j)
#pragma unroll
      for (int w = 0; w < N; ++w) H0[j][w] = N0[j][w], H1[j][w] = N1[j][w], H2[j][w] = N2[j][w];
    cp += step;
    sp += step;
  };
  if (nv == CPW) {
#pragma unroll 1
    for (int i = 0; i < H; ++i) row(i, std::false_type{});
  } else {
#pragma unroll 1
    for (int i = 0; i < H; ++i) row(i, std::true_type{});
  }
  cluster.sync();  // no block leaves while a neighbour's st.async may be under way
}

// One warp per (frame, row): the L->R (reverse: R->L) scan over W columns.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
horizontal_scan(const T* __restrict__ C, T* __restrict__ out, int rows, int W, int D, int P1,
                int P2, int reverse) {
  const int lane = threadIdx.x & 31;
  const int rid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rid >= rows) return;  // whole warp
  const T* crow = C + (size_t)rid * W * D;
  T* orow = out + (size_t)rid * W * D;
  int L[VPL], c[VPL], cn[VPL];
  zero_carry<VPL>(D, lane, L);
  int m = 0;
  load_vec<T, VPL>(crow + (size_t)(reverse ? W - 1 : 0) * D, D, lane, cn, 0);
  for (int t = 0; t < W; ++t) {
    const int x = reverse ? W - 1 - t : t;
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = cn[k];
    if (t + 1 < W) load_vec<T, VPL>(crow + (size_t)(reverse ? x - 1 : x + 1) * D, D, lane, cn, 0);
    int Ln[VPL];
    m = sgm_step<VPL>(c, L, m, P1, P2, D, lane, Ln);
    store_vec<T, VPL>(orow + (size_t)x * D, D, lane, Ln);
#pragma unroll
    for (int k = 0; k < VPL; ++k) L[k] = Ln[k];
  }
}

// The WTA reduction of one pixel's aggregated vector S (entries d >= D hold
// kBig): min, argmin (ties -> smallest d), the uniqueness verdict and S at
// d0-1, d0, d0+1 with d0 = clip(best, 1, D-2); lane 0 writes them at p.
template <int VPL>
__device__ __forceinline__ void wta_store(const int (&S)[VPL], int D, int lane, int uniq, long long p,
                                          int* __restrict__ minS, int* __restrict__ best, int* __restrict__ sm,
                                          int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok) {
  int m = kBig;
#pragma unroll
  for (int k = 0; k < VPL; ++k) m = min(m, S[k]);
  const int mn = warp_min(m);
  int bl = D;
#pragma unroll
  for (int k = VPL - 1; k >= 0; --k)
    if (S[k] == mn) bl = lane * VPL + k;  // padding holds kBig > mn
  const int bst = warp_min(bl);
  bool offend = false;
  if (uniq > 0) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int d = lane * VPL + k;
      offend |= d < D && abs(d - bst) > 1 && mn * (100 + uniq) > S[k] * 100;
    }
  }
  const bool ok = !__any_sync(kFullMask, offend);
  const int d0 = min(max(bst, 1), D - 2);
  int a = 0, z = 0, c = 0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int d = lane * VPL + k;
    a += d == d0 - 1 ? S[k] : 0;
    z += d == d0 ? S[k] : 0;
    c += d == d0 + 1 ? S[k] : 0;
  }
  a = warp_sum(a);
  z = warp_sum(z);
  c = warp_sum(c);
  if (lane == 0) {
    minS[p] = mn;
    best[p] = bst;
    sm[p] = a;
    s0[p] = z;
    sp[p] = c;
    uok[p] = ok ? 1 : 0;
  }
}

// One warp per pixel: S = sum of nvol volumes, then wta_store.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
wta_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
           const T* __restrict__ v3, int nvol, int* __restrict__ minS, int* __restrict__ best,
           int* __restrict__ sm, int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok,
           long long npix, int D, int uniq) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // whole warp
  const size_t base = (size_t)p * D;
  const T* vols[4] = {v0, v1, v2, v3};
  int S[VPL], t[VPL];
  load_vec<T, VPL>(vols[0] + base, D, lane, S, kBig);
  for (int j = 1; j < nvol; ++j) {
    load_vec<T, VPL>(vols[j] + base, D, lane, t, 0);
#pragma unroll
    for (int k = 0; k < VPL; ++k) S[k] += t[k];
  }
  wta_store<VPL>(S, D, lane, uniq, p, minS, best, sm, s0, sp, uok);
}

// One warp per pixel of one aggregated int32 volume.
template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
wta_stats_kernel(const int* __restrict__ S, int* __restrict__ minS, int* __restrict__ best, int* __restrict__ sm,
                 int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok, long long npix, int D,
                 int uniq) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // whole warp
  int v[VPL];
  load_vec<int, VPL>(S + (size_t)p * D, D, lane, v, kBig);
  wta_store<VPL>(v, D, lane, uniq, p, minS, best, sm, s0, sp, uok);
}

// ------------------------------------------------ the fused R->L scan + WTA

// horizontal_rl_wta (#5): the R->L scan of one (frame, row) fused with the
// WTA over four directions. At each column x the scan's own L plus the three
// stored direction volumes is the aggregated vector S; its min, argmin, the
// uniqueness verdict and the three samples are the six maps of wta_kernel,
// and the R->L volume is never stored.
//
// What bounds it on an H100 (exact8: 4 frames, 720 rows of 1152 columns,
// D=128, int16): bytes, the cost and three volumes read once (3.4 GB,
// ~1.0 ms at 3.35 TB/s), over 2,880 serial chains of 1,152 column steps,
// about 22 warps an SM. The first design (a warp a row, only the next
// column's cost loaded ahead, the three volume loads of a column waited for
// inside its step, the WTA's ~26 dependent shuffles between two steps) took
// 2.4 us a column step, 2.7x the bound.
//
// Design (redesigned for Hopper), the ring form. The chain stays a warp a
// row, so at exact8 each scheduler holds ~6 warps and the kernel is bound
// by the instructions it issues a column step (~290 in the first ring
// form; cuobjdump of the int16, D=128 form), then by the bytes:
//  - each column's cost and three volumes are copied into a ring of
//    rl_ring columns in shared memory (cp.async, a copy group a column,
//    rl_ring - 1 ahead of the scan), so that a step never waits for device
//    memory; where a lane's words are under 16 bytes and a column's a
//    multiple of 16, the warp copies the column in 16-byte chunks
//    (cp.async.cg, at most two a lane) and reads it after a __syncwarp;
//  - the WTA of column x + 1 is issued beside the scan step of column x (the
//    carry is L and the step's minimum; nothing on it reads S); every
//    reduction over the warp is one redux.sync or vote in place of a 5-step
//    shuffle tree;
//  - lane j keeps the maps of the columns x with x % 32 == j, and the warp
//    writes 32 consecutive pixels of each map at once; a lane past D reads
//    zeros from its never-copied words (no predicate on the reads).
// At exact8 the ring is 2 columns and a block 8 rows. Measured with
// tools/kernel_variants/sgm_rl_wta.py and dropped: rings of 4 and 8 columns
// (6% and 12% slower), 2 and 4 rows a block (1-2%), each lane copying its
// own 8 bytes (cp.async.ca, 2%), the WTA after the next step in program
// order (1%), and, in the first ring form, the inactive lanes' predicated
// reads and a branching uniqueness test (~90 instructions a step
// together). Min and argmin as one packed key at int16 gained about 1%,
// inside the spread between runs, and went too. A ring slot holds 4 x 32 x VPL
// values of T (a column); the ring is sized from VPL and T (rl_ring: about
// kRlRingBytes a row, 2 to 8 columns) and a block holds at most
// kRlBlockBytes of rings (rl_rows), so that one rule covers every register
// form, VPL 1-32, int16 and int32.
// The direct form takes what the ring cannot copy whole (D % VPL != 0, or
// two bytes a lane): its lanes load device memory themselves, the cost one
// column ahead; it shares the step and the WTA. Every tensor lies on 16
// bytes (the entry refuses others).
constexpr int kRlRingBytes = 2048;       // ring bytes a row, about
constexpr int kRlBlockBytes = 64 << 10;  // ring bytes a block, at most
constexpr int kRlRows = 8;               // rows (warps) a block of the ring form, at most

template <typename T, int VPL>
__host__ __device__ constexpr int rl_slot_bytes() {
  return 4 * 32 * VPL * (int)sizeof(T);
}
template <typename T, int VPL>
__host__ __device__ constexpr int rl_ring() {
  const int r = kRlRingBytes / rl_slot_bytes<T, VPL>();
  return r > 8 ? 8 : r < 2 ? 2 : r;
}
template <typename T, int VPL>
__host__ __device__ constexpr int rl_rows() {
  const int n = kRlBlockBytes / (rl_ring<T, VPL>() * rl_slot_bytes<T, VPL>());
  return n > kRlRows ? kRlRows : n;
}

struct RlArgs {
  const void* C;
  const void* v[3];
  int rows, W, D, P1, P2, uniq;
  int* maps[5];  // minS, best, sm, s0, sp
  uint8_t* uok;
};

// The lane's VPL values of T at p (shared memory, whole words).
template <typename T, int VPL>
__device__ __forceinline__ void read_words(const T* p, int (&v)[VPL]) {
  using Wd = Words<T, VPL>;
  typename Wd::Word w[Wd::kN];
#pragma unroll
  for (int i = 0; i < Wd::kN; ++i) w[i] = reinterpret_cast<const typename Wd::Word*>(p)[i];
  const T* s = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int k = 0; k < VPL; ++k) v[k] = s[k];
}

// sgm_step with the minimum over the warp as one redux.sync; L becomes L'.
template <int VPL>
__device__ __forceinline__ int rl_step(const int (&c)[VPL], int (&L)[VPL], int minL, int P1, int P2, int D,
                                       int lane) {
  int below = __shfl_up_sync(kFullMask, L[VPL - 1], 1);  // L at d = lane*VPL - 1
  int above = __shfl_down_sync(kFullMask, L[0], 1);      // L at d = lane*VPL + VPL
  if (lane == 0) below = kBig;
  if (lane == 31) above = kBig;
  int Ln[VPL], m = kBig;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int Lm = k == 0 ? below : L[k - 1];
    const int Lp = k == VPL - 1 ? above : L[k + 1];
    const int cand = min(min(L[k], minL + P2), min(Lm, Lp) + P1);
    Ln[k] = lane * VPL + k < D ? c[k] + cand - minL : kBig;
    m = min(m, Ln[k]);
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) L[k] = Ln[k];
  return __reduce_min_sync(kFullMask, m);
}

// The six maps of one column (warp-uniform) from its S, whose entries d >= D
// hold INT_MAX: no minimum takes them from a real entry (ties go to the
// smaller d) and no uniqueness test reads them.
struct RlStats {
  int mn, best, a, z, c;
  bool ok;
};

// The uniqueness test is the reference's, lane by lane, its products
// wrapping as the reference's int32 ones do.
template <int VPL>
__device__ __forceinline__ RlStats rl_reduce(const int (&S)[VPL], int D, int lane, int uniq) {
  int lm = S[0];
#pragma unroll
  for (int k = 1; k < VPL; ++k) lm = min(lm, S[k]);
  const int mn = __reduce_min_sync(kFullMask, lm);
  int bl = INT_MAX;
#pragma unroll
  for (int k = VPL - 1; k >= 0; --k)
    if (S[k] == mn) bl = lane * VPL + k;
  const int bst = __reduce_min_sync(kFullMask, bl);
  bool ok = true;
  if (uniq > 0) {
    const int lim = (int)((unsigned)mn * (unsigned)(100 + uniq));
    bool offend = false;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int d = lane * VPL + k;
      offend |= (d < D) & (abs(d - bst) > 1) & (lim > (int)((unsigned)S[k] * 100u));
    }
    ok = !__any_sync(kFullMask, offend);
  }
  const int d0 = min(max(bst, 1), D - 2);
  int a = 0, z = 0, c = 0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int d = lane * VPL + k;
    a = d == d0 - 1 ? S[k] : a;
    z = d == d0 ? S[k] : z;
    c = d == d0 + 1 ? S[k] : c;
  }
  return {mn, bst, __reduce_add_sync(kFullMask, a), __reduce_add_sync(kFullMask, z),
          __reduce_add_sync(kFullMask, c), ok};
}

template <typename T, int VPL, bool kRing>
__global__ void __launch_bounds__(kWarps * 32) horizontal_rl_wta(const RlArgs a) {
  extern __shared__ __align__(16) unsigned char rl_smem[];
  constexpr int R = rl_ring<T, VPL>(), kLane = VPL * (int)sizeof(T), kSlot = rl_slot_bytes<T, VPL>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rid = blockIdx.x * (blockDim.x >> 5) + warp;
  if (rid >= a.rows) return;  // whole warp
  const int W = a.W, D = a.D;
  const size_t row = (size_t)rid * W * D, col = (size_t)D * sizeof(T);
  const T* src[4] = {static_cast<const T*>(a.C) + row, static_cast<const T*>(a.v[0]) + row,
                     static_cast<const T*>(a.v[1]) + row, static_cast<const T*>(a.v[2]) + row};
  // The ring form's slots: [warp][slot][input][lane][VPL] of T; D % VPL == 0
  // there, so a lane holds VPL disparities or none. Where a lane's words are
  // under 16 bytes and a column's are a multiple of 16, the warp copies the
  // column's 4 x D values in 16-byte chunks (at most two a lane, cp.async.cg)
  // and reads them after a __syncwarp; else each lane copies its own words.
  unsigned char* ring = rl_smem + (size_t)warp * R * kSlot;
  const bool active = lane * VPL < D;
  if (kRing && !active) {  // a lane past D reads zeros (its words are never copied)
#pragma unroll 1
    for (int o = 0; o < R * 4; ++o)
#pragma unroll
      for (int b = 0; b < kLane; b += 4) *reinterpret_cast<int*>(ring + o * 32 * kLane + lane * kLane + b) = 0;
  }
  const bool coop = kLane < 16 && col % 16 == 0;
  const unsigned char* chunk_src[2] = {nullptr, nullptr};
  int chunk_dst[2] = {-1, -1};
  if (coop) {
    const int nc = (int)(col / 16);  // chunks an input
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = lane + 32 * i, j = f / nc;
      if (j < 4) {
        chunk_src[i] = reinterpret_cast<const unsigned char*>(src[j]) + (f - j * nc) * 16;
        chunk_dst[i] = j * 32 * kLane + (f - j * nc) * 16;
      }
    }
  }
  // Column x's bytes as one copy group (an empty one past the row's start
  // keeps the count).
  auto fetch = [&](int x) {
    if (x >= 0) {
      unsigned char* s = ring + (x & (R - 1)) * kSlot;
      const size_t gx = (size_t)x * col;
      if (coop) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (chunk_dst[i] >= 0) svt::cp_async(s + chunk_dst[i], chunk_src[i] + gx, 16);
      } else if (active) {
        constexpr int kUnit = kLane < 16 ? kLane : 16;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          auto g = reinterpret_cast<const unsigned char*>(src[j]) + gx + lane * kLane;
#pragma unroll
          for (int o = 0; o < kLane; o += kUnit) svt::cp_async(s + j * 32 * kLane + lane * kLane + o, g + o, kUnit);
        }
      }
    }
    svt::cp_async_commit();
  };

  int L[VPL], cn[VPL];
  zero_carry<VPL>(D, lane, L);
  int m = 0;
  if constexpr (kRing) {
#pragma unroll 1
    for (int i = 1; i < R; ++i) fetch(W - i);
  } else {
    load_vec<T, VPL>(src[0] + (size_t)(W - 1) * D, D, lane, cn, 0);
  }
  // Column x: the scan step, then S = L + the three volumes (INT_MAX past D).
  auto advance = [&](int x, int (&S)[VPL]) {
    int c[VPL], v[3][VPL];
    if constexpr (kRing) {
      fetch(x - (R - 1));
      svt::cp_async_wait_ring(R);  // column x has landed
      if (coop) __syncwarp();      // ... every lane's part of it
      const unsigned char* s = ring + (x & (R - 1)) * kSlot + lane * kLane;
      read_words<T, VPL>(reinterpret_cast<const T*>(s), c);
#pragma unroll
      for (int j = 0; j < 3; ++j) read_words<T, VPL>(reinterpret_cast<const T*>(s + (j + 1) * 32 * kLane), v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < VPL; ++k) c[k] = cn[k];
      if (x > 0) load_vec<T, VPL>(src[0] + (size_t)(x - 1) * D, D, lane, cn, 0);
#pragma unroll
      for (int j = 0; j < 3; ++j) load_vec<T, VPL>(src[j + 1] + (size_t)x * D, D, lane, v[j], 0);
    }
    m = rl_step<VPL>(c, L, m, a.P1, a.P2, D, lane);
#pragma unroll
    for (int k = 0; k < VPL; ++k) S[k] = lane * VPL + k < D ? L[k] + v[0][k] + v[1][k] + v[2][k] : INT_MAX;
  };
  // Column x's maps, kept by lane x % 32; the warp writes 32 columns at once.
  int r0 = 0, r1 = 0, r2 = 0, r3 = 0, r4 = 0;
  uint8_t r5 = 0;
  auto reduce = [&](const int (&S)[VPL], int x) {
    const RlStats s = rl_reduce<VPL>(S, D, lane, a.uniq);
    if (lane == (x & 31)) r0 = s.mn, r1 = s.best, r2 = s.a, r3 = s.z, r4 = s.c, r5 = s.ok ? 1 : 0;
    if ((x & 31) == 0 && x + lane < W) {
      const size_t p = (size_t)rid * W + x + lane;
      a.maps[0][p] = r0;
      a.maps[1][p] = r1;
      a.maps[2][p] = r2;
      a.maps[3][p] = r3;
      a.maps[4][p] = r4;
      a.uok[p] = r5;
    }
  };

  // The WTA of column x + 1 is issued before the scan step of column x: the
  // two are independent (the carry is L and m), and the step's loads and
  // shuffles then wait behind the WTA's reductions rather than ahead of them.
  int S[VPL];
  advance(W - 1, S);
#pragma unroll 1
  for (int x = W - 2; x >= 0; --x) {
    int Sn[VPL];
    reduce(S, x + 1);
    advance(x, Sn);
#pragma unroll
    for (int k = 0; k < VPL; ++k) S[k] = Sn[k];
  }
  reduce(S, 0);
}

// ------------------------------------------------ ranges above 1024

// The forms above 1024 disparities: one warp a pixel (or a row), walking
// d = lane, lane + 32, ... with wide_sgm_step / wide_wta. A carry is read
// back from the volume it was stored to (the horizontal scans: the previous
// column's; the vertical step: Lin), or from a ping-pong pair of rows of
// scratch (the fused R->L WTA, whose own volume is never stored).

// The vertical scans above 1024: one launch a row step (row i of the down
// set, row H-1-i of the up set), the carries ping-ponged through device
// memory, [slot][set * 3 + dir][b][x][d].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
vertical_step_wide(const T* __restrict__ C, T* __restrict__ s_dn, T* __restrict__ s_up, const T* __restrict__ Lin,
                   T* __restrict__ Lout, const int* __restrict__ min_in, int* __restrict__ min_out, int B, int H,
                   int W, int D, int P1, int P2, int with_diag, int i) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y, set = blockIdx.z;
  if (x >= W) return;  // whole warp
  const int row = set == 0 ? i : H - 1 - i;
  const size_t pix = ((size_t)b * H + row) * W + x;
  const T* cp = C + pix * D;
  T* acc = (set == 0 ? s_dn : s_up) + pix * D;
  const int ndir = with_diag ? 3 : 1;
  for (int dir = 0; dir < ndir; ++dir) {
    const int px = x - (dir == 1) + (dir == 2);
    const size_t slot = ((size_t)(set * 3 + dir) * B + b) * W;
    const bool zero = i == 0 || px < 0 || px >= W;
    T* lo = Lout + (slot + x) * D;
    const int mn = svt::wide_sgm_step<T>(
        zero ? nullptr : Lin + (slot + px) * D, zero ? 0 : min_in[slot + px],
        [&](int d) { return static_cast<int>(cp[d]); },
        [&](int d, int v) {
          lo[d] = static_cast<T>(v);
          acc[d] = static_cast<T>(dir == 0 ? v : static_cast<int>(acc[d]) + v);
        },
        D, P1, P2, lane);
    if (lane == 0) min_out[slot + x] = mn;
  }
}

// horizontal_scan above 1024: the carry is the previous column's stored L.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
horizontal_scan_wide(const T* __restrict__ C, T* __restrict__ out, int rows, int W, int D, int P1, int P2,
                     int reverse) {
  const int lane = threadIdx.x & 31;
  const int rid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rid >= rows) return;  // whole warp
  const T* crow = C + (size_t)rid * W * D;
  T* orow = out + (size_t)rid * W * D;
  int m = 0;
  for (int t = 0; t < W; ++t) {
    const int x = reverse ? W - 1 - t : t;
    const T* cp = crow + (size_t)x * D;
    T* op = orow + (size_t)x * D;
    m = svt::wide_sgm_step<T>(
        t == 0 ? nullptr : orow + (size_t)(reverse ? x + 1 : x - 1) * D, m,
        [&](int d) { return static_cast<int>(cp[d]); }, [&](int d, int v) { op[d] = static_cast<T>(v); }, D, P1,
        P2, lane);
    __syncwarp();  // the column's L, stored by every lane, is the next step's carry
  }
}

// The six maps of one pixel from its statistics (lane 0 writes).
__device__ __forceinline__ void store_stats(const svt::WideStats& w, int lane, long long p, int* __restrict__ minS,
                                            int* __restrict__ best, int* __restrict__ sm, int* __restrict__ s0,
                                            int* __restrict__ sp, uint8_t* __restrict__ uok) {
  if (lane == 0) {
    minS[p] = w.mn;
    best[p] = w.best;
    sm[p] = w.sm;
    s0[p] = w.s0;
    sp[p] = w.sp;
    uok[p] = w.ok ? 1 : 0;
  }
}

// wta_kernel above 1024.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
wta_wide_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                const T* __restrict__ v3, int nvol, int* __restrict__ minS, int* __restrict__ best,
                int* __restrict__ sm, int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok,
                long long npix, int D, int uniq) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // whole warp
  const size_t base = (size_t)p * D;
  const T* vols[4] = {v0, v1, v2, v3};
  auto S = [&](int d) {
    int s = 0;
    for (int j = 0; j < nvol; ++j) s += static_cast<int>(vols[j][base + d]);
    return s;
  };
  store_stats(svt::wide_wta(S, D, uniq, lane), lane, p, minS, best, sm, s0, sp, uok);
}

// wta_stats_kernel above 1024.
__global__ void __launch_bounds__(kWarps * 32)
wta_stats_wide_kernel(const int* __restrict__ S, int* __restrict__ minS, int* __restrict__ best,
                      int* __restrict__ sm, int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok,
                      long long npix, int D, int uniq) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // whole warp
  const int* v = S + (size_t)p * D;
  store_stats(svt::wide_wta([&](int d) { return v[d]; }, D, uniq, lane), lane, p, minS, best, sm, s0, sp, uok);
}

// horizontal_rl_wta above 1024: the R->L carry goes through rows (t & 1) of
// Lbuf, [2][rows][D] of T; at each column the WTA reads it back with the
// three stored volumes.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
horizontal_rl_wta_wide(const T* __restrict__ C, const T* __restrict__ v0, const T* __restrict__ v1,
                       const T* __restrict__ v2, T* __restrict__ Lbuf, int rows, int W, int D, int P1, int P2,
                       int uniq, int* __restrict__ minS, int* __restrict__ best, int* __restrict__ sm,
                       int* __restrict__ s0, int* __restrict__ sp, uint8_t* __restrict__ uok) {
  const int lane = threadIdx.x & 31;
  const int rid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rid >= rows) return;  // whole warp
  const T* crow = C + (size_t)rid * W * D;
  int m = 0;
  for (int t = 0; t < W; ++t) {
    const int x = W - 1 - t;
    const T* cp = crow + (size_t)x * D;
    T* cur = Lbuf + ((size_t)(t & 1) * rows + rid) * D;
    const T* prev = t == 0 ? nullptr : Lbuf + ((size_t)((t + 1) & 1) * rows + rid) * D;
    m = svt::wide_sgm_step<T>(
        prev, m, [&](int d) { return static_cast<int>(cp[d]); }, [&](int d, int v) { cur[d] = static_cast<T>(v); },
        D, P1, P2, lane);
    __syncwarp();  // cur, stored by every lane, is read back below and carried
    const long long p = (long long)rid * W + x;
    const size_t base = (size_t)p * D;
    auto S = [&](int d) {
      return static_cast<int>(cur[d]) + static_cast<int>(v0[base + d]) + static_cast<int>(v1[base + d]) +
             static_cast<int>(v2[base + d]);
    };
    store_stats(svt::wide_wta(S, D, uniq, lane), lane, p, minS, best, sm, s0, sp, uok);
  }
}

// The launches of the forms above 1024, for the storage type T.
template <typename T>
struct Wide {
  static cudaError_t vertical(const void* C, void* dn, void* up, void* L, void* m, int B, int H, int W, int D, int P1,
                              int P2, int with_diag, cudaStream_t st) {
    const size_t lset = (size_t)6 * B * W * D, mset = (size_t)6 * B * W;
    const dim3 grid((W + kWarps - 1) / kWarps, B, 2);
    T* Lb = static_cast<T*>(L);
    int* mb = static_cast<int*>(m);
    for (int i = 0; i < H; ++i) {
      const int src = (i + 1) & 1, dst = i & 1;
      vertical_step_wide<T><<<grid, kWarps * 32, 0, st>>>(static_cast<const T*>(C), static_cast<T*>(dn),
                                                         static_cast<T*>(up), Lb + src * lset, Lb + dst * lset,
                                                         mb + src * mset, mb + dst * mset, B, H, W, D, P1, P2,
                                                         with_diag, i);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
  static cudaError_t horizontal(const void* C, void* out, int rows, int W, int D, int P1, int P2, int reverse,
                                cudaStream_t st) {
    horizontal_scan_wide<T><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        static_cast<const T*>(C), static_cast<T*>(out), rows, W, D, P1, P2, reverse);
    return cudaGetLastError();
  }
  static cudaError_t wta(const void* const* v, int nvol, int* const* maps, uint8_t* uok, int npix, int D, int uniq,
                         cudaStream_t st) {
    wta_wide_kernel<T><<<(npix + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        static_cast<const T*>(v[0]), static_cast<const T*>(v[1]), static_cast<const T*>(v[2]),
        static_cast<const T*>(v[3]), nvol, maps[0], maps[1], maps[2], maps[3], maps[4], uok, npix, D, uniq);
    return cudaGetLastError();
  }
  static cudaError_t rl_wta(const void* C, const void* const* v, void* Lbuf, int rows, int W, int D, int P1, int P2,
                            int uniq, int* const* maps, uint8_t* uok, cudaStream_t st) {
    horizontal_rl_wta_wide<T><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        static_cast<const T*>(C), static_cast<const T*>(v[0]), static_cast<const T*>(v[1]),
        static_cast<const T*>(v[2]), static_cast<T*>(Lbuf), rows, W, D, P1, P2, uniq, maps[0], maps[1], maps[2],
        maps[3], maps[4], uok);
    return cudaGetLastError();
  }
};

// The widest range the register forms take; above it, the forms of Wide.
constexpr int kRegisterRange = 1024;

template <typename T, int VPL>
cudaError_t horizontal(const T* C, T* out, int rows, int W, int D, int P1, int P2, int reverse,
                       cudaStream_t stream) {
  horizontal_scan<T, VPL><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(C, out, rows, W, D, P1, P2,
                                                                                    reverse);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t wta(const T* const* v, int nvol, int* const* maps, uint8_t* uok, int npix, int D, int uniq,
                cudaStream_t stream) {
  wta_kernel<T, VPL><<<(npix + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      v[0], v[1], v[2], v[3], nvol, maps[0], maps[1], maps[2], maps[3], maps[4], uok, npix, D, uniq);
  return cudaGetLastError();
}

template <int VPL>
cudaError_t wta_stats(const int* S, int* const* maps, uint8_t* uok, long long npix, int D, int uniq,
                      cudaStream_t stream) {
  wta_stats_kernel<VPL><<<(npix + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      S, maps[0], maps[1], maps[2], maps[3], maps[4], uok, npix, D, uniq);
  return cudaGetLastError();
}

// Values per lane for D disparities: 1, 2, 4, 8, 16 or 32 (D <= 1024).
int vpl_for(int D) { return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : D <= 256 ? 8 : D <= 512 ? 16 : 32; }

// fn<T, VPL>() for the storage type of `bytes` (2: int16, 4: int32) and D's
// values per lane; cudaErrorInvalidValue for another width.
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int bytes, int D, Args... args) {
  const int vpl = vpl_for(D);
  if (bytes == 2) {
    switch (vpl) {
      case 1: return Fn<int16_t, 1>::run(args...);
      case 2: return Fn<int16_t, 2>::run(args...);
      case 4: return Fn<int16_t, 4>::run(args...);
      case 8: return Fn<int16_t, 8>::run(args...);
      case 16: return Fn<int16_t, 16>::run(args...);
      default: return Fn<int16_t, 32>::run(args...);
    }
  }
  if (bytes == 4) {
    switch (vpl) {
      case 1: return Fn<int, 1>::run(args...);
      case 2: return Fn<int, 2>::run(args...);
      case 4: return Fn<int, 4>::run(args...);
      case 8: return Fn<int, 8>::run(args...);
      case 16: return Fn<int, 16>::run(args...);
      default: return Fn<int, 32>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

// The vertical scans' launch geometry: the cluster size CS (16, 8, 4, 2 or
// 1 blocks, at most W), SW = ceil(W / CS) columns a block, NW warps a block,
// whether the carry rows are in shared memory, the clusters the card holds
// at once, the shared-memory and scratch bytes, and the device launches of
// the call.
struct VerticalPlan {
  long long CS, SW, NW, smem_carry, active, smem, scratch, launches;
};

cudaLaunchConfig_t cluster_config(int CS, int B, int NW, size_t smem, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, B, 2);
  cfg.blockDim = dim3(32 * NW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster kernel a call runs: the packed int16 step where it applies,
// the carries where the plan put them.
template <typename T, int VPL>
auto vertical_kernel(int D, int P1, int with_diag, bool smem) {
  constexpr bool kPackable = std::is_same<T, int16_t>::value && (VPL == 2 || VPL == 4 || VPL == 8);
  if constexpr (kPackable) {
    // Where int16 storage holds three carries every value is below 2^15 / 3,
    // so minL + P2 < 2^15 too.
    if (with_diag && D % VPL == 0 && P1 <= (int)kPackedOut)
      return smem ? vertical_cluster<T, VPL, true, true> : vertical_cluster<T, VPL, true, false>;
  }
  return smem ? vertical_cluster<T, VPL, false, true> : vertical_cluster<T, VPL, false, false>;
}

// Of the cluster sizes (the carry rows in shared memory where they fit a
// block, else in scratch), the one with the least work a block times waves
// of clusters (2B clusters, `active` at once; x2 with the carries in
// scratch), then the fewest waves.
template <typename T, int VPL>
struct VerticalPlanFn {
  static cudaError_t run(int B, int W, int D, VerticalPlan* out) {
    const auto kern = vertical_cluster<T, VPL, false, true>;  // the other forms have the same shape
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    *out = {};
    long long best = -1;
    for (int cs : {16, 8, 4, 2, 1}) {
      if (cs > 1 && cs > W) continue;
      const int sw = (W + cs - 1) / cs, nw = std::min(vertical_warps(VPL), sw);
      const size_t carry = carry_bytes(sw, D, sizeof(T));
      const bool smem = carry <= (size_t)optin;
      const size_t bytes = smem ? carry : 0;
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(cs, B, nw, bytes, nullptr, &attr);
      int active = 0;
      if (cudaOccupancyMaxActiveClusters(&active, kern, &cfg) != cudaSuccess || active < 1) {
        cudaGetLastError();  // a size the card does not hold
        continue;
      }
      const long long waves = (2LL * B + active - 1) / active;
      const long long cost = (waves * sw * (smem ? 1 : 2)) << 8 | std::min(waves, 255LL);
      if (best < 0 || cost < best) {
        best = cost;
        *out = {cs, sw, nw, smem, active, (long long)bytes, smem ? 0 : (long long)(2LL * B * cs * carry), 1};
      }
    }
    return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
  }
};

template <typename T, int VPL>
struct VerticalFn {
  static cudaError_t run(const VerticalPlan& p, const void* C, void* dn, void* up, void* scratch, int B, int H, int W,
                         int D, int P1, int P2, int with_diag, cudaStream_t st) {
    const auto kern = vertical_kernel<T, VPL>(D, P1, with_diag, p.smem_carry != 0);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
    if (!p.smem_carry && !scratch) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config((int)p.CS, B, (int)p.NW, (size_t)p.smem, st, &attr);
    const VerticalArgs a{C, dn, up, scratch, B, H, W, D, P1, P2, with_diag, (int)p.SW};
    e = cudaLaunchKernelEx(&cfg, kern, a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

// The register form's launch geometry: grid (CS, B, 2), clusters of CS,
// NW warps a block and enough dynamic shared memory that no two blocks
// share an SM (the warps' inboxes need (512 N + 32) NW bytes).
cudaError_t reg_config(int CS, int B, int NW, int N, cudaStream_t st, cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr) {
  int dev = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = std::max((size_t)(512 * N + 32) * NW, (size_t)per_sm / 2 + 1);
  *cfg = cluster_config(CS, B, NW, smem, st, attr);
  return cudaSuccess;
}

template <int N, int CPW>
struct RegFn {
  static constexpr int kN = N, kCPW = CPW;
  static auto kernel() { return vertical_cluster<N, CPW>; }
  static cudaError_t prepare(int NW, int CS, int B, cudaStream_t st, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
    cudaError_t e = reg_config(CS, B, NW, N, st, cfg, attr);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg->dynamicSmemBytes);
    return e;
  }
  // Warps a block may have: the launch bound and the registers allow, 0
  // where the build keeps anything in local memory.
  static int warps() {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, kernel()) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    return fa.localSizeBytes > 0 ? 0 : std::min(fa.maxThreadsPerBlock, reg_threads(N, CPW)) / 32;
  }
  static int clusters(int NW, int CS) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int active = 0;
    if (prepare(NW, CS, 1, nullptr, &cfg, &attr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&active, kernel(), &cfg) != cudaSuccess) {
      cudaGetLastError();  // a cluster the card does not hold
      return 0;
    }
    return active;
  }
  static cudaError_t launch(const RegArgs& a, int B, int NW, int CS, cudaStream_t st) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = prepare(NW, CS, B, st, &cfg, &attr);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel(), a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

// f(RegFn<N, CPW>{}) for N words a lane and CPW columns a warp, where that
// form is built; `refused` otherwise.
template <int N, int CPW = 1, typename F, typename R>
R by_columns(int cpw, F f, R refused) {
  if constexpr (CPW > 16) {
    return refused;
  } else {
    if constexpr (reg_built(N, CPW))
      if (cpw == CPW) return f(RegFn<N, CPW>{});
    return by_columns<N, CPW + 1>(cpw, f, refused);
  }
}

// The same over D = 64 N disparities (64, 128 or 256: the packed step with
// every lane's VPL = 2N values real).
template <typename F, typename R>
R by_form(int D, int cpw, F f, R refused) {
  if (D == 64) return by_columns<1>(cpw, f, refused);
  if (D == 128) return by_columns<2>(cpw, f, refused);
  if (D == 256) return by_columns<4>(cpw, f, refused);
  return refused;
}

template <typename T, int VPL>
struct HorizontalFn {
  static cudaError_t run(const void* C, void* out, int rows, int W, int D, int P1, int P2, int reverse,
                         cudaStream_t st) {
    return horizontal<T, VPL>(static_cast<const T*>(C), static_cast<T*>(out), rows, W, D, P1, P2, reverse, st);
  }
};

template <typename T, int VPL>
struct WtaFn {
  static cudaError_t run(const void* const* vp, int nvol, int* const* maps, uint8_t* uok, int npix, int D, int uniq,
                         cudaStream_t st) {
    const T* v[4] = {static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2]),
                     static_cast<const T*>(vp[3])};
    return wta<T, VPL>(v, nvol, maps, uok, npix, D, uniq, st);
  }
};

// The fused R->L WTA's launch (#5): the ring form where the lanes' words copy
// whole (D % VPL == 0, at least 4 bytes a lane), else the direct form. RlPlan's fields: the form (0 direct, 1 ring, 2 the
// form above 1024), rows (warps) a block, ring columns a row, shared-memory
// bytes a block.
struct RlPlan {
  long long form, rows, ring, smem;
};

template <typename T, int VPL>
struct RlWtaFn {
  static cudaError_t run(const RlArgs& a, RlPlan* plan, cudaStream_t st) {
    const bool ring = VPL * sizeof(T) >= 4 && a.D % VPL == 0;
    constexpr int R = rl_ring<T, VPL>(), NR = rl_rows<T, VPL>();
    const RlPlan p = ring ? RlPlan{1, NR, R, (long long)NR * R * rl_slot_bytes<T, VPL>()} : RlPlan{0, kWarps, 0, 0};
    if (plan) {  // a query: no launch
      *plan = p;
      return cudaSuccess;
    }
    const int blocks = (a.rows + (int)p.rows - 1) / (int)p.rows;
    if (ring) {
      const auto kern = horizontal_rl_wta<T, VPL, true>;
      const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
      if (e != cudaSuccess) return e;
      kern<<<blocks, (int)p.rows * 32, (size_t)p.smem, st>>>(a);
    } else {
      horizontal_rl_wta<T, VPL, false><<<blocks, kWarps * 32, 0, st>>>(a);
    }
    return cudaGetLastError();
  }
};

}  // namespace

// The plan of svt_sgm_vertical for a (B, H, W, D) cost stored in `bytes`
// a value (2: int16, 4: int32), on the current device: 8 long longs
// (VerticalPlan). D > 1024: no cluster (CS 0), H row launches of the wide
// form, its ping-pong carries and minima in scratch.
SVT_EXPORT int svt_sgm_vertical_plan(int B, int H, int W, int D, int bytes, long long* out) {
  VerticalPlan* p = reinterpret_cast<VerticalPlan*>(out);
  if (B < 1 || H < 1 || W < 1 || D < 1 || (bytes != 2 && bytes != 4)) return cudaErrorInvalidValue;
  if (D > kRegisterRange) {
    *p = {};
    p->scratch = (long long)round16((size_t)12 * B * W * D * bytes) + 48LL * B * W;
    p->launches = H;
    return cudaSuccess;
  }
  const int vpl = vpl_for(D);
  if (bytes == 2) {
    switch (vpl) {
      case 1: return VerticalPlanFn<int16_t, 1>::run(B, W, D, p);
      case 2: return VerticalPlanFn<int16_t, 2>::run(B, W, D, p);
      case 4: return VerticalPlanFn<int16_t, 4>::run(B, W, D, p);
      case 8: return VerticalPlanFn<int16_t, 8>::run(B, W, D, p);
      case 16: return VerticalPlanFn<int16_t, 16>::run(B, W, D, p);
      default: return VerticalPlanFn<int16_t, 32>::run(B, W, D, p);
    }
  }
  switch (vpl) {
    case 1: return VerticalPlanFn<int, 1>::run(B, W, D, p);
    case 2: return VerticalPlanFn<int, 2>::run(B, W, D, p);
    case 4: return VerticalPlanFn<int, 4>::run(B, W, D, p);
    case 8: return VerticalPlanFn<int, 8>::run(B, W, D, p);
    case 16: return VerticalPlanFn<int, 16>::run(B, W, D, p);
    default: return VerticalPlanFn<int, 32>::run(B, W, D, p);
  }
}

// (B, H, W, D) cost -> down-set and up-set sums, every volume int16 (bytes 2)
// or int32 (bytes 4), by the plan svt_sgm_vertical_plan gave for the same
// arguments (`plan`, its 8 long longs): D <= 1024 one cluster launch; above,
// H launches of the wide form. scratch: the plan's scratch bytes (or null).
SVT_EXPORT int svt_sgm_vertical(const void* C, void* s_dn, void* s_up, void* scratch, int B, int H, int W, int D,
                                int P1, int P2, int with_diag, int bytes, const long long* plan, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const VerticalPlan& p = *reinterpret_cast<const VerticalPlan*>(plan);
  if (D > kRegisterRange) {
    if (!scratch) return cudaErrorInvalidValue;
    void* mbuf = static_cast<unsigned char*>(scratch) + round16((size_t)12 * B * W * D * bytes);
    if (bytes == 2) return Wide<int16_t>::vertical(C, s_dn, s_up, scratch, mbuf, B, H, W, D, P1, P2, with_diag, st);
    if (bytes == 4) return Wide<int>::vertical(C, s_dn, s_up, scratch, mbuf, B, H, W, D, P1, P2, with_diag, st);
    return cudaErrorInvalidValue;
  }
  if (p.CS < 1) return cudaErrorInvalidValue;
  return dispatch<VerticalFn>(bytes, D, p, C, s_dn, s_up, scratch, B, H, W, D, P1, P2, with_diag, st);
}

// The register form of the vertical scan (int16, with diagonals; D % VPL
// == 0 at VPL 2, 4 or 8): warps a block of `cpw` columns a warp may have
// (0: not built for D and cpw, or the build spills).
SVT_EXPORT int svt_sgm_vertical_registers_warps(int D, int cpw) {
  return by_form(D, cpw, [](auto fn) { return decltype(fn)::warps(); }, 0);
}

// Clusters of `cs` blocks of `nw` warps (cpw columns a warp) the card holds
// at once, one block an SM; 0 where it holds none or the form is not built.
SVT_EXPORT int svt_sgm_vertical_registers_clusters(int D, int cpw, int nw, int cs) {
  if (cs < 1 || cs > kRegMaxCluster || nw < 1) return 0;
  return by_form(D, cpw, [&](auto fn) { return decltype(fn)::clusters(nw, cs); }, 0);
}

// (B, H, W, D) int16 cost -> down-set and up-set sums with diagonals, the
// register form: clusters of `cs` blocks of `nw` warps, `cpw` columns a
// warp (cs * nw * cpw >= W), one device launch; P1 <= 0x7fff and every
// stored value below 2^15 / 3 (sgm_cuda.storage_dtype at three carries:
// the caller's cost bound + P2, so P2 below kRegEdge).
SVT_EXPORT int svt_sgm_vertical_registers(const void* C, void* s_dn, void* s_up, int B, int H, int W, int D, int P1,
                                          int P2, int cs, int nw, int cpw, void* stream) {
  if (B < 1 || H < 1 || W < 1 || P1 < 0 || P1 > (int)kPackedOut || P2 < 0 || P2 >= (int)kRegEdge || cs < 1 ||
      cs > kRegMaxCluster || nw < 1 || (long long)cs * nw * cpw < W)
    return cudaErrorInvalidValue;
  const RegArgs a{static_cast<const int16_t*>(C), static_cast<int16_t*>(s_dn), static_cast<int16_t*>(s_up), H, W, P1,
                  P2};
  const auto st = static_cast<cudaStream_t>(stream);
  return by_form(
      D, cpw,
      [&](auto fn) {
        using Fn = decltype(fn);
        return 32 * nw > reg_threads(Fn::kN, Fn::kCPW) ? cudaErrorInvalidValue : Fn::launch(a, B, nw, cs, st);
      },
      cudaErrorInvalidValue);
}

// (B, H, W, D) cost -> one horizontal direction volume of the same type.
SVT_EXPORT int svt_sgm_horizontal(const void* C, void* out, int B, int H, int W, int D, int P1, int P2,
                                  int reverse, int bytes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (D > kRegisterRange) {
    if (bytes == 2) return Wide<int16_t>::horizontal(C, out, B * H, W, D, P1, P2, reverse, st);
    if (bytes == 4) return Wide<int>::horizontal(C, out, B * H, W, D, P1, P2, reverse, st);
    return cudaErrorInvalidValue;
  }
  return dispatch<HorizontalFn>(bytes, D, C, out, B * H, W, D, P1, P2, reverse, st);
}

// nvol (2-4) (npix, D) volumes of one type -> six per-pixel maps (v2, v3
// may be null when nvol is smaller).
SVT_EXPORT int svt_sgm_wta(const void* v0, const void* v1, const void* v2, const void* v3, int nvol,
                           void* minS, void* best, void* sm, void* s0, void* sp, void* uok, int npix, int D,
                           int uniq, int bytes, void* stream) {
  if (D < 3 || nvol < 2 || nvol > 4) return cudaErrorInvalidValue;
  const void* v[4] = {v0, v1, v2, v3};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(sm),
                  static_cast<int*>(s0), static_cast<int*>(sp)};
  if (D > kRegisterRange) {
    const auto st = static_cast<cudaStream_t>(stream);
    const auto u = static_cast<uint8_t*>(uok);
    if (bytes == 2) return Wide<int16_t>::wta(v, nvol, maps, u, npix, D, uniq, st);
    if (bytes == 4) return Wide<int>::wta(v, nvol, maps, u, npix, D, uniq, st);
    return cudaErrorInvalidValue;
  }
  return dispatch<WtaFn>(bytes, D, static_cast<const void* const*>(v), nvol, static_cast<int* const*>(maps),
                         static_cast<uint8_t*>(uok), npix, D, uniq, static_cast<cudaStream_t>(stream));
}

// One int32 (npix, D) aggregated volume -> six per-pixel maps.
SVT_EXPORT int svt_sgm_wta_stats(const void* S, void* minS, void* best, void* sm, void* s0, void* sp, void* uok,
                                 long long npix, int D, int uniq, void* stream) {
  if (D < 3) return cudaErrorInvalidValue;
  const auto s = static_cast<const int*>(S);
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(sm),
                  static_cast<int*>(s0), static_cast<int*>(sp)};
  const auto u = static_cast<uint8_t*>(uok);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D > kRegisterRange) {
    wta_stats_wide_kernel<<<(npix + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(s, maps[0], maps[1], maps[2],
                                                                                maps[3], maps[4], u, npix, D, uniq);
    return cudaGetLastError();
  }
  switch (vpl_for(D)) {
    case 1: return wta_stats<1>(s, maps, u, npix, D, uniq, st);
    case 2: return wta_stats<2>(s, maps, u, npix, D, uniq, st);
    case 4: return wta_stats<4>(s, maps, u, npix, D, uniq, st);
    case 8: return wta_stats<8>(s, maps, u, npix, D, uniq, st);
    case 16: return wta_stats<16>(s, maps, u, npix, D, uniq, st);
    default: return wta_stats<32>(s, maps, u, npix, D, uniq, st);
  }
}

// Bytes of the carry rows svt_sgm_horizontal_rl_wta needs for B x H rows
// of D disparities stored in `bytes` a value: 0 where the carry stays in
// registers (D <= 1024).
SVT_EXPORT long long svt_sgm_rl_wta_scratch_bytes(int B, int H, int D, int bytes) {
  return D > kRegisterRange ? 2LL * B * H * D * bytes : 0;
}

namespace {
bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
}  // namespace

// How svt_sgm_horizontal_rl_wta launches for D disparities stored in `bytes`
// a value: 4 long longs (RlPlan: form, rows a block, ring columns,
// shared-memory bytes a block).
SVT_EXPORT int svt_sgm_rl_wta_plan(int D, int bytes, long long* out) {
  if (D < 3 || (bytes != 2 && bytes != 4)) return cudaErrorInvalidValue;
  RlPlan* p = reinterpret_cast<RlPlan*>(out);
  if (D > kRegisterRange) {
    *p = {2, kWarps, 0, 0};
    return cudaSuccess;
  }
  RlArgs a{};
  a.D = D;
  return dispatch<RlWtaFn>(bytes, D, a, p, static_cast<cudaStream_t>(nullptr));
}

// (B, H, W, D) cost + three direction volumes, all of one type -> six
// per-pixel maps of the four-direction sum, the R->L direction scanned in
// place: one device launch, by svt_sgm_rl_wta_plan's form; every tensor on
// 16 bytes. Lbuf: svt_sgm_rl_wta_scratch_bytes of it (null where that is 0).
SVT_EXPORT int svt_sgm_horizontal_rl_wta(const void* C, const void* v0, const void* v1, const void* v2, void* minS,
                                         void* best, void* sm, void* s0, void* sp, void* uok, int B, int H, int W,
                                         int D, int P1, int P2, int uniq, int bytes, void* Lbuf, void* stream) {
  if (D < 3 || !on16(C) || !on16(v0) || !on16(v1) || !on16(v2)) return cudaErrorInvalidValue;
  if (B * H == 0 || W == 0) return cudaSuccess;
  const void* v[3] = {v0, v1, v2};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(sm),
                  static_cast<int*>(s0), static_cast<int*>(sp)};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto u = static_cast<uint8_t*>(uok);
  if (D > kRegisterRange) {
    if (!Lbuf) return cudaErrorInvalidValue;
    if (bytes == 2) return Wide<int16_t>::rl_wta(C, v, Lbuf, B * H, W, D, P1, P2, uniq, maps, u, st);
    if (bytes == 4) return Wide<int>::rl_wta(C, v, Lbuf, B * H, W, D, P1, P2, uniq, maps, u, st);
    return cudaErrorInvalidValue;
  }
  const RlArgs a{C, {v0, v1, v2}, B * H, W, D, P1, P2, uniq, {maps[0], maps[1], maps[2], maps[3], maps[4]}, u};
  return dispatch<RlWtaFn>(bytes, D, a, static_cast<RlPlan*>(nullptr), st);
}
