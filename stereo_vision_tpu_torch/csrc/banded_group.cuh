// The group form of the banded SGM step, and the scan that walks a line of
// pixels with it: the horizontal scan (#18) at every band, and the vertical
// scan without diagonals at bands above 64 (banded_wide.cuh).
//
// A group of GS threads (GS = min(KP, 32)) holds one pixel's carry: thread t
// holds lanes t + GS * j, j < LPT = KP / GS. A step realigns the carry by
// three shuffles (group_realign) and updates it from the group's band
// minimum (group_update). The 8-path wide scan (banded_wide.cuh) reads its
// realigned carries from memory and shares group_update.
#pragma once

#include "banded.cuh"

namespace svt {

// A read-only load of a T lane, sign-extended to int32 by the load itself.
__device__ __forceinline__ int load_lane(const int16_t* p) {
  int v;
  asm("ld.global.nc.s16 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int load_lane(const int* p) { return __ldg(p); }

// Lanes k + sh + o - 1 (o = 0, 1, 2) of the group's carry L for each lane
// k = t + GS * j a thread holds: a[o][j], kBig where the source lane lies
// outside [0, KP) (lanes at and past K of L hold kBig). Three independent
// __shfl_sync a stage; every thread of the warp takes part.
template <int GS, int LPT>
__device__ __forceinline__ void group_realign(const int (&L)[LPT], int t, int sh, int (&a)[3][LPT]) {
  constexpr int kLogGS = log2_of<GS>();
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const int q = t + sh + o - 1;
    const int src = q & (GS - 1), e0 = q >> kLogGS;  // floor division
    int v[LPT];
#pragma unroll
    for (int e = 0; e < LPT; ++e) v[e] = __shfl_sync(kFullMask, L[e], src, GS);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int e = j + e0;
      int r = kBig;
#pragma unroll
      for (int f = 0; f < LPT; ++f) r = e == f ? v[f] : r;
      a[o][j] = r;
    }
  }
}

// _update_banded on the realigned carry a (lanes k + o - 1 of the aligned
// predecessor; a lane with no source holds kBig): the band minimum m over the
// group; the border rule L = c where `reset` (|delta| beyond the reach) or no
// lane is in band, else L = c + min(a, m + P2, min(a[k - 1], a[k + 1]) + P1)
// - m. Lanes at and past K end as kBig.
template <int GS, int LPT>
__device__ __forceinline__ void group_update(int (&a)[3][LPT], const int (&c)[LPT], int t, int K, bool reset, int P1,
                                             int P2, int (&L)[LPT]) {
  int m = kBig;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int k = t + GS * j;
    if (k >= K) a[1][j] = kBig;
    if (k == 0) a[0][j] = kBig;       // no lane below the band
    if (k + 1 >= K) a[2][j] = kBig;  // no lane above it
    m = min(m, a[1][j]);
  }
  if constexpr (GS == 32) {
    m = __reduce_min_sync(kFullMask, m);
  } else {
#pragma unroll
    for (int o = GS / 2; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFullMask, m, o, GS));
  }
  const bool border = reset || m >= kBig;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int cand = min(min(a[1][j], m + P2), min(a[0][j], a[2][j]) + P1);
    L[j] = t + GS * j >= K ? kBig : border ? c[j] : c[j] + cand - m;
  }
}

}  // namespace svt

namespace {

// The line scan. Replaces banded_pallas.py:1144 banded_reduce_pack ->
// _horiz_kernel:759 (rows: the L->R, reverse R->L, recurrence of every
// (frame, row), the carry realigned by s(x) - s(x -+ 1), 0 at the first
// column) and, at bands above 64, the vertical scan of _vert_kernel:666
// without diagonals (columns: every (frame, column, direction), down then
// up, realigned by s(y) - s(row visited before)).
//
// What bounds it: bytes. It reads the cost volume and the shift map once
// and writes one volume: at the hier16x3 full level (8 frames of 720 rows,
// 1152 columns, K=16, int16) 2 x 212 MB + 26.5 MB, ~0.135 ms at 3.35 TB/s;
// its ~10 operations a lane and step take ~0.03 ms at 67 T/s.
//
// The recurrence is a chain of dependent steps per line, so the design is
// about that chain. A group of GS = min(KP, 32) threads owns one line, so
// the card holds lines x GS threads (92,160 at the hier16x3 full level)
// where one thread a row held 5,760. Per step, with every shuffle inside
// the group:
//   - the carry's lanes k + sh, k + sh - 1 and k + sh + 1 (sh = +-G or 0)
//     come by three independent __shfl_sync, kBig outside [0, K), which
//     gives the realigned carry and its d -+ 1 neighbours at once;
//   - its minimum over the band is log2(GS) __shfl_xor_sync steps, or one
//     __reduce_min_sync where the group is the warp (under a group's mask
//     the warp's groups take their __reduce_min_sync in turns);
//   - the update is a few integer operations per lane.
// Each thread loads and stores its own lanes: a group's K lanes of one
// pixel are contiguous (32 bytes at K=16 int16), so each access is whole
// sectors. Loads run U steps ahead through a register ring, so that a
// pixel's cost and shift arrive while earlier steps run; they are
// unconditional (a lane past the band or a step past the line reads an
// in-bounds neighbour it never uses) and sign-extend in the load itself, so
// that no instruction waits on them before their step (a select or a
// conversion placed right after a load stalls the whole chain). Every lane
// of the group reads the shift map at the same address, one broadcast a
// step. At most 64 registers a thread keep all of a level's groups resident
// in one wave (LPT <= 2); the wide bands' LPT 4 and 8 take 128 and 255, and
// LPT 16 and 32 load one step ahead.
// What holds it back (PERF.md): at K=16 the chain of a step's shuffles,
// minimum and update, row by row; at K <= 8 a warp's load or store touches
// 32 / GS rows, so the time grows with the frames. Both directions, both
// walks and both storage types are one template.
constexpr int kHorizThreads = 128;
constexpr int kHorizAhead = 4;  // U: steps loaded ahead of the chain

__host__ __device__ constexpr int line_blocks_per_sm(int lpt) { return lpt <= 2 ? 8 : lpt == 4 ? 4 : 2; }

// kColumns == false: line = (frame, row) of `lines` = P * H rows, n = Wv
//   steps of one pixel, `reverse` for R->L, into `out`.
// kColumns == true: line = (direction, frame, column) of `lines` = 2 * P *
//   Wv, n = H steps of Wv pixels; the first half scans down into `out`, the
//   second up into `out_up`.
template <typename T, int GS, int LPT, bool kColumns>
__global__ void __launch_bounds__(kHorizThreads, line_blocks_per_sm(LPT))
banded_line_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out,
                   T* __restrict__ out_up, int lines, int n, int Wv, int K, int G, int P1, int P2, int reverse) {
  constexpr int U = LPT >= 16 ? 1 : kHorizAhead;  // the widest bands' rings would take every register
  const int lane = threadIdx.x & 31;
  const int t = lane & (GS - 1);
  const int warp_line0 = (blockIdx.x * kHorizThreads + (threadIdx.x & ~31)) / GS;
  if (warp_line0 >= lines) return;  // whole warp
  const int gid = warp_line0 + lane / GS;
  const bool live = gid < lines;  // a group past the last line shadows it and stores nothing
  const int line = live ? gid : lines - 1;
  size_t first;  // the line's first pixel
  T* o = out;
  bool rev = reverse;
  if constexpr (kColumns) {
    const int half = lines / 2, up = line >= half, rem = line - up * half, b = rem / Wv;
    first = (size_t)b * n * Wv + (rem - b * Wv);
    o = up ? out_up : out;
    rev = up;
  } else {
    first = (size_t)line * Wv;
  }
  const size_t pstride = kColumns ? (size_t)Wv : 1;  // pixels between steps
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const T* crow = C + first * KS;
  T* orow = o + first * KS;
  const int* srow = shift + first;

  bool valid[LPT];
  int L[LPT], lofs[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    valid[j] = t + GS * j < K;
    lofs[j] = min(t + GS * j, K - 1);  // the lane a thread loads (past the band: a neighbour, unused)
    L[j] = valid[j] ? 0 : svt::kBig;   // the zero carry; lanes past the band hold kBig
  }
  // Pixel of the ti-th step in scan order, clamped into the line.
  auto pos = [&](int ti) {
    const int c = min(ti, n - 1);
    return (size_t)(rev ? n - 1 - c : c) * pstride;
  };

  // The register ring: costs and shifts of steps [base, base + U).
  int cn[U][LPT], sn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t x = pos(u);
    sn[u] = __ldg(srow + x);
#pragma unroll
    for (int j = 0; j < LPT; ++j) cn[u][j] = svt::load_lane(crow + x * KS + lofs[j]);
  }
  int sprev = sn[0];  // delta 0 at the first step

  for (int base = 0; base < n; base += U) {
    int cc[U][LPT], sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u] = sn[u];
#pragma unroll
      for (int j = 0; j < LPT; ++j) cc[u][j] = cn[u][j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t x = pos(base + U + u);
      sn[u] = __ldg(srow + x);
#pragma unroll
      for (int j = 0; j < LPT; ++j) cn[u][j] = svt::load_lane(crow + x * KS + lofs[j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ti = base + u;
      if (ti >= n) break;  // uniform: every group has the same n
      const int delta = sc[u] - sprev;
      sprev = sc[u];
      const int sh = delta == G ? G : delta == -G ? -G : 0;
      int a[3][LPT];
      svt::group_realign<GS, LPT>(L, t, sh, a);
      svt::group_update<GS, LPT>(a, cc[u], t, K, delta > G || delta < -G, P1, P2, L);
      const size_t x = pos(ti);
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (live && valid[j]) orow[x * KS + t + GS * j] = static_cast<T>(L[j]);
    }
  }
}

template <typename T, int GS, int LPT, bool kColumns>
cudaError_t line_launch(const T* C, const int* s, T* out, T* out_up, int lines, int n, int Wv, int K, int G, int P1,
                        int P2, int reverse, cudaStream_t st) {
  const long long threads = (long long)lines * GS;
  const long long blocks = (threads + kHorizThreads - 1) / kHorizThreads;
  banded_line_kernel<T, GS, LPT, kColumns><<<(unsigned)blocks, kHorizThreads, 0, st>>>(C, s, out, out_up, lines, n,
                                                                                       Wv, K, G, P1, P2, reverse);
  return cudaGetLastError();
}

}  // namespace
