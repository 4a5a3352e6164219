// The pieces of the forms that take a disparity range or band above 1024:
// one warp walks a pixel's range in steps of 32 (lane d, d + 32, ...), its
// SGM carry read from device memory (the previous pixel's stored volume,
// or a ping-pong scratch), so any width runs in the same registers. The
// forms at and below 1024 keep a pixel's range in registers; these forms
// re-read memory instead and are right and simple first (no main path runs
// them). Used by sgm.cu (the exact scans and WTA), bm.cu and
// banded_wide.cuh (the banded scans and WTA).
#pragma once

#include <climits>

#include "common.cuh"

namespace svt {

constexpr int kWideOut = 1 << 29;  // a carry lane outside the range or band

// One SGM step over d < n: L'[d] = cost(d) + min(L[d], L[d-1] + P1,
// L[d+1] + P1, minL + P2) - minL, handed to store(d, L'[d]); L read from
// `prev` (nullptr: the zero carry, L = 0 on [0, n) and minL = 0). Returns
// the minimum of L' over d (every lane of the warp takes part).
template <typename T, typename Cost, typename Store>
__device__ __forceinline__ int wide_sgm_step(const T* prev, int minL, Cost cost, Store store, int n, int P1, int P2,
                                             int lane) {
  auto at = [&](int d) { return d < 0 || d >= n ? kWideOut : prev ? static_cast<int>(prev[d]) : 0; };
  int m = INT_MAX;
  for (int d = lane; d < n; d += 32) {
    const int cand = min(min(at(d), minL + P2), min(at(d - 1), at(d + 1)) + P1);
    const int v = cost(d) + cand - minL;
    store(d, v);
    m = min(m, v);
  }
  return __reduce_min_sync(kFullMask, m);
}

// The banded carry realigned by sh: lane k reads lane k + sh of `prev`,
// kWideOut where either lies outside [0, K); prev == nullptr is the zero
// carry (0 on [0, K)).
template <typename T>
__device__ __forceinline__ int band_lane(const T* prev, int sh, int k, int K) {
  const int s = k + sh;
  return k < 0 || k >= K || s < 0 || s >= K ? kWideOut : prev ? static_cast<int>(prev[s]) : 0;
}

// The band minimum of the realigned carry (every lane of the warp takes part).
template <typename T>
__device__ __forceinline__ int band_min(const T* prev, int sh, int K, int lane) {
  int m = kWideOut;
  for (int k = lane; k < K; k += 32) m = min(m, band_lane(prev, sh, k, K));
  return __reduce_min_sync(kFullMask, m);
}

// _update_banded at lane k from the realigned carry and its band minimum m:
// the cost c itself where `reset` (|delta| beyond the reach) or no lane is
// in band, else c + min(a[k], m + P2, min(a[k-1], a[k+1]) + P1) - m.
template <typename T>
__device__ __forceinline__ int band_update(const T* prev, int sh, bool reset, int m, int c, int k, int K, int P1,
                                           int P2) {
  if (reset || m >= kWideOut) return c;
  const int cand = min(min(band_lane(prev, sh, k, K), m + P2),
                       min(band_lane(prev, sh, k - 1, K), band_lane(prev, sh, k + 1, K)) + P1);
  return c + cand - m;
}

// The WTA statistics of S(d), d < n (n >= 3), by a warp: the minimum, its
// smallest argmin, the uniqueness verdict (no d with |d - best| > 1 and
// mn * (100 + uniq) > S(d) * 100; uniq <= 0: none checked) and S at
// d0 - 1, d0, d0 + 1 with d0 = clip(best, 1, n - 2).
struct WideStats {
  int mn, best, sm, s0, sp;
  bool ok;
};

template <typename S>
__device__ __forceinline__ WideStats wide_wta(S value, int n, int uniq, int lane) {
  int m = INT_MAX, arg = INT_MAX;
  for (int d = lane; d < n; d += 32) {
    const int v = value(d);
    if (v < m) m = v, arg = d;  // d rises: the first minimum of the lane
  }
  const int mn = __reduce_min_sync(kFullMask, m);
  const int best = __reduce_min_sync(kFullMask, m == mn ? arg : INT_MAX);
  bool offend = false;
  if (uniq > 0)
    for (int d = lane; d < n; d += 32) offend |= abs(d - best) > 1 && mn * (100 + uniq) > value(d) * 100;
  const int d0 = min(max(best, 1), n - 2);
  return {mn, best, value(d0 - 1), value(d0), value(d0 + 1), !__any_sync(kFullMask, offend)};
}

}  // namespace svt
