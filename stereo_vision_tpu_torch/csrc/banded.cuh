// Device code shared by the banded SGBM kernels (banded.cu, banded_diag.cu,
// banded_wide.cu): lane loads and stores, the carry realignment, the banded
// SGM step and the WTA statistics.
//
// A pixel's band is K lanes, K >= 1, stored as T (int16_t or int). In
// memory a pixel holds KS = lane_stride(K) lanes, K rounded up to 4, so its
// lanes start on a 4-lane word (8 bytes in int16, 16 in int32) and whole
// 16-byte words where KS % 8 == 0 in int16; the lanes k >= K of a pixel in
// memory hold whatever a store left there and are never read as values. In
// registers a thread holds KP lanes, KP the power of two at or above K (at
// least 4; K <= 64; above, a group of 32 threads holds KP / 32 lanes each,
// banded_wide.cuh); lanes k >= K hold kBig (or the load's fill), so that no
// shift brings a value in from them and no minimum takes them.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace svt {

constexpr int kBig = 1 << 29;  // out-of-band carry lane

// Lanes a pixel's band of K takes in memory: K rounded up to 4.
__host__ __device__ constexpr int lane_stride(int K) { return (K + 3) & ~3; }

// Whether the K lanes of one pixel go as 16-byte words (else 8-byte ones).
template <typename T>
__device__ __forceinline__ bool wide_words(int K) {
  return sizeof(T) == 4 || lane_stride(K) % 8 == 0;
}

// KP lanes of T as raw 8-byte words: a load kept in flight while other work
// runs, unpacked to int32 lanes where it is used.
template <typename T, int KP>
struct RawLanes {
  static constexpr int kWords = KP * (int)sizeof(T) / 8;
  int2 w[kWords];

  __device__ __forceinline__ void load(const T* p, int K) {
    const int nbytes = K * (int)sizeof(T);
    if (kWords >= 2 && wide_words<T>(K)) {
#pragma unroll
      for (int i = 0; i < kWords / 2; ++i) {
        const int4 q = 16 * i < nbytes ? reinterpret_cast<const int4*>(p)[i] : make_int4(0, 0, 0, 0);
        w[2 * i] = make_int2(q.x, q.y);
        w[2 * i + 1] = make_int2(q.z, q.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 8 * i < nbytes ? reinterpret_cast<const int2*>(p)[i] : make_int2(0, 0);
    }
  }
  __device__ __forceinline__ void unpack(int K, int (&v)[KP], int fill) const {
    const T* h = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int k = 0; k < KP; ++k) v[k] = k < K ? static_cast<int>(h[k]) : fill;
  }
};

// No __restrict__ on the pointers of these two: the diagonal scan reads
// carries that other threads of its block wrote.
template <typename T, int KP>
__device__ __forceinline__ void load_lanes(const T* p, int K, int (&v)[KP], int fill) {
  RawLanes<T, KP> r;
  r.load(p, K);
  r.unpack(K, v, fill);
}

template <typename T, int KP>
__device__ __forceinline__ void store_lanes(T* p, int K, const int (&v)[KP]) {
  constexpr int kWords = KP * (int)sizeof(T) / 8;
  int2 w[kWords];
  T* h = reinterpret_cast<T*>(w);
#pragma unroll
  for (int k = 0; k < KP; ++k) h[k] = static_cast<T>(v[k]);
  const int nbytes = K * (int)sizeof(T);
  if (kWords >= 2 && wide_words<T>(K)) {
#pragma unroll
    for (int i = 0; i < kWords / 2; ++i)
      if (16 * i < nbytes)
        reinterpret_cast<int4*>(p)[i] = make_int4(w[2 * i].x, w[2 * i].y, w[2 * i + 1].x, w[2 * i + 1].y);
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      if (8 * i < nbytes) reinterpret_cast<int2*>(p)[i] = w[i];
  }
}

template <int KP>
__host__ __device__ constexpr int log2_of() {
  int n = 0;
  while ((1 << n) < KP) ++n;
  return n;
}

// a[k] <- a[k + sh] for k < K, kBig where k + sh is outside [0, K): a barrel
// shifter over the bits of |sh|, each stage a shift by a compile-time offset.
// Lanes k >= K hold kBig before and after.
template <int KP>
__device__ __forceinline__ void shift_lanes(int (&a)[KP], int sh, int K) {
  if (sh >= K || sh <= -K) {
#pragma unroll
    for (int k = 0; k < KP; ++k) a[k] = kBig;
    return;
  }
  constexpr int kBits = log2_of<KP>();
  if (sh > 0) {
#pragma unroll
    for (int i = 0; i < kBits; ++i) {
      const int bit = 1 << i;
      if (sh & bit) {
#pragma unroll
        for (int k = 0; k < KP; ++k) a[k] = k + bit < KP ? a[k + bit] : kBig;
      }
    }
  } else if (sh < 0) {
    const int m = -sh;
#pragma unroll
    for (int i = 0; i < kBits; ++i) {
      const int bit = 1 << i;
      if (m & bit) {
#pragma unroll
        for (int k = KP - 1; k >= 0; --k) a[k] = k - bit >= 0 ? a[k - bit] : kBig;
      }
    }
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k >= K) a[k] = kBig;  // the lanes shifted up past the band
  }
}

// align_band (fill kBig; kDiag: align_band(diag=True), which also shifts
// by +-2G when 2G < K) then _update_banded, in place on the carry L. The
// lanes k >= K of c and L hold kBig.
template <int KP, bool kDiag = false>
__device__ __forceinline__ void banded_step(const int (&c)[KP], int (&L)[KP], int delta, int K, int G, int P1,
                                            int P2) {
  const bool two = kDiag && 2 * G < K;
  const int reach = two ? 2 * G : G;
  if (delta > reach || delta < -reach) {
#pragma unroll
    for (int k = 0; k < KP; ++k) L[k] = c[k];  // no lane in band: the border rule
    return;
  }
  if (delta == G) {
    shift_lanes<KP>(L, G, K);
  } else if (delta == -G) {
    shift_lanes<KP>(L, -G, K);
  } else if (two && delta == 2 * G) {
    shift_lanes<KP>(L, 2 * G, K);
  } else if (two && delta == -2 * G) {
    shift_lanes<KP>(L, -2 * G, K);
  }
  int m = L[0];
#pragma unroll
  for (int k = 1; k < KP; ++k) m = min(m, L[k]);
  if (m >= kBig) {
#pragma unroll
    for (int k = 0; k < KP; ++k) L[k] = c[k];
    return;
  }
  int prev = kBig;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int cur = L[k];
    const int nxt = k + 1 < KP ? L[k + 1] : kBig;
    const int cand = min(min(cur, m + P2), min(prev, nxt) + P1);
    L[k] = k < K ? c[k] + cand - m : kBig;
    prev = cur;
  }
}

// ------------------------------------------- the scans' row rings (#17)

// The cp.async helpers (a thread's own copies into a ring of shared memory)
// are in common.cuh.

// Copies `bytes` (a multiple of `unit`, 8 or 16; both addresses aligned to
// it) from global to shared memory.
__device__ __forceinline__ void cp_async_run(void* smem, const void* gmem, int bytes, int unit) {
  auto d = static_cast<unsigned char*>(smem);
  auto g = static_cast<const unsigned char*>(gmem);
  for (int o = 0; o < bytes; o += unit) cp_async(d + o, g + o, unit);
}

// The WTA statistics of one pixel (banded.cu, banded_wide.cuh).
struct WtaStats {
  int mn, bst;  // min and argmin over the lanes (ties -> smallest k)
  int a, z, c;  // the samples at d0 - 1, d0, d0 + 1, d0 = clip(best, 1, K - 2)
  bool ok;      // band-local uniqueness
};

// The subpixel parabola in lane units x16; the edges keep 16 * best.
__device__ __forceinline__ int subpixel16(const WtaStats& w, int K) {
  const int denom2 = max(w.a + w.c - 2 * w.z, 1);
  const int q = ((w.a - w.c) * 16 + denom2) / (2 * denom2);  // C division truncates, as the reference
  return w.bst > 0 && w.bst < K - 1 ? w.bst * 16 + q : w.bst * 16;
}

}  // namespace svt
