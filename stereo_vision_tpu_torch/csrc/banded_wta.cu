// The banded WTA of the hierarchical matcher: banded_wta_kernel (#20) and
// its fused form banded_wta_fused_kernel (#19), in a source of their own
// beside banded.cu.
//
// Replaces stereo_vision_tpu/stereo/banded_pallas.py:1225 banded_reduce_pack
// -> _wta_kernel:815 (6-stat and 4-stat sub forms): the int32 sum S of 2-4
// (P, H, Wv, K) direction volumes (int16 or int32, a pixel's lanes
// lane_stride(K) apart, banded.cuh), then over the K lanes of each pixel:
// minS, best (ties to the smallest k), the uniqueness verdict (no lane k
// with |k - best| > 1 and minS * (100 + u) > S[k] * 100) and either the
// samples S[d0 - 1], S[d0], S[d0 + 1], d0 = clamp(best, 1, K - 2), or the
// subpixel parabola in lane units x16 (sub). At K <= 2 the clamp leaves d0
// at -1 or 0, and a sample index follows the reference's take_along_axis:
// one in [-K, 0) counts from the end, one outside [-K, K) reads INT_MIN.
// Every band K >= 1 up to 64 (above: banded_wide.cuh).
// And banded_pallas.py:1204 banded_reduce_pack -> _wta_fused_kernel:888
// (band 16 only): the same reduction, written as the packed LR check's
// inputs (see banded_wta_fused_kernel); the TPU kernel's 8-rows-a-step
// (W, 128) lane layout and its group-sum matmuls have no counterpart here.
//
// What bounds them on an H100: bytes. Each volume is read once and each map
// written once: at hier4x3's full level (32 frames of 720 x 1152, K=4, three
// int16 volumes) 24 bytes in and 13 out a pixel, 0.293 ms at 3.35 TB/s; the
// fused form at hier16x3's full level (8 frames, K=16, three volumes and the
// shift map in, two int32 maps out) 100 bytes in and 8 out a pixel, 0.214
// ms. The reduction is ~10 operations a lane, which at K <= 16 is as much
// time as the bytes unless it overlaps them. The first design (the volumes
// loaded one after another at every band, the reduction after them) ran at
// half the bound there: without its reduction it took 31-45% less time
// (tools/kernel_variants/banded_wta.py --knobs); the fused form kept that
// design until it joined this source.
//
// Design (both forms): a thread a pixel, consecutive threads on consecutive
// pixels, so that a warp's loads and stores are contiguous runs. At KP <= 32 every
// load of the pixel's 2-4 volumes (8- or 16-byte words, predicated on the
// volume count) is issued before the first add, so that its bytes are in
// flight together while other warps reduce: blocks of 256 at KP <= 16, of
// 128 at 32 (its 16 words a thread leave fewer warps an SM). At KP = 64
// (no main path) the volumes come one after another, 64 lanes a volume
// being as many registers as a thread should hold. One device launch a
// call; the threads share nothing. The fused form is K = 16 (256 threads a
// block), its pixel's shift loaded beside the volumes. (Timed with
// tools/kernel_variants/banded_wta.py and dropped: 2 or 4 pixels a thread,
// groups of 2 or 4 threads a pixel at K = 32, the volumes one after another
// at K = 32 (the first design's form), 64 or 128 threads a block at K <=
// 16, registers held to 3 or 4 blocks an SM, the three samples taken in one
// pass over the lanes, and a tile of pixels staged in shared memory by
// cp.async.)
//
// The lanes past K (in registers: k >= K inside KP) hold INT_MAX, which no
// minimum takes from a real lane (ties go to the smaller k) and no
// uniqueness test reads, so any int32 sum is exact.

#include <climits>

#include "banded.cuh"

namespace {

// Threads a block at band KP (the power of two at or above K, at least 4).
__host__ __device__ constexpr int wta_threads(int KP) { return KP <= 16 ? 256 : 128; }

constexpr int kFusedBand = 16;  // the fused form's one band, as the TPU kernel's

// The value of lane i of the band (the reference's take_along_axis): i in
// [-K, 0) counts from the end; outside [-K, K), INT_MIN.
template <int KP>
__device__ __forceinline__ int sample_lane(const int (&S)[KP], int i, int K) {
  const int j = i < 0 ? i + K : i;
  int v = INT_MIN;
#pragma unroll
  for (int k = 0; k < KP; ++k)
    if (j >= 0 && j < K && j == k) v = S[k];
  return v;
}

// KP lanes of T at p, of which K lie in the band, as raw words: 16 bytes
// where `w16` (the pixel's lanes on 16 bytes), else 8 (4 int16 lanes); the
// words past the band are not read.
template <typename T, int KP>
struct Raw {
  static constexpr int kBytes = KP * (int)sizeof(T);
  int4 w[(kBytes + 15) / 16];

  __device__ __forceinline__ void load(const T* __restrict__ p, int K, bool w16) {
    if (sizeof(T) == 4 || (kBytes >= 16 && w16)) {
      constexpr int kLanes = 16 / (int)sizeof(T);
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        w[i] = kLanes * i < K ? __ldg(reinterpret_cast<const int4*>(p) + i) : make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 8; ++i)
        reinterpret_cast<int2*>(w)[i] = 4 * i < K ? __ldg(reinterpret_cast<const int2*>(p) + i) : make_int2(0, 0);
    }
  }
  // S[k] += lane k for k < K (first: S[k] = lane k, and INT_MAX past K).
  __device__ __forceinline__ void add_to(int (&S)[KP], int K, bool first) const {
    const T* h = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (first)
        S[k] = k < K ? static_cast<int>(h[k]) : INT_MAX;
      else if (k < K)
        S[k] += static_cast<int>(h[k]);
    }
  }
};

// One pixel: the sum of its volumes and the reduction over its K lanes
// (min, argmin, the uniqueness verdict, the three samples).
template <typename T, int KP>
__device__ __forceinline__ svt::WtaStats wta_pixel(const T* const (&vols)[4], int nvol, int p, int K, int uniq) {
  const int KS = svt::lane_stride(K);
  const bool w16 = (KS * (int)sizeof(T)) % 16 == 0;
  int S[KP];
  if constexpr (KP <= 32) {
    Raw<T, KP> raw[4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < nvol) raw[v].load(vols[v] + (size_t)p * KS, K, w16);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < nvol) raw[v].add_to(S, K, v == 0);
  } else {
    Raw<T, KP> raw;
    for (int v = 0; v < nvol; ++v) {
      raw.load(vols[v] + (size_t)p * KS, K, w16);
      raw.add_to(S, K, v == 0);
    }
  }
  int mn = S[0], bst = 0;
#pragma unroll
  for (int k = 1; k < KP; ++k)
    if (S[k] < mn) {
      mn = S[k];
      bst = k;
    }
  bool bad = false;
  if (uniq > 0) {
    const int lim = mn * (100 + uniq);
#pragma unroll
    for (int k = 0; k < KP; ++k) bad |= k < K && abs(k - bst) > 1 && lim > S[k] * 100;
  }
  const int d0 = min(max(bst, 1), K - 2);
  return {mn, bst, sample_lane<KP>(S, d0 - 1, K), sample_lane<KP>(S, d0, K), sample_lane<KP>(S, d0 + 1, K), !bad};
}

// The maps of #20: minS, best, the verdict and either sub16 or the samples.
__device__ __forceinline__ void store_maps(const svt::WtaStats& w, int p, int K, int sub, int* __restrict__ minS,
                                           int* __restrict__ best, int* __restrict__ m2, int* __restrict__ m3,
                                           int* __restrict__ m4, uint8_t* __restrict__ uok) {
  minS[p] = w.mn;
  best[p] = w.bst;
  uok[p] = w.ok ? 1 : 0;
  if (sub) {
    m2[p] = svt::subpixel16(w, K);
  } else {
    m2[p] = w.a;
    m3[p] = w.z;
    m4[p] = w.c;
  }
}

// K == KP takes a copy in which K is a constant, so that the band's masks
// fold away.
template <typename T, int KP>
__global__ void __launch_bounds__(wta_threads(KP))
banded_wta_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                  const T* __restrict__ v3, int nvol, int npix, int K, int uniq, int sub, int* __restrict__ minS,
                  int* __restrict__ best, int* __restrict__ m2, int* __restrict__ m3, int* __restrict__ m4,
                  uint8_t* __restrict__ uok) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const T* const vols[4] = {v0, v1, v2, v3};
  if (K == KP) {
    store_maps(wta_pixel<T, KP>(vols, nvol, p, KP, uniq), p, KP, sub, minS, best, m2, m3, m4, uok);
  } else {
    store_maps(wta_pixel<T, KP>(vols, nvol, p, K, uniq), p, K, sub, minS, best, m2, m3, m4, uok);
  }
}

// The fused form (#19, band 16): the same loads and reduction, the pixel's
// shift loaded beside its volumes, and the LR check's inputs written in
// place of the maps: pack = minS * 2048 + (best + s) and du = (sub16 + 16 *
// s) + 32768 * unique_ok, s in [0, ndisp - 16] with 16 * ndisp < 32768 (the
// wrapper checks ndisp), so that best + s fits the pack's 11 bits and d16
// stays below the uniqueness bit; minS < 2^20 (the wrapper checks the
// volumes' bound) keeps the pack in int32.
template <typename T>
__global__ void __launch_bounds__(wta_threads(kFusedBand))
banded_wta_fused_kernel(const T* __restrict__ v0, const T* __restrict__ v1, const T* __restrict__ v2,
                        const T* __restrict__ v3, int nvol, int npix, int uniq, const int* __restrict__ shift,
                        int* __restrict__ pack, int* __restrict__ du) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int s = __ldg(shift + p);
  const T* const vols[4] = {v0, v1, v2, v3};
  const svt::WtaStats w = wta_pixel<T, kFusedBand>(vols, nvol, p, kFusedBand, uniq);
  pack[p] = w.mn * 2048 + w.bst + s;
  du[p] = svt::subpixel16(w, kFusedBand) + 16 * s + (w.ok ? 32768 : 0);
}

template <typename T, int KP>
cudaError_t wta_launch(const void* const* vp, int nvol, int npix, int K, int uniq, int sub, int* const* maps,
                       uint8_t* uok, cudaStream_t st) {
  constexpr int NT = wta_threads(KP);
  banded_wta_kernel<T, KP><<<(npix + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const T*>(vp[0]), static_cast<const T*>(vp[1]), static_cast<const T*>(vp[2]),
      static_cast<const T*>(vp[3]), nvol, npix, K, uniq, sub, maps[0], maps[1], maps[2], maps[3], maps[4], uok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wta_dispatch(const void* const* vp, int nvol, int npix, int K, int uniq, int sub, int* const* maps,
                         uint8_t* uok, cudaStream_t st) {
  if (K <= 4) return wta_launch<T, 4>(vp, nvol, npix, K, uniq, sub, maps, uok, st);
  if (K <= 8) return wta_launch<T, 8>(vp, nvol, npix, K, uniq, sub, maps, uok, st);
  if (K <= 16) return wta_launch<T, 16>(vp, nvol, npix, K, uniq, sub, maps, uok, st);
  if (K <= 32) return wta_launch<T, 32>(vp, nvol, npix, K, uniq, sub, maps, uok, st);
  return wta_launch<T, 64>(vp, nvol, npix, K, uniq, sub, maps, uok, st);
}

}  // namespace

// nvol (2-4) (npix, K) volumes of one type (`bytes` 2: int16, 4: int32; a
// pixel's lanes lane_stride(K) apart, 16-byte aligned) -> minS, best and
// either sub16 (sub) or sm, s0, sp (int32), and the uniqueness verdict
// (uint8); 1 <= K <= 64, npix < 2^31. m3/m4 and v2/v3 may be null when
// unused. One device launch.
SVT_EXPORT int svt_banded_wta(const void* v0, const void* v1, const void* v2, const void* v3, int nvol, void* minS,
                              void* best, void* m2, void* m3, void* m4, void* uok, int npix, int K, int uniq,
                              int sub, int bytes, void* stream) {
  if (nvol < 2 || nvol > 4 || K < 1 || K > 64 || npix < 0) return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  const void* vp[4] = {v0, v1, v2, v3};
  int* maps[5] = {static_cast<int*>(minS), static_cast<int*>(best), static_cast<int*>(m2), static_cast<int*>(m3),
                  static_cast<int*>(m4)};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto u = static_cast<uint8_t*>(uok);
  if (bytes == 2) return wta_dispatch<int16_t>(vp, nvol, npix, K, uniq, sub, maps, u, st);
  if (bytes == 4) return wta_dispatch<int>(vp, nvol, npix, K, uniq, sub, maps, u, st);
  return cudaErrorInvalidValue;
}

// nvol (2-4) (npix, 16) volumes of one type + the int32 (npix) shift map ->
// the int32 pack and du maps of the fused WTA (#19); band 16 only, as the
// TPU kernel. One device launch.
SVT_EXPORT int svt_banded_wta_fused(const void* v0, const void* v1, const void* v2, const void* v3, int nvol,
                                    const void* shift, void* pack, void* du, int npix, int K, int uniq, int bytes,
                                    void* stream) {
  if (nvol < 2 || nvol > 4 || K != kFusedBand || npix < 0) return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  constexpr int NT = wta_threads(kFusedBand);
  const int blocks = (npix + NT - 1) / NT;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s = static_cast<const int*>(shift);
  const auto pk = static_cast<int*>(pack), d = static_cast<int*>(du);
  if (bytes == 2) {
    using T = int16_t;
    banded_wta_fused_kernel<T><<<blocks, NT, 0, st>>>(static_cast<const T*>(v0), static_cast<const T*>(v1),
                                                      static_cast<const T*>(v2), static_cast<const T*>(v3), nvol,
                                                      npix, uniq, s, pk, d);
  } else if (bytes == 4) {
    using T = int;
    banded_wta_fused_kernel<T><<<blocks, NT, 0, st>>>(static_cast<const T*>(v0), static_cast<const T*>(v1),
                                                      static_cast<const T*>(v2), static_cast<const T*>(v3), nvol,
                                                      npix, uniq, s, pk, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
