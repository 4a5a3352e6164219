// Band-limited SGBM core of the hierarchical matcher (matcher="sgbm_hier").
//
// Replaces the kernel bodies of stereo_vision_tpu/stereo/banded_pallas.py
// that banded_stats_pack chains:
//   _pix_kernel + _aligned_box_kernel(_srows) -> banded_cost_kernel (banded_cost.cu)
//   _vert_kernel (without diagonals)          -> banded_vertical_kernel
//   _vert_kernel (with diagonals, 8 paths)    -> banded_diag.cuh
//   _horiz_kernel                             -> banded_line_kernel (banded_group.cuh)
//   _wta_kernel (4-stat sub form and 6-stat)  -> banded_wta_kernel (banded_wta.cu)
//   _wta_fused_kernel (band 16)               -> banded_wta_fused_kernel (banded_wta.cu)
// The image pyramid's box mean (_downsample_kernel) is downsample.cu's.
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
// otherwise, and every kernel is one template over T; a pixel's lanes lie
// lane_stride(K) (K rounded up to 4) apart. The cost kernel (banded_cost.cu)
// takes any K >= 1 at run time; the scans here take K up to 64 (banded.cuh:
// instantiated at the next power of two, at least 4, K at run time),
// banded_wide.cu and banded_wide32.cu the bands above 64. The TPU
// kernels' 128-lane frame packing, float32-for-int and tile-entry delta
// rows are not carried over.
//
// What bounds them on an H100 (hier4x3 full-res level, 32 frames of
// 1280x720, K=4, 1152 valid columns; one int16 volume = 212 MB): the cost
// kernel writes one volume and reads the images and shift map (~169 us at
// 3.35 TB/s); vertical reads one and writes two (~222 us with the shift
// map); each horizontal reads one and writes one (~127 us); the WTA
// (banded_wta.cu) reads three and writes three int32 maps and a bool map
// (~293 us). The scans are also dependent chains of H (or Wv) steps.
//
// Design (right and simple first, then the cost kernel for Hopper):
//   cost: see banded_cost_kernel (banded_cost.cu).
//   vertical: see banded_vertical_kernel (redesigned for Hopper: a ring of
//     rows in shared memory a thread, fed by cp.async S rows ahead).
//   horizontal: see banded_line_kernel.
//   wta: see banded_wta.cu (both forms, the fused one too).

#include "banded_group.cuh"

namespace {

using svt::kBig;

// ------------------------------------------------------------- vertical

// The vertical scan without diagonals (#17). Replaces banded_pallas.py:1093
// banded_reduce_pack -> _vert_kernel:666 without diagonals: the down and up
// SGM scans of a (P, H, Wv, K) banded cost with its (P, H, Wv) shift map.
//
// What bounds it on an H100: bytes. It reads the cost and the shift map once
// and writes two volumes: at the hier4x3 full level (32 frames of 720 rows,
// 1152 columns, K=4, int16) one 212 MB volume read, two written and a 106 MB
// shift map, 742 MB: 0.222 ms at 3.35 TB/s (the mid level, K=8 at 360x576,
// 0.111 ms; the coarse, K=32 at 180x288, 0.015 ms; hier16x3's full level,
// K=16 on 8 frames, 0.198 ms). Its ~10 operations a lane and step take a
// fifth of that at 67 T/s. A column's recurrence runs down its H rows, so
// the loads must be in flight well before their row: to stream 3.35 TB/s at
// ~0.8 us of latency the card needs ~2.7 MB of reads in flight, ~20 KB an
// SM. The first design prefetched one row a thread (12 bytes at K=4), ~7 KB
// an SM, and ran at ~40% of the bytes bound.
//
// Design: one thread a (frame, column, direction) chain (two columns where a
// column's band is 8 bytes, K=4 in int16, so that its loads and stores are
// 16-byte words, neighbouring threads on neighbouring addresses), with its
// carries in registers. Each thread keeps a ring of S rows of its own
// columns' costs and shifts in shared memory, filled by cp.async copies
// issued S rows ahead of the chain (a copy group a row; the thread waits
// only for the oldest), so that S rows' bytes are in flight a thread without
// a register spent on them. The plan (banded_cuda.vertical_plan) sizes the
// block so that the grid covers every SM at each level, and S so that an SM
// keeps ~32 KB of reads in flight within its shared memory. The threads
// share nothing, so no barrier runs; lane shifts by a runtime delta use a
// barrel shifter over compile-time offsets. Where a wide band (K >= 16) has
// too few chains to fill the SMs a thread each (hier16x3's coarse level),
// the plan takes the group form instead: banded_group.cuh's line kernel
// down and up every column, a group of min(K, 32) threads a chain.
//
// What holds it back (PERF.md): the stores and the access pattern. With a
// part taken out (tools/kernel_variants/banded_vertical.py --knobs), the
// loads and steps alone take 40-45% of its time at K >= 8, and the whole
// scan runs at 1.3-1.4x the time torch takes to copy the volume into two
// (one 16-byte store a thread a row, 32-column runs a warp, rows apart).
constexpr int kRingMaxThreads = 256;

// Columns a thread of the ring form holds: two where one column's band is
// 8 bytes (K = 4 in int16), else one.
template <typename T, int KP>
__host__ __device__ constexpr int ring_cpt() {
  return KP * (int)sizeof(T) == 8 ? 2 : 1;
}

// Bytes of a thread's cost slot: its columns' bands, rounded up to 16.
__host__ __device__ constexpr int ring_cost_bytes(int cpt, int K, int elem) { return (cpt * K * elem + 15) / 16 * 16; }

// Bytes of a block's ring: S slots of NT threads' costs, then of their shifts.
__host__ __device__ constexpr size_t ring_smem_bytes(int cpt, int K, int elem, int NT, int S) {
  return (size_t)S * NT * (ring_cost_bytes(cpt, K, elem) + 4 * cpt);
}

struct RingArgs {
  const void* C;
  const int* s;
  void* dn;
  void* up;
  int H, Wv, K, G, P1, P2, S;
};

// blockIdx.z = 0 scans down, 1 up; the delta is s(y) - s(previous row
// visited), 0 at the first row. A slot of the ring: [S][NT] cost slots of
// ring_cost_bytes, then [S][NT][CPT] shifts.
template <typename T, int KP>
__device__ __forceinline__ void vertical_ring(const RingArgs& a, int K) {
  constexpr int CPT = ring_cpt<T, KP>();
  constexpr int CW = (CPT * KP * (int)sizeof(T) + 15) / 16;  // 16-byte words of a cost slot, at most
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int NT = blockDim.x, tid = threadIdx.x;
  const int x = (blockIdx.x * NT + tid) * CPT;
  const int b = blockIdx.y, up = blockIdx.z;
  const int H = a.H, Wv = a.Wv, S = a.S;
  if (x >= Wv) return;  // no collective below: a thread past the frame leaves
  const int ncol = min(CPT, Wv - x);
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const int CB = ring_cost_bytes(CPT, KS, sizeof(T));
  unsigned char* cring = ring_smem + (size_t)tid * CB;
  int* sring = reinterpret_cast<int*>(ring_smem + (size_t)S * NT * CB) + tid * CPT;
  const size_t plane = (size_t)Wv * KS;
  const T* Cb = static_cast<const T*>(a.C) + (size_t)b * H * plane + (size_t)x * KS;
  const int* Sb = a.s + (size_t)b * H * Wv + x;
  T* Ob = static_cast<T*>(up ? a.up : a.dn) + (size_t)b * H * plane + (size_t)x * KS;
  // The columns' bands go as 16-byte copies where every row keeps them
  // aligned, else as 8-byte ones (a band in memory is a multiple of 8 bytes).
  const int nbytes = ncol * KS * (int)sizeof(T);
  const bool w16 = nbytes % 16 == 0 && (plane * sizeof(T)) % 16 == 0 && ((size_t)x * KS * sizeof(T)) % 16 == 0;
  const bool s8 = CPT == 2 && ncol == 2 && Wv % 2 == 0;  // both shifts as one 8-byte copy
  auto row_of = [&](int i) { return up ? H - 1 - i : i; };
  auto issue = [&](int i) {
    if (i < H) {
      const int y = row_of(i), slot = i & (S - 1);
      svt::cp_async_run(cring + (size_t)slot * NT * CB, Cb + (size_t)y * plane, nbytes, w16 ? 16 : 8);
      int* sd = sring + (size_t)slot * NT * CPT;
      const int* sg = Sb + (size_t)y * Wv;
      if (s8) {
        svt::cp_async(sd, sg, 8);
      } else {
        for (int j = 0; j < ncol; ++j) svt::cp_async(sd + j, sg + j, 4);
      }
    }
    svt::cp_async_commit();  // an empty group past the last row keeps the count
  };

  int L[CPT][KP], sprev[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    sprev[j] = 0;
#pragma unroll
    for (int k = 0; k < KP; ++k) L[j][k] = k < K ? 0 : kBig;  // the zero carry
  }
  for (int i = 0; i < S; ++i) issue(i);
  for (int t = 0; t < H; ++t) {
    svt::cp_async_wait_ring(S);  // row t has landed
    const int slot = t & (S - 1);
    int4 raw[CW];
    const int4* cw = reinterpret_cast<const int4*>(cring + (size_t)slot * NT * CB);
#pragma unroll
    for (int w = 0; w < CW; ++w)
      if (16 * w < CB) raw[w] = cw[w];
    const T* h = reinterpret_cast<const T*>(raw);
    const int* sy = sring + (size_t)slot * NT * CPT;
    const int y = row_of(t);
    T* o = Ob + (size_t)y * plane;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (j >= ncol) break;
      int c[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) c[k] = k < K ? static_cast<int>(h[j * KS + k]) : kBig;
      const int sv = sy[j];
      svt::banded_step<KP>(c, L[j], t == 0 ? 0 : sv - sprev[j], K, a.G, a.P1, a.P2);
      sprev[j] = sv;
    }
    if constexpr (CPT == 2) {
      if (ncol == 2 && w16) {  // both columns' bands in one 16-byte store
        int4 wv;
        T* hv = reinterpret_cast<T*>(&wv);
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int k = 0; k < KP; ++k) hv[j * KP + k] = static_cast<T>(L[j][k]);
        *reinterpret_cast<int4*>(o) = wv;
      } else {
        svt::store_lanes<T, KP>(o, K, L[0]);
        if (ncol == 2) svt::store_lanes<T, KP>(o + KS, K, L[1]);
      }
    } else {
      svt::store_lanes<T, KP>(o, K, L[0]);
    }
    issue(t + S);  // into the slot just read: its values are consumed above
  }
}

// kConstK (K == KP) takes a copy of the scan in which K is a constant, so
// that the band's masks fold away and the power-of-two bands run as before;
// the other bands (K % 4 != 0 at KP <= 8, any K below KP above) a kernel of
// their own, so that neither copy's registers weigh on the other's.
template <typename T, int KP, bool kConstK>
__global__ void __launch_bounds__(kRingMaxThreads) banded_vertical_kernel(RingArgs a) {
  if constexpr (kConstK) {
    vertical_ring<T, KP>(a, KP);
  } else {
    vertical_ring<T, KP>(a, a.K);
  }
}

// ------------------------------------------------------------ horizontal

// banded_line_kernel (banded_group.cuh) over the (frame, row) lines, a group
// of min(KP, 32) threads a row.

// ------------------------------------------------------------- dispatch

// Fn<T, KP>::run(args...) for the storage type of `bytes` (2: int16, 4:
// int32) and KP the power of two at or above K (at least 4; 1 <= K <= 64).
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int bytes, int K, Args... args) {
  if (K < 1 || K > 64) return cudaErrorInvalidValue;
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

// The plan's forms (banded_cuda.vertical_plan): 0 the ring form, on NT
// threads a block and S rows of ring; 1 the group form, banded_line_kernel
// (banded_group.cuh) down and up every column, a group of min(KP, 32)
// threads a column (bands of 16 and more).
constexpr int kVerticalRing = 0, kVerticalGroup = 1;

template <typename T, int KP>
struct VerticalFn {
  static cudaError_t run(const RingArgs& a, int P, int form, int NT, cudaStream_t st) {
    if (form == kVerticalGroup) {
      if constexpr (KP >= 16) {
        constexpr int GS = KP < 32 ? KP : 32;
        return line_launch<T, GS, KP / GS, true>(static_cast<const T*>(a.C), a.s, static_cast<T*>(a.dn),
                                                 static_cast<T*>(a.up), 2 * P * a.Wv, a.H, a.Wv, a.K, a.G, a.P1, a.P2,
                                                 0, st);
      }
      return cudaErrorInvalidValue;
    }
    if (form != kVerticalRing) return cudaErrorInvalidValue;
    constexpr int CPT = ring_cpt<T, KP>();
    if (NT < 32 || NT > kRingMaxThreads || NT % 32 || (a.S != 2 && a.S != 4 && a.S != 8 && a.S != 16))
      return cudaErrorInvalidValue;
    const size_t smem = ring_smem_bytes(CPT, svt::lane_stride(a.K), sizeof(T), NT, a.S);
    const auto kern = a.K == KP ? banded_vertical_kernel<T, KP, true> : banded_vertical_kernel<T, KP, false>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int cols = NT * CPT;
    kern<<<dim3((a.Wv + cols - 1) / cols, P, 2), NT, smem, st>>>(a);
    return cudaGetLastError();
  }
};

template <typename T, int KP>
struct HorizontalFn {
  static cudaError_t run(const void* C, const int* s, void* out, int rows, int Wv, int K, int G, int P1, int P2,
                         int reverse, cudaStream_t st) {
    constexpr int GS = KP < 32 ? KP : 32;
    return line_launch<T, GS, KP / GS, false>(static_cast<const T*>(C), s, static_cast<T*>(out), nullptr, rows, Wv,
                                              Wv, K, G, P1, P2, reverse, st);
  }
};

}  // namespace

// The shared memory a block of `device` may opt in to, in bytes (-1: the
// query failed): the bound of banded_cuda.vertical_plan.
SVT_EXPORT int svt_banded_smem_optin(int device) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) == cudaSuccess ? v : -1;
}

// (P, H, Wv, K) cost + (P, H, Wv) shift map -> the down and up vertical
// direction volumes, all of the type of `bytes`, by the plan
// banded_cuda.vertical_plan gave: form 0 (ring: NT threads a block, a ring
// of S rows, 2, 4, 8 or 16; its shared memory is ring_smem_bytes) or 1
// (group: K >= 16; NT and S unused).
SVT_EXPORT int svt_banded_vertical(const void* C, const void* shift, void* dn, void* up, int P, int H, int Wv, int K,
                                   int G, int P1, int P2, int bytes, int form, int NT, int S, void* stream) {
  if (P == 0 || H == 0 || Wv == 0) return cudaSuccess;
  const RingArgs a{C, static_cast<const int*>(shift), dn, up, H, Wv, K, G, P1, P2, S};
  return dispatch<VerticalFn>(bytes, K, a, P, form, NT, static_cast<cudaStream_t>(stream));
}

// (P, H, Wv, K) cost + (P, H, Wv) shift map -> one horizontal direction volume.
SVT_EXPORT int svt_banded_horizontal(const void* C, const void* shift, void* out, int P, int H, int Wv, int K, int G,
                                     int P1, int P2, int reverse, int bytes, void* stream) {
  if (P == 0 || H == 0 || Wv == 0) return cudaSuccess;
  return dispatch<HorizontalFn>(bytes, K, C, static_cast<const int*>(shift), out, P * H, Wv, K, G, P1, P2, reverse,
                                static_cast<cudaStream_t>(stream));
}
