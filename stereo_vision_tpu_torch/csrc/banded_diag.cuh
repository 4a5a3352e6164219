// The 8-path vertical scan of the hierarchical matcher: the vertical carry
// and the two diagonal carries of each direction set.
//
// Replaces stereo_vision_tpu/stereo/banded_pallas.py:1093 banded_reduce_pack
// -> _vert_kernel:666 with diagonals (num_paths >= 8), with the carry
// semantics that banded.cu's header sets out (per-step deltas for any shift
// map; +-2G diagonal shifts when 2G < K; a diagonal predecessor outside the
// frame is a zero carry). Its own sources, one a storage type
// (banded_diag.cu: int16, banded_diag32.cu: int32), so that their
// instantiations (5 bands x 3 columns a thread, each band above 8 with a
// second copy at a constant K) compile beside banded.cu's.
//
// What bounds it on an H100: bytes, as banded_vertical_kernel: it reads one
// volume and writes two (hier4x8 full level, 32 frames, K=4: ~190 us at
// 3.35 TB/s), plus a chain of H dependent row steps.
//
// Design: a diagonal carry moves one column per row, so one block per
// (frame, direction) walks the rows; each thread owns CPT columns (CPT =
// ceil(Wv / 1024)), keeps their vertical carries in registers, prefetches the
// next row's cost, and exchanges the two diagonal carry sets with its
// neighbours through a ping-pong pair of rows (one __syncthreads per row) in
// shared memory, or in an L2-resident device scratch where the rows
// (4 * Wv * K values of T) exceed it. One launch replaces the per-row
// launches a row-parallel design would take (the exact path's vertical takes
// 720).

#pragma once

#include "banded.cuh"

namespace {

constexpr int kDiagMaxThreads = 1024;

// One block per (frame, direction): blockIdx.y = 0 scans down, 1 up (the
// y-flipped volume with the same column shifts). Thread t owns the columns
// x = t + j * blockDim.x, j < CPT. Per row, each column updates its vertical
// carry (predecessor (y', x)), its (1,1) diagonal carry (predecessor
// (y', x - 1)) and its (-1,1) one (predecessor (y', x + 1)), y' the row
// visited before, and stores their sum. Carry buffer: [2 rows][2 sets][Wv][K]
// of T (a carry is at most cost_bound + P2), in shared memory, or at
// scratch + (frame * 2 + direction) * 4 * Wv * K when scratch is given.
template <typename T, int KP, int CPT>
__device__ __forceinline__ void diag_scan(const T* __restrict__ C, const int* __restrict__ shift,
                                          T* __restrict__ out_dn, T* __restrict__ out_up, T* scratch, int H, int Wv,
                                          int K, int G, int P1, int P2) {
  extern __shared__ __align__(16) unsigned char carry_smem[];
  const int b = blockIdx.x, up = blockIdx.y;
  const size_t plane = (size_t)Wv * K;
  T* carry = scratch ? scratch + ((size_t)b * 2 + up) * 4 * plane : reinterpret_cast<T*>(carry_smem);
  const T* Cb = C + (size_t)b * H * plane;
  T* Ob = (up ? out_up : out_dn) + (size_t)b * H * plane;
  const int* Sb = shift + (size_t)b * H * Wv;
  const int step = up ? -1 : 1;
  int y = up ? H - 1 : 0;

  int Lv[CPT][KP], sprev[CPT];
  svt::RawLanes<T, KP> nxt[CPT];
  int snxt[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int x = threadIdx.x + j * blockDim.x;
    if (x < Wv) {
      nxt[j].load(Cb + ((size_t)y * Wv + x) * K, K);
      snxt[j] = Sb[(size_t)y * Wv + x];
    }
  }
  for (int t = 0; t < H; ++t, y += step) {
    svt::RawLanes<T, KP> cur[CPT];
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
          nxt[j].load(Cb + ((size_t)(y + step) * Wv + x) * K, K);
          snxt[j] = Sb[(size_t)(y + step) * Wv + x];
        }
      }
    }
    const T* rd = carry + (size_t)(t & 1) * 2 * plane;  // the previous row's diagonal carries
    T* wr = carry + (size_t)((t + 1) & 1) * 2 * plane;
    const int* sp = Sb + (size_t)(y - step) * Wv;  // the previous row's shifts (t > 0)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int x = threadIdx.x + j * blockDim.x;
      if (x >= Wv) continue;
      int c[KP], Ld[KP], Lu[KP];
      cur[j].unpack(K, c, svt::kBig);
      const int sy = scur[j];
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < KP; ++k) Lv[j][k] = Ld[k] = Lu[k] = c[k];
      } else {
        svt::banded_step<KP>(c, Lv[j], sy - sprev[j], K, G, P1, P2);
        if (x > 0) {
          svt::load_lanes<T, KP>(rd + (size_t)(x - 1) * K, K, Ld, svt::kBig);
          svt::banded_step<KP, true>(c, Ld, sy - sp[x - 1], K, G, P1, P2);
        } else {
#pragma unroll
          for (int k = 0; k < KP; ++k) Ld[k] = c[k];  // a zero carry from outside the frame
        }
        if (x + 1 < Wv) {
          svt::load_lanes<T, KP>(rd + plane + (size_t)(x + 1) * K, K, Lu, svt::kBig);
          svt::banded_step<KP, true>(c, Lu, sy - sp[x + 1], K, G, P1, P2);
        } else {
#pragma unroll
          for (int k = 0; k < KP; ++k) Lu[k] = c[k];
        }
      }
      sprev[j] = sy;
      svt::store_lanes<T, KP>(wr + (size_t)x * K, K, Ld);
      svt::store_lanes<T, KP>(wr + plane + (size_t)x * K, K, Lu);
#pragma unroll
      for (int k = 0; k < KP; ++k) Ld[k] += Lv[j][k] + Lu[k];
      svt::store_lanes<T, KP>(Ob + ((size_t)y * Wv + x) * K, K, Ld);
    }
    __syncthreads();
  }
}

// K == KP takes a copy of the scan in which K is a constant, so that the
// band's masks fold away and the power-of-two bands run as before.
template <typename T, int KP, int CPT>
__global__ void __launch_bounds__(kDiagMaxThreads)
banded_vertical_diag_kernel(const T* __restrict__ C, const int* __restrict__ shift, T* __restrict__ out_dn,
                            T* __restrict__ out_up, T* scratch, int H, int Wv, int K, int G, int P1, int P2) {
  if (KP <= 8 || K == KP) {  // K % 4 == 0 leaves K == KP for KP <= 8
    diag_scan<T, KP, CPT>(C, shift, out_dn, out_up, scratch, H, Wv, KP, G, P1, P2);
  } else {
    diag_scan<T, KP, CPT>(C, shift, out_dn, out_up, scratch, H, Wv, K, G, P1, P2);
  }
}

template <typename T, int KP, int CPT>
cudaError_t diag_launch(const T* C, const int* s, T* dn, T* up, T* scratch, int P, int H, int Wv, int K, int G,
                        int P1, int P2, cudaStream_t st) {
  const int threads = ((Wv + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t smem = scratch ? 0 : (size_t)4 * Wv * K * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(banded_vertical_diag_kernel<T, KP, CPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  banded_vertical_diag_kernel<T, KP, CPT><<<dim3(P, 2), threads, smem, st>>>(C, s, dn, up, scratch, H, Wv, K, G, P1,
                                                                              P2);
  return cudaGetLastError();
}

template <typename T, int KP>
cudaError_t diag_for_cpt(const void* C, const int* s, void* dn, void* up, void* scratch, int P, int H, int Wv, int K,
                         int G, int P1, int P2, cudaStream_t st) {
  const auto c = static_cast<const T*>(C);
  const auto d = static_cast<T*>(dn), u = static_cast<T*>(up), w = static_cast<T*>(scratch);
  switch ((Wv + kDiagMaxThreads - 1) / kDiagMaxThreads) {
    case 1: return diag_launch<T, KP, 1>(c, s, d, u, w, P, H, Wv, K, G, P1, P2, st);
    case 2: return diag_launch<T, KP, 2>(c, s, d, u, w, P, H, Wv, K, G, P1, P2, st);
    case 3:
    case 4: return diag_launch<T, KP, 4>(c, s, d, u, w, P, H, Wv, K, G, P1, P2, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t diag_for_band(const void* C, const int* s, void* dn, void* up, void* scratch, int P, int H, int Wv, int K,
                          int G, int P1, int P2, cudaStream_t st) {
  if (K < 4 || K > 64 || K % 4) return cudaErrorInvalidValue;
  if (K <= 4) return diag_for_cpt<T, 4>(C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
  if (K <= 8) return diag_for_cpt<T, 8>(C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
  if (K <= 16) return diag_for_cpt<T, 16>(C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
  if (K <= 32) return diag_for_cpt<T, 32>(C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
  return diag_for_cpt<T, 64>(C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, st);
}

// The entry points of banded_diag.cu (T = int16_t) and banded_diag32.cu (T =
// int), below: one library a storage type.

// Bytes of device scratch that svt_banded_vertical_diag needs for P frames on
// `device`: 0 where a block's carry rows (4 * Wv * K values of T) fit the
// device's opt-in shared memory per block, else those bytes for each (frame,
// direction) block; -1 for a width the kernel does not take (Wv > 4096) or a
// failed device query.
template <typename T>
long long diag_scratch_bytes(int P, int Wv, int K, int device) {
  if (Wv < 1 || Wv > 4 * kDiagMaxThreads) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  const long long carries = 4LL * Wv * K * (long long)sizeof(T);
  return carries <= optin ? 0 : 2LL * P * carries;
}

// (P, H, Wv, K) cost + (P, H, Wv) shift map -> the down and up sets of the
// 8-path vertical (each the sum of its vertical and two diagonal carries),
// every volume of T. scratch: null for the carries in shared memory, else the
// device memory that diag_scratch_bytes asks for. Wv <= 4096.
template <typename T>
int diag_entry(const void* C, const void* shift, void* dn, void* up, void* scratch, int P, int H, int Wv, int K,
               int G, int P1, int P2, void* stream) {
  if (Wv < 1 || Wv > 4 * kDiagMaxThreads) return cudaErrorInvalidValue;
  if (P == 0 || H == 0) return cudaSuccess;
  return diag_for_band<T>(C, static_cast<const int*>(shift), dn, up, scratch, P, H, Wv, K, G, P1, P2,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace
