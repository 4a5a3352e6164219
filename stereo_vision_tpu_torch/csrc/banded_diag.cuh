// The 8-path vertical scan of the hierarchical matcher (#17 with
// diagonals): the vertical carry and the two diagonal carries of each
// direction set.
//
// Replaces stereo_vision_tpu/stereo/banded_pallas.py:1093 banded_reduce_pack
// -> _vert_kernel:666 with diagonals (num_paths >= 8), with the carry
// semantics that banded.cu's header sets out (per-step deltas for any shift
// map; +-2G diagonal shifts when 2G < K; a diagonal predecessor outside the
// frame is a zero carry). Its own sources, one a storage type
// (banded_diag.cu: int16, banded_diag32.cu: int32), one instantiation of
// each form a power-of-two band.
//
// What bounds it on an H100: bytes, as the vertical scan without diagonals:
// it reads one volume and the shift map and writes two (hier4x8 full level,
// 32 frames of 720 rows, 1152 columns, K=4, int16: 212 MB read, 424 MB
// written, a 106 MB shift map: 0.222 ms at 3.35 TB/s). Its ~30 operations a
// lane and row (three carries) take ~0.08 ms at 67 T/s, but they are a
// chain of H dependent row steps in which each column needs its neighbours'
// diagonal carries of the row before, so what held the first design back
// was the chain: one block a (frame, direction) walked the rows, 64 blocks
// on 132 SMs at hier4x8, each row ending at a block barrier after the
// neighbours' carries went through shared memory and the previous row's
// shifts were reloaded from device memory (2.47 us a row).
//
// Design (the cluster form): a thread block cluster of CS blocks a (frame,
// direction) chain, one column a thread, so that the 2P chains spread over
// 2P * CS blocks (all SMs at hier4x8: clusters of 2). Each thread keeps its
// three carries in registers and a ring of S rows of its column's cost and
// shift in shared memory, filled by cp.async S rows ahead (banded.cu's
// ring). Per row, the x -+ 1 diagonal carries of the row before and their
// shifts come from the neighbouring lanes by warp shuffles; only a warp's
// edge lanes read them from shared memory (entries each warp's lanes 0 and
// 31 write), and one block barrier a row orders those. Across blocks, each
// block also walks a halo of kDiagHalo columns on each side of its own:
// their carries stay exact for kDiagHalo rows (see diag_cluster), so the
// blocks exchange edge carries through distributed shared memory once every
// kDiagHalo rows, behind one cluster barrier, instead of once a row. The
// plan (banded_cuda.vertical_plan) picks CS from the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters, svt_banded_diag_clusters).
// A width that no cluster of at most 16 blocks covers (NT is at most
// diag_max_threads) takes the strips form: one block a chain walks its
// columns in strips of NT, all three carry rows in device scratch, a block
// barrier a row; it is the general form, on no main path.
//
// What holds it back (PERF.md): the row steps' instructions and their
// latency. Each column runs three banded steps a row (~35 instructions
// each) with the ring, shuffles, entries and the block barrier around them,
// ~20 warps an SM; a clock64 profile of one warp (tools/kernel_variants/
// banded_vertical.py --knobs) spends about half of a row's cycles in the
// three steps, a seventh taking the row from the ring, and under a tenth at
// the barrier or the exchange.

#pragma once

#include <cooperative_groups.h>

#include "banded.cuh"

namespace {

namespace cg = cooperative_groups;
using svt::kBig;

// Threads a block of the cluster form may have at band KP (its carries and
// cost take ~4 KP registers a thread).
__host__ __device__ constexpr int diag_max_threads(int kp) { return kp <= 4 ? 1024 : kp <= 16 ? 512 : kp == 32 ? 256 : 128; }
constexpr int kStripThreads = 256;  // threads a block of the strips form, at most
constexpr int kDiagHalo = 32;  // halo columns on each side of a block's own, and rows between exchanges

struct DiagArgs {
  const void* C;
  const int* s;
  void* dn;
  void* up;
  void* scratch;  // the strips form's carry rows
  int H, Wv, K, G, P1, P2, S;
};

// Bytes of the cluster form's shared memory for NT threads (CS > 1: NT - 2
// kDiagHalo own columns): the ring (S slots of NT cost slots, then of NT
// shifts), the edge entries ([2 rows][NW][2][KP + 4] ints: side 0 lane 31's
// (1,1) carry, side 1 lane 0's (-1,1) carry) and, CS > 1, the mailboxes
// ([2][2 sides][kDiagHalo][KP] ints).
__host__ __device__ constexpr size_t diag_smem_bytes(int K, int KP, int elem, int NT, int S, int CS) {
  return (size_t)S * NT * (((svt::lane_stride(K) * elem + 15) / 16 * 16) + 4) +
         (size_t)2 * (NT / 32) * 2 * (KP + 4) * 4 +
         (CS > 1 ? (size_t)4 * kDiagHalo * KP * 4 : 0);
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// One cluster a (frame, direction): blockIdx.x = the block's rank (gridDim.x
// = CS), blockIdx.y = frame, blockIdx.z = 0 down, 1 up (the y-flipped
// volume with the same column shifts). Block `rank` owns the SW columns from
// rank * SW and runs NT = SW + 2 h threads: thread i walks column x = rank *
// SW - h + i, so that the h columns on each side of its own (a halo) are
// walked twice, by it and by the neighbour that owns them (h = kDiagHalo; 0
// for one block a cluster). A (1,1) carry moves one column right a row and
// a (-1,1) carry one column left, so the halo's carries stay exact for h
// rows after they are taken from their owner: the left halo's (1,1) carries
// lose one column a row from its outer edge, the right halo's (-1,1)
// carries the same, and after h rows only the block's own columns are
// exact. Every h rows the blocks exchange them: each owner writes its h
// edge columns' carries into the neighbour's mailbox (distributed shared
// memory) and one cluster barrier orders them, instead of one a row.
template <typename T, int KP>
__device__ __forceinline__ void diag_cluster(const DiagArgs& a, int K) {
  constexpr int EP = KP + 4;  // an edge entry: a carry (KP ints) and the shift of its row, padded
  constexpr int CW = (KP * (int)sizeof(T) + 15) / 16;  // 16-byte words of a cost slot, at most
  extern __shared__ __align__(16) unsigned char diag_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, CS = gridDim.x;
  const int NT = blockDim.x, NW = NT >> 5, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = CS > 1 ? kDiagHalo : 0, SW = NT - 2 * h;
  const int b = blockIdx.y, up = blockIdx.z;
  const int H = a.H, Wv = a.Wv, S = a.S, G = a.G, P1 = a.P1, P2 = a.P2;
  const int x = rank * SW - h + tid;
  const bool live = x >= 0 && x < Wv;                 // in the frame: it loads its column
  const bool own = live && tid >= h && tid < h + SW;  // its sums are this block's to store
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const int CB = (KS * (int)sizeof(T) + 15) / 16 * 16;
  unsigned char* cring = diag_smem + (size_t)tid * CB;
  int* sring = reinterpret_cast<int*>(diag_smem + (size_t)S * NT * CB) + tid;
  int* edges = reinterpret_cast<int*>(diag_smem + (size_t)S * NT * (CB + 4));  // [2][NW][2][EP]
  int* mail = edges + 2 * NW * 2 * EP;  // [2 exchanges][2 sides][h][KP]: side 0 from the left, 1 from the right
  auto edge = [&](int slot, int w, int side) { return edges + ((slot * NW + w) * 2 + side) * EP; };
  auto mailbox = [&](int* base, int slot, int side, int j) { return base + ((slot * 2 + side) * h + j) * KP; };

  const size_t plane = (size_t)Wv * KS;
  const int xc = live ? x : 0;
  const T* Cb = static_cast<const T*>(a.C) + (size_t)b * H * plane + (size_t)xc * KS;
  const int* Sb = a.s + (size_t)b * H * Wv + xc;
  T* Ob = static_cast<T*>(up ? a.up : a.dn) + (size_t)b * H * plane + (size_t)xc * KS;
  // A band in memory is a multiple of 8 bytes.
  const int nbytes = KS * (int)sizeof(T), unit = nbytes % 16 == 0 ? 16 : 8;
  auto row_of = [&](int i) { return up ? H - 1 - i : i; };
  auto issue = [&](int i) {
    if (live && i < H) {
      const int y = row_of(i), slot = i & (S - 1);
      svt::cp_async_run(cring + (size_t)slot * NT * CB, Cb + (size_t)y * plane, nbytes, unit);
      svt::cp_async(sring + (size_t)slot * NT, Sb + (size_t)y * Wv, 4);
    }
    svt::cp_async_commit();
  };
  // Row t's cost and shift from the ring (its copy group has landed).
  auto take = [&](int t, int (&c)[KP]) {
    svt::cp_async_wait_ring(S);
    const int slot = t & (S - 1);
    int4 raw[CW];
    const int4* cw = reinterpret_cast<const int4*>(cring + (size_t)slot * NT * CB);
#pragma unroll
    for (int w = 0; w < CW; ++w)
      if (16 * w < CB) raw[w] = cw[w];
    const T* hv = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int k = 0; k < KP; ++k) c[k] = k < K ? static_cast<int>(hv[k]) : kBig;
    return sring[(size_t)slot * NT];
  };

  int Lv[KP], Ld[KP], Lu[KP];
  // The end of row t: every h rows the exchange of the edge columns'
  // carries; this warp's edge entries (lane 31's (1,1) carry, lane 0's
  // (-1,1) carry, each with its row's shift), the row's sums, the ring's
  // next copy, and the block barrier that orders the entries.
  int exchanges = 0;
  auto finish = [&](int t, int sy) {
    if (h > 0 && t > 0 && t % h == 0 && t + 1 < H) {
      // The owner of the h columns beside each halo writes their row-t
      // carries into the neighbour's mailbox ((-1,1) carries of the first
      // h own columns to the left, (1,1) of the last h to the right); the
      // halo threads take them after the cluster barrier, before the edge
      // entries below are written from them. Mailboxes alternate, so that a
      // neighbour h rows ahead writes the other one.
      const int slot = (t / h) & 1;
      if (exchanges++ == 0) cluster_wait();  // every block has started (the arrival at the top)
      if (tid >= h && tid < 2 * h && rank > 0) {
        int* m = mailbox(cluster.map_shared_rank(mail, rank - 1), slot, 1, tid - h);
#pragma unroll
        for (int k = 0; k < KP; ++k) m[k] = Lu[k];
      }
      if (tid >= NT - 2 * h && tid < NT - h && rank + 1 < CS) {
        int* m = mailbox(cluster.map_shared_rank(mail, rank + 1), slot, 0, tid - (NT - 2 * h));
#pragma unroll
        for (int k = 0; k < KP; ++k) m[k] = Ld[k];
      }
      cluster_arrive();
      cluster_wait();
      if (tid < h && rank > 0) {
        const int* m = mailbox(mail, slot, 0, tid);
#pragma unroll
        for (int k = 0; k < KP; ++k) Ld[k] = m[k];
      }
      if (tid >= NT - h && rank + 1 < CS) {
        const int* m = mailbox(mail, slot, 1, tid - (NT - h));
#pragma unroll
        for (int k = 0; k < KP; ++k) Lu[k] = m[k];
      }
    }
    if (lane == 31) {
      int* e = edge(t & 1, warp, 0);
#pragma unroll
      for (int k = 0; k < KP; ++k) e[k] = Ld[k];
      e[KP] = sy;
    }
    if (lane == 0) {
      int* e = edge(t & 1, warp, 1);
#pragma unroll
      for (int k = 0; k < KP; ++k) e[k] = Lu[k];
      e[KP] = sy;
    }
    if (own) {
      int sum[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) sum[k] = Lv[k] + Ld[k] + Lu[k];
      svt::store_lanes<T, KP>(Ob + (size_t)row_of(t) * plane, K, sum);
    }
    issue(t + S);  // into the slot read last: its values are consumed above
    __syncthreads();  // the row's edge entries are written before the next row reads them
  };

  if (h > 0) cluster_arrive_relaxed();  // waited for before the first exchange
  for (int i = 0; i < S; ++i) issue(i);
  int sprev;
  {
    int c[KP];
    sprev = take(0, c);
#pragma unroll
    for (int k = 0; k < KP; ++k) Lv[k] = Ld[k] = Lu[k] = c[k];  // every carry starts from zero
    finish(0, sprev);
  }
  for (int t = 1; t < H; ++t) {
    int c[KP];
    const int sy = take(t, c);
    svt::banded_step<KP>(c, Lv, sy - sprev, K, G, P1, P2);
    // The previous row's (1,1) carry of column x - 1 and (-1,1) carry of
    // x + 1, with the shifts they were computed at: neighbouring lanes, and
    // at a warp's edges the entries of the warp beside it. The block's
    // outermost threads have no column beside them: a zero carry (exact at
    // the frame's edge; elsewhere a halo column that is no longer exact).
    int dL[KP], dR[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      dL[k] = __shfl_up_sync(svt::kFullMask, Ld[k], 1);
      dR[k] = __shfl_down_sync(svt::kFullMask, Lu[k], 1);
    }
    int spL = __shfl_up_sync(svt::kFullMask, sprev, 1), spR = __shfl_down_sync(svt::kFullMask, sprev, 1);
    const int ps = (t - 1) & 1;
    if (lane == 0 && warp > 0) {
      const int* e = edge(ps, warp - 1, 0);
#pragma unroll
      for (int k = 0; k < KP; ++k) dL[k] = e[k];
      spL = e[KP];
    }
    if (lane == 31 && warp + 1 < NW) {
      const int* e = edge(ps, warp + 1, 1);
#pragma unroll
      for (int k = 0; k < KP; ++k) dR[k] = e[k];
      spR = e[KP];
    }
    if (x > 0 && tid > 0) {
      svt::banded_step<KP, true>(c, dL, sy - spL, K, G, P1, P2);
    } else {
#pragma unroll
      for (int k = 0; k < KP; ++k) dL[k] = c[k];  // a zero carry from outside the frame
    }
    if (x + 1 < Wv && tid + 1 < NT) {
      svt::banded_step<KP, true>(c, dR, sy - spR, K, G, P1, P2);
    } else {
#pragma unroll
      for (int k = 0; k < KP; ++k) dR[k] = c[k];
    }
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      Ld[k] = dL[k];
      Lu[k] = dR[k];
    }
    sprev = sy;
    finish(t, sy);
  }
  if (h > 0 && exchanges == 0) cluster_wait();  // the arrival at the top, where no exchange took it
}

// K == KP takes a copy in which K is a constant, so that the band's masks
// fold away and the power-of-two bands run as before.
template <typename T, int KP>
__global__ void __launch_bounds__(diag_max_threads(KP)) banded_diag_cluster_kernel(DiagArgs a) {
  if (a.K == KP) {
    diag_cluster<T, KP>(a, KP);
  } else {
    diag_cluster<T, KP>(a, a.K);
  }
}

// The strips form: one block a (frame, direction) walks the rows; thread t
// takes columns t, t + NT, ...; the carry rows ping-pong in device scratch
// ([2 rows][3 carries][Wv][K] of T a chain), a block barrier a row.
template <typename T, int KP>
__device__ __forceinline__ void diag_strips(const DiagArgs& a, int K) {
  const int b = blockIdx.x, up = blockIdx.y, NT = blockDim.x;
  const int H = a.H, Wv = a.Wv, G = a.G, P1 = a.P1, P2 = a.P2;
  const int KS = svt::lane_stride(K);  // a pixel's lanes in memory
  const size_t plane = (size_t)Wv * KS;
  const T* Cb = static_cast<const T*>(a.C) + (size_t)b * H * plane;
  const int* Sb = a.s + (size_t)b * H * Wv;
  T* Ob = static_cast<T*>(up ? a.up : a.dn) + (size_t)b * H * plane;
  T* car = static_cast<T*>(a.scratch) + ((size_t)b * 2 + up) * 6 * plane;
  const int step = up ? -1 : 1;
  int y = up ? H - 1 : 0;
  for (int t = 0; t < H; ++t, y += step) {
    const T* rd = car + (size_t)((t + 1) & 1) * 3 * plane;  // the previous row's carries
    T* wr = car + (size_t)(t & 1) * 3 * plane;
    const int* sp = Sb + (size_t)(y - step) * Wv;  // the previous row's shifts (t > 0)
    for (int x = threadIdx.x; x < Wv; x += NT) {
      int c[KP], Lv[KP], Ld[KP], Lu[KP];
      svt::load_lanes<T, KP>(Cb + ((size_t)y * Wv + x) * KS, K, c, kBig);
      const int sy = Sb[(size_t)y * Wv + x];
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < KP; ++k) Lv[k] = Ld[k] = Lu[k] = c[k];
      } else {
        svt::load_lanes<T, KP>(rd + (size_t)x * KS, K, Lv, kBig);
        svt::banded_step<KP>(c, Lv, sy - sp[x], K, G, P1, P2);
        if (x > 0) {
          svt::load_lanes<T, KP>(rd + plane + (size_t)(x - 1) * KS, K, Ld, kBig);
          svt::banded_step<KP, true>(c, Ld, sy - sp[x - 1], K, G, P1, P2);
        } else {
#pragma unroll
          for (int k = 0; k < KP; ++k) Ld[k] = c[k];
        }
        if (x + 1 < Wv) {
          svt::load_lanes<T, KP>(rd + 2 * plane + (size_t)(x + 1) * KS, K, Lu, kBig);
          svt::banded_step<KP, true>(c, Lu, sy - sp[x + 1], K, G, P1, P2);
        } else {
#pragma unroll
          for (int k = 0; k < KP; ++k) Lu[k] = c[k];
        }
      }
      svt::store_lanes<T, KP>(wr + (size_t)x * KS, K, Lv);
      svt::store_lanes<T, KP>(wr + plane + (size_t)x * KS, K, Ld);
      svt::store_lanes<T, KP>(wr + 2 * plane + (size_t)x * KS, K, Lu);
#pragma unroll
      for (int k = 0; k < KP; ++k) Ld[k] += Lv[k] + Lu[k];
      svt::store_lanes<T, KP>(Ob + ((size_t)y * Wv + x) * KS, K, Ld);
    }
    __syncthreads();  // the row's carries are written before the next row reads them
  }
}

template <typename T, int KP>
__global__ void __launch_bounds__(kStripThreads) banded_diag_strips_kernel(DiagArgs a) {
  if (a.K == KP) {
    diag_strips<T, KP>(a, KP);
  } else {
    diag_strips<T, KP>(a, a.K);
  }
}

cudaLaunchConfig_t diag_cluster_config(int CS, int P, int NT, size_t smem, cudaStream_t st,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, P, 2);
  cfg.blockDim = dim3(NT);
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

// The plan's forms (banded_cuda.vertical_plan): 0 the cluster form, 1 the strips form.
constexpr int kDiagCluster = 0, kDiagStrips = 1;

template <typename T, int KP>
struct DiagFn {
  // The cluster kernel with its attributes set for `smem` bytes.
  static cudaError_t prepare(size_t smem) {
    const auto kern = banded_diag_cluster_kernel<T, KP>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return e;
  }
  static bool cluster_ok(int K, int CS, int NT, int S) {
    return CS >= 1 && CS <= 16 && NT >= 32 && NT % 32 == 0 && NT <= diag_max_threads(KP) &&
           (S == 2 || S == 4 || S == 8 || S == 16);
  }
  static cudaError_t run(const DiagArgs& a, int P, int form, int CS, int NT, cudaStream_t st) {
    if (form == kDiagStrips) {
      if (!a.scratch || NT < 32 || NT > kStripThreads || NT % 32) return cudaErrorInvalidValue;
      banded_diag_strips_kernel<T, KP><<<dim3(P, 2), NT, 0, st>>>(a);
      return cudaGetLastError();
    }
    const int h = CS > 1 ? kDiagHalo : 0;  // the plan's NT counts the halos
    if (form != kDiagCluster || !cluster_ok(a.K, CS, NT, a.S) || NT <= 2 * h || (long long)CS * (NT - 2 * h) < a.Wv)
      return cudaErrorInvalidValue;
    const size_t smem = diag_smem_bytes(a.K, KP, sizeof(T), NT, a.S, CS);
    cudaError_t e = prepare(smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = diag_cluster_config(CS, P, NT, smem, st, &attr);
    e = cudaLaunchKernelEx(&cfg, banded_diag_cluster_kernel<T, KP>, a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  // Clusters of CS blocks of NT threads with an S-row ring that the current
  // device holds at once (0: none; negative: a CUDA error).
  static int clusters(int K, int CS, int NT, int S) {
    if (!cluster_ok(K, CS, NT, S)) return 0;
    const size_t smem = diag_smem_bytes(K, KP, sizeof(T), NT, S, CS);
    cudaError_t e = prepare(smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return 0;  // more shared memory than a block takes
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = diag_cluster_config(CS, 1, NT, smem, nullptr, &attr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, banded_diag_cluster_kernel<T, KP>, &cfg) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    return active;
  }
};

template <typename T>
cudaError_t diag_entry(const DiagArgs& a, int P, int form, int CS, int NT, cudaStream_t st) {
  const int K = a.K;
  if (K < 1 || K > 64) return cudaErrorInvalidValue;
  if (P == 0 || a.H == 0 || a.Wv == 0) return cudaSuccess;
  if (K <= 4) return DiagFn<T, 4>::run(a, P, form, CS, NT, st);
  if (K <= 8) return DiagFn<T, 8>::run(a, P, form, CS, NT, st);
  if (K <= 16) return DiagFn<T, 16>::run(a, P, form, CS, NT, st);
  if (K <= 32) return DiagFn<T, 32>::run(a, P, form, CS, NT, st);
  return DiagFn<T, 64>::run(a, P, form, CS, NT, st);
}

template <typename T>
int diag_clusters(int K, int CS, int NT, int S) {
  if (K < 1 || K > 64) return 0;
  if (K <= 4) return DiagFn<T, 4>::clusters(K, CS, NT, S);
  if (K <= 8) return DiagFn<T, 8>::clusters(K, CS, NT, S);
  if (K <= 16) return DiagFn<T, 16>::clusters(K, CS, NT, S);
  if (K <= 32) return DiagFn<T, 32>::clusters(K, CS, NT, S);
  return DiagFn<T, 64>::clusters(K, CS, NT, S);
}

}  // namespace

// The entry points of banded_diag.cu (T = int16_t) and banded_diag32.cu
// (T = int), one library a storage type; SVT_DIAG_T names the type.

// (P, H, Wv, K) cost + (P, H, Wv) shift map -> the down and up sets of the
// 8-path vertical (each the sum of its vertical and two diagonal carries),
// every volume of T, by the plan banded_cuda.vertical_plan gave: form 0
// (clusters of CS blocks of NT threads, an S-row ring; CS * NT >= Wv) or 1
// (one block of NT threads a chain; scratch: 12 * P * Wv * lane_stride(K)
// values of T).
SVT_EXPORT int svt_banded_vertical_diag(const void* C, const void* shift, void* dn, void* up, void* scratch, int P,
                                        int H, int Wv, int K, int G, int P1, int P2, int form, int CS, int NT, int S,
                                        void* stream) {
  const DiagArgs a{C, static_cast<const int*>(shift), dn, up, scratch, H, Wv, K, G, P1, P2, S};
  return diag_entry<SVT_DIAG_T>(a, P, form, CS, NT, static_cast<cudaStream_t>(stream));
}

// Clusters of the cluster form (CS blocks of NT threads, an S-row ring, band
// K) that the current device holds at once: 0 where it holds none.
SVT_EXPORT int svt_banded_diag_clusters(int K, int CS, int NT, int S) {
  return diag_clusters<SVT_DIAG_T>(K, CS, NT, S);
}
