// Disparity speckle filter (cv2.filterSpeckles semantics, optional diameter
// cap) as union-find connected components.
//
// Replaces the kernel body stereo_vision_tpu/stereo/speckle_pallas.py::
// _speckle_kernel (speckle_filter_pallas). The function is the plain form's,
// stereo_vision_tpu_torch/stereo/postprocess.py::speckle_filter, on
// (P, H, W) float32 frames: 4-connected blobs of valid pixels (d > invalid)
// whose neighbours differ by <= max_diff, with R rounds (R = S - 1, or the
// diameter cap). The plain form's rounds remove a pixel p exactly when
//   p is valid, |C| <= S and every pixel of C lies within R same-blob steps
//   of m_C, the pixel of C with the least flat index y * W + x
// (C is p's component; the JAX docstring proves that a pixel is untainted
// exactly when C converged in R rounds, and that a converged C's count is
// exact). Uncapped, |C| <= S already puts C within |C| - 1 <= R steps of
// m_C; capped, only components with R + 2 <= |C| <= S need the distance
// test. So five launches compute it, whatever R is:
//   local   one block a 32x32 tile, a warp a row: the same-blob bits
//           (float32 fabsf(q - d) <= max_diff, both valid; no fast-math
//           flags); each row's runs from one ballot (a pixel's label is its
//           run's first pixel); one union a pair of touching runs, in shared
//           memory, each link from the larger root to the smaller by
//           atomicMin, so that a root is the least flat index of its set.
//           Labels out as frame-flat indices of the tile roots (kInvalid
//           for invalid pixels); each tile root's pixels counted in shared
//           memory and written as its count, the roots listed; the edges
//           across the right and bottom borders (a one-pixel halo) kept as
//           two bit masks, leaving out an edge whose predecessor along the
//           border joins the same two runs;
//   merge   one warp a tile: each kept border edge unites its two sets in
//           device memory (Playne and Hawick's lock-free union: atomicMin on
//           the larger root, retried until it holds, the finds halving the
//           path), so a component's root stays m_C;
//   count   one warp a tile: each tile root takes its final root as its
//           label, so that every pixel's root is two loads away, and adds
//           its count to the final root's (none once that is past S: only
//           whether a count is <= S matters);
//   ecc     capped only (R < S - 1): a warp a tile takes each final root of
//           its list whose count lies in [R + 2, S] and walks C breadth
//           first from it, R levels, its queue in device memory and visited
//           pixels marked in the labels (label -1 - label). If fewer than
//           count pixels were reached, the count becomes INT_MAX and C is
//           kept. Uncapped it returns at once;
//   emit    four pixels a thread: a valid pixel becomes invalid where its
//           root's count is <= S.
// Labels never cross frames: every index is frame-flat, with the frame's
// base added.
//
// The TPU kernel ran 3R + 3 whole-frame rounds because Mosaic has no gather,
// scatter or atomics; the round-by-round CUDA port that followed it spent
// 3R + 2 launches and ~12-17 bytes of state a pixel a round. What bounds the
// function on an H100: bytes, one float map read and one written (exact8, 4
// frames of 720x1280: 29.5 MB, 0.0088 ms at 3.35 TB/s). This design moves
// ~20 bytes a pixel (the map read twice, the output written, a label
// written and read). The local pass takes over half of the time on every
// path; by an estimate from its time it is bound by its instructions, not
// its bytes (PERF.md, PR 8, has the designs timed on the way).

#include <climits>

#include "common.cuh"

namespace {

using svt::kFullMask;

constexpr int kTile = 32;     // side of a square tile; a warp holds one of its rows
constexpr int kThreads = 256;
constexpr int kKept = INT_MAX;       // count of a root whose component did not converge in R rounds
constexpr int kInvalid = INT_MIN;    // label of an invalid pixel

// Whether a valid pixel of disparity d and its neighbour q are one blob.
__device__ __forceinline__ bool linked(float d, float q, float invalid, float max_diff) {
  return q > invalid && fabsf(q - d) <= max_diff;
}

// Whether two pixels are one blob (either may be invalid).
__device__ __forceinline__ bool same_blob(float a, float b, float invalid, float max_diff) {
  return a > invalid && linked(a, b, invalid, max_diff);
}

// A label marked visited by the ecc walk reads back as the label.
__device__ __forceinline__ int unmark(int l) { return l < 0 ? -1 - l : l; }

// Root of i in the shared-memory forest L (volatile: other threads link),
// halving the path on the way: each node visited takes its grandparent, by
// atomicMin (a label only ever falls, so a concurrent link is never undone).
__device__ __forceinline__ int find_shared(volatile int* L, int i) {
  int p = L[i];
  while (p != i) {
    const int g = L[p];
    if (g != p) atomicMin(const_cast<int*>(L) + i, g);
    i = p;
    p = g;
  }
  return i;
}

// Root of i in the device-memory forest L, read through L2 (other SMs link),
// halving the path as find_shared does.
__device__ __forceinline__ int find_global(int* L, int i) {
  int p = __ldcg(L + i);
  while (p != i) {
    const int g = __ldcg(L + p);
    if (g != p) atomicMin(L + i, g);
    i = p;
    p = g;
  }
  return i;
}

// Playne and Hawick's union: link the larger root to the smaller with
// atomicMin; where another thread linked it first, retry from the value it
// found. Every link points to a smaller index, so a root is its set's least.
template <bool kShared>
__device__ __forceinline__ void unite(int* L, int a, int b) {
  for (;;) {
    if constexpr (kShared) {
      a = find_shared(L, a);
      b = find_shared(L, b);
    } else {
      a = find_global(L, a);
      b = find_global(L, b);
    }
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(L + b, a);
    if (old == b) return;
    b = old;
  }
}

// Tile t = (f * nty + ty) * ntx + tx: its frame and first column and row.
struct Tile {
  int f, x0, y0;
  __device__ __forceinline__ Tile(int t, int ntx, int nty) {
    const int tx = t % ntx;
    t /= ntx;
    y0 = t % nty * kTile;
    f = t / nty;
    x0 = tx * kTile;
  }
};

__global__ void __launch_bounds__(kThreads)
speckle_local(const float* __restrict__ disp, int* __restrict__ lab, int* __restrict__ count, int* __restrict__ roots,
              int* __restrict__ nroots, unsigned* __restrict__ seams, int* __restrict__ cursor, int H, int W, int ntx,
              int nty, float max_diff, float invalid) {
  __shared__ float sd[kTile * kTile];
  __shared__ float halo[2][kTile];  // the column right of the tile, the row below it
  __shared__ int sl[kTile * kTile];
  __shared__ int cnt[kTile * kTile];     // pixels of each tile root
  __shared__ unsigned left_bits[kTile];  // bit x of row y: (y, x) is one blob with (y, x - 1)
  __shared__ int nr;
  const Tile tile(blockIdx.x, ntx, nty);
  const size_t base = (size_t)tile.f * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) *cursor = 0;  // the ecc pass's queue
  if (warp < 2) {
    const int y = warp ? tile.y0 + kTile : tile.y0 + lane, x = warp ? tile.x0 + lane : tile.x0 + kTile;
    halo[warp][lane] = y < H && x < W ? disp[base + (size_t)y * W + x] : invalid;
  }
  if (threadIdx.x == 0) nr = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int y = tile.y0 + i / kTile, x = tile.x0 + i % kTile;
    sd[i] = y < H && x < W ? disp[base + (size_t)y * W + x] : invalid;  // outside the frame: not valid
    cnt[i] = 0;
  }
  __syncthreads();
  // Runs: a pixel's label is the first pixel of its row's run.
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int i = r * kTile + lane;
    const bool lk = lane > 0 && same_blob(sd[i], sd[i - 1], invalid, max_diff);
    const unsigned left = __ballot_sync(kFullMask, lk);
    if (lane == 0) left_bits[r] = left;
    sl[i] = r * kTile + 31 - __clz(~left & (0xffffffffu >> (31 - lane)));
  }
  __syncthreads();
  // The edges across the right and the bottom border (warps 0 and 1, a lane
  // a row or a column), as bit masks; an edge whose predecessor along the
  // border is an edge too, with both its ends one blob with this edge's,
  // joins the same two sets and is left out.
  if (warp < 2) {
    const int i = warp ? (kTile - 1) * kTile + lane : lane * kTile + kTile - 1;  // the pixel inside
    const int prev = warp ? i - 1 : i - kTile;                                  // its predecessor along the border
    const float out = halo[warp][lane];
    const bool edge = same_blob(sd[i], out, invalid, max_diff);
    const unsigned edges = __ballot_sync(kFullMask, edge);
    const bool dup = lane > 0 && (edges >> (lane - 1) & 1) && same_blob(sd[i], sd[prev], invalid, max_diff) &&
                     same_blob(out, halo[warp][lane - 1], invalid, max_diff);
    const unsigned kept = __ballot_sync(kFullMask, edge && !dup);
    if (lane == 0) seams[2 * blockIdx.x + warp] = kept;
  }
  // One union a pair of touching runs: skip (y, x) where (y, x - 1) joins
  // the same two runs.
  for (int r = warp; r < kTile; r += kThreads / 32) {
    if (r == 0) continue;
    const int i = r * kTile + lane;
    const bool up = same_blob(sd[i], sd[i - kTile], invalid, max_diff);
    const unsigned ups = __ballot_sync(kFullMask, up);
    const bool dup = lane > 0 && (left_bits[r] >> lane & 1) && (ups >> (lane - 1) & 1) &&
                     (left_bits[r - 1] >> lane & 1);
    if (up && !dup) unite<true>(sl, i, i - kTile);
  }
  __syncthreads();
  // Each run's first pixel takes its root (the forest is final now): then
  // every pixel's root is two loads away.
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int i = r * kTile + lane;
    if (!(left_bits[r] >> lane & 1)) sl[i] = find_shared(sl, i);
  }
  __syncthreads();
  // Labels out, and each root's pixels counted (one shared atomic a warp and root).
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int y = tile.y0 + i / kTile, x = tile.x0 + i % kTile;
    const bool valid = sd[i] > invalid;  // false outside the frame
    const int r = valid ? sl[sl[i]] : -1 - lane;
    if (y < H && x < W)
      lab[base + (size_t)y * W + x] = valid ? (tile.y0 + r / kTile) * W + tile.x0 + r % kTile : kInvalid;
    const int r0 = __shfl_sync(kFullMask, r, 0);
    const unsigned peers = __all_sync(kFullMask, valid && r == r0) ? kFullMask : __match_any_sync(kFullMask, r);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&cnt[r], __popc(peers));
  }
  __syncthreads();
  // The tile roots listed, with their counts.
  const int tid = blockIdx.x;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    if (!(sd[i] > invalid) || sl[i] != i) continue;
    const int y = tile.y0 + i / kTile, x = tile.x0 + i % kTile;
    count[base + (size_t)y * W + x] = cnt[i];
    roots[(size_t)tid * kTile * kTile + atomicAdd(&nr, 1)] = y * W + x;
  }
  __syncthreads();
  if (threadIdx.x == 0) nroots[tid] = nr;
}

// One warp per tile: the edges the local pass kept across its right border
// (lane = row) and its bottom border (lane = column), each uniting its two
// sets in device memory.
__global__ void __launch_bounds__(kThreads)
speckle_merge(int* lab, const unsigned* __restrict__ seams, int ntiles, int H, int W, int ntx, int nty) {
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (t >= ntiles) return;
  const Tile tile(t, ntx, nty);
  int* L = lab + (size_t)tile.f * H * W;
  if (seams[2 * t] >> lane & 1) {
    const int p = (tile.y0 + lane) * W + tile.x0 + kTile - 1;
    unite<false>(L, p, p + 1);
  }
  if (seams[2 * t + 1] >> lane & 1) {
    const int p = (tile.y0 + kTile - 1) * W + tile.x0 + lane;
    unite<false>(L, p, p + W);
  }
}

// One warp per tile: each tile root takes its final root as its label (so
// that a pixel's root is two loads away), and adds its pixels to the final
// root's count (none once that count is past S).
__global__ void __launch_bounds__(kThreads)
speckle_count(int* lab, int* count, const int* __restrict__ roots, const int* __restrict__ nroots, int ntiles, int H,
              int W, int ntx, int nty, int S) {
  const int tid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (tid >= ntiles) return;
  const size_t base = (size_t)(tid / (ntx * nty)) * H * W;
  int* L = lab + base;
  int* C = count + base;
  const int nr = nroots[tid];
  const int* list = roots + (size_t)tid * kTile * kTile;
  for (int k = threadIdx.x & 31; k < nr; k += 32) {
    const int t = list[k];
    const int r = find_global(L, t);
    if (r == t) continue;
    L[t] = r;
    if (__ldcg(C + r) <= S) atomicAdd(C + r, C[t]);
  }
}

// Capped only: a warp per tile; each final root of the tile's list with
// R + 2 <= count <= S walks its component breadth first for R levels; the
// count becomes kKept unless every pixel was reached.
__global__ void __launch_bounds__(kThreads)
speckle_ecc(const float* __restrict__ disp, int* lab, int* count, const int* __restrict__ roots,
            const int* __restrict__ nroots, int* queue, int* cursor, int ntiles, int H, int W, int ntx, int nty, int S,
            int R, float max_diff, float invalid) {
  if (R >= S - 1) return;  // uncapped: no component needs the test
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (tid >= ntiles) return;  // whole warp
  const int f = tid / (ntx * nty), HW = H * W;
  int* L = lab + (size_t)f * HW;
  const float* Dm = disp + (size_t)f * HW;
  const int nr = nroots[tid];
  const int* list = roots + (size_t)tid * kTile * kTile;
  const unsigned below = (1u << lane) - 1;
  for (int k0 = 0; k0 < nr; k0 += 32) {
    int root = -1, cnt = 0;
    if (k0 + lane < nr) {
      root = list[k0 + lane];
      if (__ldcg(L + root) == root) cnt = count[(size_t)f * HW + root];  // a final root
    }
    unsigned todo = __ballot_sync(kFullMask, cnt >= R + 2 && cnt <= S);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int g = __shfl_sync(kFullMask, root, src);
      const int n = __shfl_sync(kFullMask, cnt, src);
      int qb = 0;
      if (lane == 0) {
        qb = atomicAdd(cursor, n);  // room for every pixel of C
        queue[qb] = g;
        L[g] = -1 - g;  // visited
      }
      int* Q = queue + __shfl_sync(kFullMask, qb, 0);
      __syncwarp();
      int head = 0, tail = 1;
      for (int level = 0; level < R && head < tail; ++level) {
        int next = tail;
        for (int i0 = head; i0 < tail; i0 += 32) {
          const int i = i0 + lane;
          const int v = i < tail ? Q[i] : -1;
          const int y = v / W, x = v - (v / W) * W;
          const float dv = v >= 0 ? Dm[v] : 0.0f;
#pragma unroll
          for (int dir = 0; dir < 4; ++dir) {
            const int yy = y + (dir == 0) - (dir == 1), xx = x + (dir == 2) - (dir == 3);
            int u = -1;
            if (v >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W) {
              const int w = yy * W + xx;
              if (linked(dv, Dm[w], invalid, max_diff)) {
                const int old = L[w];
                if (old >= 0 && atomicCAS(L + w, old, -1 - old) == old) u = w;
              }
            }
            const unsigned got = __ballot_sync(kFullMask, u >= 0);
            if (u >= 0) Q[next + __popc(got & below)] = u;
            next += __popc(got);
          }
        }
        __syncwarp();  // this level's queue entries are visible to the warp
        head = tail;
        tail = next;
      }
      if (lane == 0 && tail != n) count[(size_t)f * HW + g] = kKept;
    }
  }
}

// A pixel of disparity d and label l at flat index p: invalid where it is
// valid and its root's count is <= S.
__device__ __forceinline__ float emit_one(float d, int l, int p, const int* __restrict__ lab,
                                          const int* __restrict__ count, int HW, int S, float invalid) {
  if (!(d > invalid)) return d;
  const size_t base = (size_t)(p / HW) * HW;
  return count[base + unmark(lab[base + unmark(l)])] <= S ? invalid : d;
}

// Four pixels a thread (16-byte loads and stores where `disp` is 16-byte
// aligned: kVec), the last few one by one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
speckle_emit(const float* __restrict__ disp, const int* __restrict__ lab, const int* __restrict__ count,
             float* __restrict__ out, int n, int HW, int S, float invalid) {
  const int p0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (p0 >= n) return;
  if (kVec && p0 + 4 <= n) {
    const float4 d = *reinterpret_cast<const float4*>(disp + p0);
    const int4 l = *reinterpret_cast<const int4*>(lab + p0);
    *reinterpret_cast<float4*>(out + p0) =
        make_float4(emit_one(d.x, l.x, p0, lab, count, HW, S, invalid),
                    emit_one(d.y, l.y, p0 + 1, lab, count, HW, S, invalid),
                    emit_one(d.z, l.z, p0 + 2, lab, count, HW, S, invalid),
                    emit_one(d.w, l.w, p0 + 3, lab, count, HW, S, invalid));
    return;
  }
  for (int p = p0; p < min(p0 + 4, n); ++p) out[p] = emit_one(disp[p], lab[p], p, lab, count, HW, S, invalid);
}

}  // namespace

// Device launches of one svt_speckle_filter call, whatever R is.
SVT_EXPORT int svt_speckle_launches() { return 5; }

// Int32 words of workspace svt_speckle_filter takes for P frames of H x W:
// labels and counts (a pixel each), the ecc pass's queue (a pixel each), the
// tile roots' lists (a tile's pixels each), their lengths, two border masks
// a tile and the queue's cursor.
SVT_EXPORT long long svt_speckle_workspace(int P, int H, int W) {
  const long long n = (long long)P * H * W;
  const long long tiles = (long long)P * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  return 3 * n + tiles * kTile * kTile + 3 * tiles + 1;
}

// (P, H, W) float32 disp -> out, R rounds' semantics, blobs of size <= S
// removed; ws32: svt_speckle_workspace(P, H, W) int32. P*H*W < 2^31.
SVT_EXPORT int svt_speckle_filter(const void* disp, void* out, void* ws32, int P, int H, int W, int S, int R,
                                  float max_diff, float invalid, void* stream) {
  if (P < 0 || H < 0 || W < 0 || R < 1 || S < 1) return cudaErrorInvalidValue;
  const long long nl = (long long)P * H * W;
  if (nl == 0) return cudaSuccess;
  if (nl >= INT_MAX) return cudaErrorInvalidValue;
  const int n = (int)nl, HW = H * W;
  const int ntx = (W + kTile - 1) / kTile, nty = (H + kTile - 1) / kTile, ntiles = P * ntx * nty;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float*>(disp);
  const auto o = static_cast<float*>(out);
  int* lab = static_cast<int*>(ws32);
  int* count = lab + n;
  int* queue = count + n;
  int* roots = queue + n;
  int* nroots = roots + (size_t)ntiles * kTile * kTile;
  unsigned* seams = reinterpret_cast<unsigned*>(nroots + ntiles);
  int* cursor = nroots + 3 * ntiles;
  const int warp_blocks = (ntiles + kThreads / 32 - 1) / (kThreads / 32);
  cudaError_t e;
#define SVT_LAUNCH(...)                                         \
  __VA_ARGS__;                                                  \
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  SVT_LAUNCH(speckle_local<<<ntiles, kThreads, 0, st>>>(d, lab, count, roots, nroots, seams, cursor, H, W, ntx, nty,
                                                         max_diff, invalid))
  SVT_LAUNCH(speckle_merge<<<warp_blocks, kThreads, 0, st>>>(lab, seams, ntiles, H, W, ntx, nty))
  SVT_LAUNCH(speckle_count<<<warp_blocks, kThreads, 0, st>>>(lab, count, roots, nroots, ntiles, H, W, ntx, nty, S))
  SVT_LAUNCH(speckle_ecc<<<warp_blocks, kThreads, 0, st>>>(d, lab, count, roots, nroots, queue, cursor, ntiles, H, W,
                                                            ntx, nty, S, R, max_diff, invalid))
  const int emit_blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (reinterpret_cast<uintptr_t>(d) % 16 == 0) {
    SVT_LAUNCH(speckle_emit<true><<<emit_blocks, kThreads, 0, st>>>(d, lab, count, o, n, HW, S, invalid))
  } else {
    SVT_LAUNCH(speckle_emit<false><<<emit_blocks, kThreads, 0, st>>>(d, lab, count, o, n, HW, S, invalid))
  }
#undef SVT_LAUNCH
  return cudaSuccess;
}
