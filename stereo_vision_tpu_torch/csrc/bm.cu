// Block matching (cv2.StereoBM semantics) fused into one pass.
//
// Replaces stereo_vision_tpu/stereo/bm_pallas.py::bm_stats_pallas (kernel
// body _bm_kernel): SAD over a bs x bs window for every disparity, texture
// threshold, winner-take-all (ties -> smallest d), cv2's integer uniqueness
// check, the modified-parabola subpixel step and the left range mask, from
// two prefiltered images to one float32 map of the window-centre region,
// (B, H-bs+1, W-bs+1), invalid = min_disparity - 1. The SAD cost volume
// never reaches device memory. Any min_disparity: the right sample of
// disparity index d is rp[x - s], s = max(min_disparity + d, 0), and 0 left
// of the frame (the reference's zero pad + clamped slice). All arithmetic is
// int32 (the TPU kernel's float32 booleans and reciprocal nudge were Mosaic
// workarounds); the subpixel division is __fdiv_rn and the final add
// __fadd_rn, as float32 does them on the reference.
//
// What bounds it on an H100: operations. Per (valid pixel, d) about 8
// 32-bit operations remain with running sums in both directions (an
// absolute difference, the vertical add and subtract, the horizontal add
// and subtract, min and argmin); at 1920x1080, D=128, 8 frames that is
// 17 G operations, ~0.25 ms at 67 T/s, against 0.06 ms for the bytes (two
// int32 images in, one float32 map out). The row form's shared-memory
// traffic, ~4 32-bit accesses a (pixel, d) pair, is its nearer limit.
//
// Design (redesigned for Hopper; a copy of the earlier warp-a-pixel kernel
// with a phase removed measured where its 7.3 ms went: 5.1 ms in the per-pixel
// output pass, whose warp a pixel spent ~200 instructions reducing 128
// disparities, and 1.8 ms in a row step of six shared-memory accesses and
// ~15 instructions a (column, d); its shuffles and barriers cost nothing
// measurable). bm_rows_kernel: one block of 128 threads per (frame, strip of
// TX = NC - bs + 1 output columns, chunk of RY output rows) walks down its
// rows with the vertical window sums V[d][column] of its NC input columns in
// shared memory. The row step gives each thread a column and a run of
// disparities; where bs^2 * 2 cap < 2^16 (the packed form) the prefiltered
// values are bytes and the sums two 16-bit halves a word, so one
// __vabsdiffu4 of the replicated left byte and four consecutive bytes of
// the reversed right row (a funnel shift of a sliding pair of words) gives
// four |l - r|, added to two words. A running sum along the columns gives
// the bs x bs box sums Hs[d][tc] once a row. Then one thread an output
// pixel reduces its disparities in its own registers: 16x2 minima
// (__vminu2) give the minimum and its first argmin (a half that changes is
// lower), a second pass the least sum further than one disparity from it,
// which decides uniqueness; the argmin's two neighbours are read back. The raw image rows
// come in by cp.async one row ahead. Outside the packing bound (or for cap
// > 127) the same kernel runs on int32 words. Packed sums are exact as
// 32-bit integers whose halves end in range: a carry or borrow between
// halves cancels once both are back in [0, 2^16), and a padding
// disparity's half (D odd) is masked before the reduction.
//
// Above 1024 disparities, and wherever the window sums of even an 8-column
// strip pass a block's shared memory, bm_wide_kernel takes the call: the
// same row walk, each output pixel's costs summed from V for one d at a
// time (d = lane, lane + 32, ...) in two passes (minimum and argmin, then
// uniqueness and the samples), V in shared memory or, where it does not
// fit, in a slot of device scratch a resident block, the blocks walking the
// (strip, row chunk, frame) items. No main path runs it.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

using svt::kFullMask;
using svt::warp_min;
using svt::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBig = 1 << 30;  // cost of a padding disparity (d >= D)

// Floor division by 100, as the reference's // (any sign).
__device__ __forceinline__ int floor_div100(int a) {
  const int q = a / 100;
  return (a % 100 != 0 && a < 0) ? q - 1 : q;
}

// Row step of a strip's walk: stage the entering left and right rows y
// (and, where `leave`, the leaving rows y - bs) of the strip's NC left and
// NR right columns, then add the entering row's |lp - rp_s| to the window
// sums V[j][d] and its |lp - cap| to T[j], and subtract the leaving row's.
// Every thread of the block takes part.
__device__ __forceinline__ void bm_row_step(const int* __restrict__ L, const int* __restrict__ R, int* V, int* T,
                                            int* Ln, int* Lo, int* Rn, int* Ro, int W, int D, int mindisp, int bs,
                                            int cap, int NC, int NR, int smax, int x0, int y, bool leave) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous step has read V, T and the staged rows
  for (int j = threadIdx.x; j < NC; j += kThreads) {
    const int c = x0 + j;
    Ln[j] = c < W ? L[(size_t)y * W + c] : 0;
    if (leave) Lo[j] = c < W ? L[(size_t)(y - bs) * W + c] : 0;
  }
  for (int i = threadIdx.x; i < NR; i += kThreads) {
    const int c = x0 - smax + i;
    const bool in = c >= 0 && c < W;
    Rn[i] = in ? R[(size_t)y * W + c] : 0;
    if (leave) Ro[i] = in ? R[(size_t)(y - bs) * W + c] : 0;
  }
  __syncthreads();
  for (int j = warp; j < NC; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      const int i = j + smax - max(mindisp + d, 0);
      int v = V[j * D + d] + abs(Ln[j] - Rn[i]);
      if (leave) v -= abs(Lo[j] - Ro[i]);
      V[j * D + d] = v;
    }
  }
  for (int j = threadIdx.x; j < NC; j += kThreads) {
    int v = T[j] + abs(Ln[j] - cap);
    if (leave) v -= abs(Lo[j] - cap);
    T[j] = v;
  }
}

// ------------------------------------------------ the row form (D <= 1024)

constexpr int kRowThreads = 128;  // threads of a bm_rows_kernel block (NC divides it)

// One int32 from global to shared memory without a register (cp.async), zero
// where !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async_int(int* dst, const int* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The shared-memory layout of a bm_rows_kernel block (host and device):
// NC input columns (a multiple of 32) give TX = NC - bs + 1 output columns;
// NR right samples a row; Dw words of window sums a column (two 16-bit
// disparities a word in the packed form, one int32 otherwise); NCp and TXp
// are odd, so lanes over columns and lanes over words are both free of bank
// conflicts. In ints: two raw buffers of the entering and leaving rows
// (L new, L old, R new, R old), the packed form's reversed right rows as
// bytes (NRw words each), V [Dw][NCp], Hs [Dw][TXp], T [NC].
struct RowsGeom {
  int NC, TX, NR, NRw, Dw, NCp, TXp;
  __host__ __device__ RowsGeom(int nc, int D, int mindisp, int bs, bool packed) {
    NC = nc;
    TX = nc - bs + 1;
    NR = nc + max(mindisp + D - 1, 0) - max(mindisp, 0);
    NRw = packed ? (NR + 8 + 3) / 4 : 0;
    Dw = packed ? (D + 1) / 2 : D;
    NCp = NC + 1;
    TXp = TX | 1;
  }
  __host__ __device__ int raw_ints() const { return 2 * NC + 2 * NR; }
  __host__ __device__ size_t ints() const {
    return (size_t)2 * raw_ints() + 2 * NRw + (size_t)Dw * NCp + (size_t)Dw * TXp + NC;
  }
};

// The row form: one block of kRowThreads threads per (frame, strip of TX output
// columns, chunk of RY output rows), walking down its rows. kPacked: window
// sums as two 16-bit halves a word, exact while bs^2 * 2 cap < 2^16 and the
// images hold 0..2 cap <= 254 (the prefilter's range); else int32 words.
// A row: the raw rows (cp.async, issued one row ahead) -> the packed form's
// reversed right rows as bytes -> the row step (thread j owns column j and a
// run of disparities: V[w][j] += the entering row's |l - r| - the leaving
// row's; packed: four disparities at once, __vabsdiffu4 of the replicated
// left byte and four consecutive right bytes, one funnel shift of two words)
// -> the horizontal box Hs[w][tc] = sum of V[w][tc .. tc + bs - 1] (a thread
// a word and a run of columns, as a running sum) -> one thread an output
// pixel: the minimum and its first argmin, then the least sum further than
// one disparity from it, the two samples beside the argmin read back, the
// texture sum and the store.
template <bool kPacked>
__global__ void __launch_bounds__(kRowThreads)
bm_rows_kernel(const int* __restrict__ lp, const int* __restrict__ rp, float* __restrict__ out, int H, int W,
               int D, int mindisp, int bs, int cap, int uniq, int tex_thr, int NC, int RY) {
  extern __shared__ int smem[];
  const RowsGeom g(NC, D, mindisp, bs, kPacked);
  const int TX = g.TX, NR = g.NR, Dw = g.Dw, NCp = g.NCp, TXp = g.TXp;
  int* raw0 = smem;                            // 2 x [Ln NC | Lo NC | Rn NR | Ro NR]
  unsigned* Rb = reinterpret_cast<unsigned*>(raw0 + 2 * g.raw_ints());  // 2 x [NRw] (packed)
  unsigned* V = Rb + 2 * g.NRw;                // [Dw][NCp]
  unsigned* Hs = V + (size_t)Dw * NCp;         // [Dw][TXp]
  int* T = reinterpret_cast<int*>(Hs + (size_t)Dw * TXp);  // [NC]

  const int smin = max(mindisp, 0), smax = max(mindisp + D - 1, 0);
  const int Hv = H - bs + 1, Wv = W - bs + 1;
  const int b = blockIdx.z, x0 = blockIdx.x * TX, yv0 = blockIdx.y * RY;
  const int nout = min(RY, Hv - yv0), nrows = nout + bs - 1;
  const int* L = lp + (size_t)b * H * W;
  const int* R = rp + (size_t)b * H * W;
  const int tid = threadIdx.x, nt = kRowThreads;

  for (size_t i = tid; i < (size_t)Dw * NCp; i += nt) V[i] = 0;
  for (int i = tid; i < NC; i += nt) T[i] = 0;

  // Row t's raw rows into buffer t & 1: left columns x0 + j, right columns
  // x0 - smax + i, zero outside the frame; the leaving rows from t = bs on.
  auto issue = [&](int t) {
    int* raw = raw0 + (t & 1) * g.raw_ints();
    const int y = yv0 + t;
    const int nl = t >= bs ? 2 : 1;
    for (int r = 0; r < nl; ++r) {
      const int* Lr = L + (size_t)(y - r * bs) * W;
      const int* Rr = R + (size_t)(y - r * bs) * W;
      for (int j = tid; j < NC; j += nt) {
        const int c = x0 + j;
        cp_async_int(raw + r * NC + j, Lr + (c < W ? c : 0), c < W);
      }
      for (int i = tid; i < NR; i += nt) {
        const int c = x0 - smax + i;
        const bool in = c >= 0 && c < W;
        cp_async_int(raw + 2 * NC + r * NR + i, Rr + (in ? c : 0), in);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const int nsplit = nt / NC;  // threads a column in the row step (NC divides nt)
  const int j = tid % NC, sp = tid / NC;
  for (int t = 0; t < nrows; ++t) {
    cp_async_wait_all();
    __syncthreads();  // row t's raw rows are in; the previous row's passes are done
    if (t + 1 < nrows) issue(t + 1);
    const bool leave = t >= bs;
    const int* raw = raw0 + (t & 1) * g.raw_ints();
    const int* Ln = raw;
    const int* Lo = raw + NC;
    const int* Rn = raw + 2 * NC;
    const int* Ro = Rn + NR;
    if constexpr (kPacked) {
      // The right rows reversed as bytes: byte m is sample NR - 1 - m, so the
      // sample of (column j, disparity d) is byte NC - 1 - j + s(d) - smin
      // and four consecutive d at or above -mindisp are four consecutive bytes.
      for (int k = tid; k < 2 * g.NRw; k += nt) {
        const int row = k / g.NRw, m = (k % g.NRw) * 4;
        if (row == 1 && !leave) continue;
        const int* src = row ? Ro : Rn;
        unsigned w = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (m + q < NR) w |= (unsigned)(src[NR - 1 - m - q] & 0xff) << (8 * q);
        Rb[k] = w;
      }
      __syncthreads();
    }

    // Row step: thread (j, sp) takes column j and the sp-th run of disparity
    // words; split 0 also keeps the texture sum.
    {
      const int ln = Ln[j], lo = leave ? Lo[j] : 0;
      if (sp == 0) T[j] += abs(ln - cap) - (leave ? abs(lo - cap) : 0);
      if constexpr (kPacked) {
        const int nq = (D + 3) / 4, qps = (nq + nsplit - 1) / nsplit;
        const int qa = sp * qps, qb = min(nq, qa + qps);
        const unsigned lrn = (unsigned)ln * 0x01010101u, lro = (unsigned)lo * 0x01010101u;
        const unsigned* Rbn = Rb;
        const unsigned* Rbo = Rb + g.NRw;
        const int mb = NC - 1 - j - smin + mindisp;  // byte of d = 0 where mindisp + d >= 0
        // The first quad whose four disparities all have mindisp + d >= 0.
        const int qf = min(qb, max(qa, mindisp >= 0 ? 0 : (-mindisp + 3) / 4));
        auto byte_at = [&](const unsigned* rb, int d) {
          const int m = NC - 1 - j - smin + max(mindisp + d, 0);
          return (rb[m >> 2] >> (8 * (m & 3))) & 0xffu;
        };
        auto update = [&](int q, unsigned rn, unsigned ro) {
          const unsigned en = __vabsdiffu4(lrn, rn);
          unsigned* v0 = V + (size_t)(2 * q) * NCp + j;
          unsigned w0 = *v0 + __byte_perm(en, 0, 0x4140);
          unsigned w1 = 2 * q + 1 < Dw ? v0[NCp] + __byte_perm(en, 0, 0x4342) : 0;
          if (leave) {  // no borrow: each half holds the leaving row's term
            const unsigned eo = __vabsdiffu4(lro, ro);
            w0 -= __byte_perm(eo, 0, 0x4140);
            w1 -= __byte_perm(eo, 0, 0x4342);
          }
          *v0 = w0;
          if (2 * q + 1 < Dw) v0[NCp] = w1;
        };
        for (int q = qa; q < qf; ++q) {  // negative mindisp: the clamped shifts, a byte at a time
          unsigned rn = 0, ro = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            rn |= byte_at(Rbn, 4 * q + k) << (8 * k);
            if (leave) ro |= byte_at(Rbo, 4 * q + k) << (8 * k);
          }
          update(q, rn, ro);
        }
        if (qf < qb) {  // four consecutive bytes a quad: a funnel shift of a sliding pair of words
          int wi = (mb + 4 * qf) >> 2;
          const unsigned sh = 8u * ((mb + 4 * qf) & 3);
          unsigned nlo = Rbn[wi], olo = leave ? Rbo[wi] : 0;
          int q = qf;
          for (; q + 4 <= qb && 2 * q + 8 <= Dw; q += 4) {  // four quads' loads before their stores
            unsigned rn[4], ro[4], v[8];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              rn[k] = Rbn[wi + 1 + k];
              ro[k] = leave ? Rbo[wi + 1 + k] : 0;
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = V[(size_t)(2 * q + k) * NCp + j];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const unsigned en = __vabsdiffu4(lrn, __funnelshift_r(k ? rn[k - 1] : nlo, rn[k], sh));
              v[2 * k] += __byte_perm(en, 0, 0x4140);
              v[2 * k + 1] += __byte_perm(en, 0, 0x4342);
              if (leave) {
                const unsigned eo = __vabsdiffu4(lro, __funnelshift_r(k ? ro[k - 1] : olo, ro[k], sh));
                v[2 * k] -= __byte_perm(eo, 0, 0x4140);
                v[2 * k + 1] -= __byte_perm(eo, 0, 0x4342);
              }
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) V[(size_t)(2 * q + k) * NCp + j] = v[k];
            wi += 4;
            nlo = rn[3];
            olo = ro[3];
          }
          for (; q < qb; ++q) {
            ++wi;
            const unsigned nhi = Rbn[wi], ohi = leave ? Rbo[wi] : 0;
            update(q, __funnelshift_r(nlo, nhi, sh), __funnelshift_r(olo, ohi, sh));
            nlo = nhi;
            olo = ohi;
          }
        }
      } else {
        const int dps = (D + nsplit - 1) / nsplit;
        const int da = sp * dps, db = min(D, da + dps);
#pragma unroll 4
        for (int d = da; d < db; ++d) {
          const int i = j + smax - max(mindisp + d, 0);
          int v = (int)V[(size_t)d * NCp + j] + abs(ln - Rn[i]);
          if (leave) v -= abs(lo - Ro[i]);
          V[(size_t)d * NCp + j] = (unsigned)v;
        }
      }
    }
    __syncthreads();
    if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)

    // Horizontal box, a running sum along a run of columns a thread (no
    // borrow in the packed halves: the running sum holds the leaving term).
    {
      const int nseg = max(1, nt / Dw);
      const int len = (TX + nseg - 1) / nseg;
      for (int item = tid; item < Dw * nseg; item += nt) {
        const int w = item % Dw, c0 = item / Dw * len, c1 = min(TX, c0 + len);
        if (c0 >= c1) continue;
        const unsigned* vr = V + (size_t)w * NCp;
        unsigned* hr = Hs + (size_t)w * TXp;
        unsigned s = 0;
        for (int k = 0; k < bs; ++k) s += vr[c0 + k];
        hr[c0] = s;
        int tc = c0 + 1;
        for (; tc + 8 <= c1; tc += 8) {  // eight columns' loads before their stores
          unsigned add[8], sub[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) add[k] = vr[tc + k + bs - 1], sub[k] = vr[tc + k - 1];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            s += add[k] - sub[k];
            hr[tc + k] = s;
          }
        }
        for (; tc < c1; ++tc) {
          s += vr[tc + bs - 1] - vr[tc - 1];
          hr[tc] = s;
        }
      }
    }
    __syncthreads();

    // One thread an output pixel: the minimum and its first argmin, then the
    // least sum over the disparities further than one from it (uniqueness).
    const int tc = tid, xv = x0 + tc;
    if (tc < TX && xv < Wv) {
      const unsigned* hc = Hs + tc;
      int mn, best, far = INT_MAX;
      if constexpr (kPacked) {
        const int last = Dw - 1;  // D odd: its high half is no disparity
        const unsigned pad = (D & 1) ? 0xffff0000u : 0u;
        auto word = [&](int w) { return hc[(size_t)w * TXp] | (w == last ? pad : 0u); };
        // Two running minima (even and odd words) of the two halves, each
        // with the first word that lowered it (a half that changes is lower).
        unsigned ma = 0xffffffffu, mb = 0xffffffffu;
        int ia0 = 0, ia1 = 0, ib0 = 0, ib1 = 0;
        auto lower = [](unsigned& m, unsigned h, int w, int& i0, int& i1) {
          const unsigned n = __vminu2(m, h), x = n ^ m;
          i0 = x & 0xffffu ? w : i0;
          i1 = x >> 16 ? w : i1;
          m = n;
        };
        int w = 0;
        for (; w + 2 <= last; w += 2) {
          lower(ma, hc[(size_t)w * TXp], w, ia0, ia1);
          lower(mb, hc[(size_t)(w + 1) * TXp], w + 1, ib0, ib1);
        }
        for (; w <= last; ++w) lower(ma, word(w), w, ia0, ia1);
        // Merge (value, disparity) pairs: the smaller value, then the smaller d.
        auto pick = [](int va, int da, int vb, int db, int* d) {
          *d = va < vb ? da : vb < va ? db : min(da, db);
          return min(va, vb);
        };
        int d0, d1;
        const int v0 = pick((int)(ma & 0xffffu), 2 * ia0, (int)(mb & 0xffffu), 2 * ib0, &d0);
        const int v1 = pick((int)(ma >> 16), 2 * ia1 + 1, (int)(mb >> 16), 2 * ib1 + 1, &d1);
        mn = pick(v0, d0, v1, d1, &best);
        // The words beside the argmin (w0 .. w1) a disparity at a time, the others packed.
        const int w0 = max(best - 1, 0) >> 1, w1 = min(best + 1, D - 1) >> 1;
        unsigned fq[4] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
        auto far_words = [&](int lo, int hi) {  // [lo, hi) less the last word
          hi = min(hi, last);
          int v = lo;
          for (; v + 4 <= hi; v += 4) {
#pragma unroll
            for (int q = 0; q < 4; ++q) fq[q] = __vminu2(fq[q], hc[(size_t)(v + q) * TXp]);
          }
          for (; v < hi; ++v) fq[0] = __vminu2(fq[0], hc[(size_t)v * TXp]);
        };
        far_words(0, w0);
        far_words(w1 + 1, last);
        const unsigned fa = __vminu2(__vminu2(fq[0], fq[1]), __vminu2(fq[2], fq[3]));
        for (const unsigned h : {fa & 0xffffu, fa >> 16})
          if (h != 0xffffu) far = min(far, (int)h);  // 0xffff: none (real sums are at most 0xfffe)
        const unsigned short* h16 = reinterpret_cast<const unsigned short*>(Hs);
        auto sample = [&](int d) { return (int)h16[2 * ((size_t)(d >> 1) * TXp + tc) + (d & 1)]; };
        auto near_word = [&](int v) {
          for (int d = 2 * v; d < min(2 * v + 2, D); ++d)
            if (abs(d - best) > 1) far = min(far, sample(d));
        };
        for (int v = w0; v <= w1; ++v) near_word(v);
        if (last > w1 || last < w0) near_word(last);
      } else {
        mn = INT_MAX;
        best = 0;
        for (int d = 0; d < D; ++d) {
          const int v = (int)hc[(size_t)d * TXp];
          if (v < mn) mn = v, best = d;
        }
        for (int d = 0; d < D; ++d)
          if (abs(d - best) > 1) far = min(far, (int)hc[(size_t)d * TXp]);
      }
      auto at = [&](int d) {
        return kPacked ? (int)reinterpret_cast<const unsigned short*>(Hs)[2 * ((size_t)(d >> 1) * TXp + tc) + (d & 1)]
                       : (int)hc[(size_t)d * TXp];
      };
      const int cn = best >= 1 ? at(best - 1) : 0, cp = best <= D - 2 ? at(best + 1) : 0;
      const int thresh = mn + floor_div100(mn * uniq);
      const bool unique_ok = !(far <= thresh);
      int tex = 0;
      for (int k = 0; k < bs; ++k) tex += T[tc + k];
      const int yv = yv0 + t - (bs - 1);
      const int denom = cp + cn - 2 * mn + abs(cp - cn);
      float delta = 0.0f;
      if (best > 0 && best < D - 1 && denom != 0) delta = __fdiv_rn((float)(cn - cp), (float)denom);
      const float disp = __fadd_rn((float)(best + mindisp), delta);
      const bool ok = unique_ok && tex >= tex_thr && xv - (mindisp + D - 1) >= 0;
      out[((size_t)b * Hv + yv) * Wv + xv] = ok ? disp : (float)(mindisp - 1);
    }
  }
}

// The row form's launch: the packed form where bs^2 * 2 cap < 2^16 and the
// images fit a byte (0 <= cap <= 127), else int32; NC the widest of 128, 64
// and 32 input columns whose layout fits `optin` (NC >= bs); 0 where none.
struct RowsPlan {
  bool packed;
  int NC = 0;
  size_t smem = 0;
  RowsPlan(int D, int mindisp, int bs, int cap, int optin) {
    packed = cap >= 0 && cap <= 127 && (long long)bs * bs * 2 * cap <= 0xfffe;
    if (D > 1024) return;
    for (int nc : {128, 64, 32}) {
      if (nc < bs) continue;
      const size_t bytes = RowsGeom(nc, D, mindisp, bs, packed).ints() * 4;
      if (bytes <= (size_t)optin) {
        NC = nc;
        smem = bytes;
        return;
      }
    }
  }
};

// The staged rows and texture sums of a strip (always shared memory):
// T [NC], Ln [NC], Lo [NC], Rn [NR], Ro [NR].
size_t stage_ints(int TX, int D, int bs, int mindisp) {
  const int NC = TX + bs - 1;
  const int NR = NC + max(mindisp + D - 1, 0) - max(mindisp, 0);
  return (size_t)3 * NC + 2 * NR;
}

// Any D; V at `scratch` + blockIdx.x * slot ints where given, else in shared
// memory after the staging; items (strip, row chunk, frame) = blockIdx.x,
// + gridDim.x, ...
__global__ void __launch_bounds__(kThreads)
bm_wide_kernel(const int* __restrict__ lp, const int* __restrict__ rp, float* __restrict__ out, int H, int W, int D,
               int mindisp, int bs, int cap, int uniq, int tex_thr, int TX, int RY, int* scratch, size_t slot, int nx,
               int ny, int items) {
  extern __shared__ int smem[];
  const int NC = TX + bs - 1;
  const int smin = max(mindisp, 0), smax = max(mindisp + D - 1, 0);
  const int NR = NC + smax - smin;
  int* T = smem;     // [NC]
  int* Ln = T + NC;  // [NC]
  int* Lo = Ln + NC;
  int* Rn = Lo + NC;  // [NR]
  int* Ro = Rn + NR;
  int* V = scratch ? scratch + blockIdx.x * slot : Ro + NR;  // [NC][D]
  const int Hv = H - bs + 1, Wv = W - bs + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpw = TX / kWarps;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bx = item % nx, by = item / nx % ny, b = item / (nx * ny);
    const int x0 = bx * TX, yv0 = by * RY;
    const int nout = min(RY, Hv - yv0);
    const int* L = lp + (size_t)b * H * W;
    const int* R = rp + (size_t)b * H * W;
    __syncthreads();  // the previous item has read V, T and the staged rows
    for (size_t i = threadIdx.x; i < (size_t)NC * D; i += kThreads) V[i] = 0;
    for (int i = threadIdx.x; i < NC; i += kThreads) T[i] = 0;

    for (int t = 0; t < nout + bs - 1; ++t) {
      const int y = yv0 + t;
      bm_row_step(L, R, V, T, Ln, Lo, Rn, Ro, W, D, mindisp, bs, cap, NC, NR, smax, x0, y, t >= bs);
      if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)
      __syncthreads();

      const int yv = y - bs + 1;
      for (int q = 0; q < cpw; ++q) {
        const int tc = warp * cpw + q;  // strip column of this output pixel
        const int xv = x0 + tc;
        auto cost = [&](int d) {
          int s = 0;
          for (int w = 0; w < bs; ++w) s += V[(size_t)(tc + w) * D + d];
          return s;
        };
        int tex = 0;
        for (int w = 0; w < bs; ++w) tex += T[tc + w];
        int m = kBig, arg = kBig;
        for (int d = lane; d < D; d += 32) {
          const int c = cost(d);
          if (c < m) m = c, arg = d;
        }
        const int mn = warp_min(m);
        const int best = warp_min(m == mn ? arg : kBig);
        const int thresh = mn + floor_div100(mn * uniq);
        bool offend = false;
        for (int d = lane; d < D; d += 32) offend |= abs(d - best) > 1 && cost(d) <= thresh;
        const bool unique_ok = !__any_sync(kFullMask, offend);
        const int d0 = min(max(best, 1), D - 2);
        auto sample = [&](int d) { return d >= 0 && d < D ? cost(d) : 0; };
        const int c0 = sample(d0), cn = sample(d0 - 1), cp = sample(d0 + 1);
        if (lane == 0 && xv < Wv) {
          const int denom = cp + cn - 2 * c0 + abs(cp - cn);
          float delta = 0.0f;
          if (best > 0 && best < D - 1 && denom != 0) delta = __fdiv_rn((float)(cn - cp), (float)denom);
          const float disp = __fadd_rn((float)(best + mindisp), delta);
          const bool ok = unique_ok && tex >= tex_thr && xv - (mindisp + D - 1) >= 0;
          out[((size_t)b * Hv + yv) * Wv + xv] = ok ? disp : (float)(mindisp - 1);
        }
      }
    }
  }
}

// The wide form's geometry: strip width TX (64, halved while V and the
// staging pass `optin`; V goes to scratch where even 8 columns pass it),
// row chunks RY, and the items.
struct WidePlan {
  int TX, RY, nx, ny, items, blocks;
  size_t slot, smem;  // ints of V a scratch slot (0: V in shared memory), bytes of shared memory
  WidePlan(int B, int H, int W, int D, int mindisp, int bs, int sms, int optin) {
    const int Hv = H - bs + 1, Wv = W - bs + 1;
    auto v_ints = [&](int tx) { return (size_t)(tx + bs - 1) * D; };
    TX = 64;
    while (TX > kWarps && (v_ints(TX) + stage_ints(TX, D, bs, mindisp)) * 4 > (size_t)optin) TX /= 2;
    const bool fits = (v_ints(TX) + stage_ints(TX, D, bs, mindisp)) * 4 <= (size_t)optin;
    if (!fits) TX = 64;
    nx = (Wv + TX - 1) / TX;
    RY = 64;
    while (RY > 16 && (long long)B * nx * ((Hv + RY - 1) / RY) < 2LL * sms) RY /= 2;
    ny = (Hv + RY - 1) / RY;
    const long long n = (long long)B * nx * ny;
    items = (int)std::min(n, (long long)INT32_MAX);
    blocks = fits ? items : (int)std::min(n, 2LL * sms);
    slot = fits ? 0 : (v_ints(TX) + 63) / 64 * 64;
    smem = (stage_ints(TX, D, bs, mindisp) + (fits ? v_ints(TX) : 0)) * 4;
  }
};

int device_attr(cudaDeviceAttr attr, int device) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, attr, device) == cudaSuccess ? v : -1;
}

// The form a call takes: 0 the packed row form, 1 the int32 row form, 2 the
// wide form (above 1024 disparities, or where no row layout fits).
int form_of(const RowsPlan& plan) { return plan.NC == 0 ? 2 : plan.packed ? 0 : 1; }

cudaError_t launch_rows(const RowsPlan& plan, const int* lp, const int* rp, float* out, int B, int H, int W, int D,
                        int mindisp, int bs, int cap, int uniq, int tex_thr, int sms, cudaStream_t stream) {
  const int TX = plan.NC - bs + 1;
  const int Hv = H - bs + 1, Wv = W - bs + 1;
  const int nx = (Wv + TX - 1) / TX;
  // Row chunks of 64 output rows, shorter until the grid has four blocks an SM.
  int RY = 64;
  while (RY > 16 && (long long)B * nx * ((Hv + RY - 1) / RY) < 4LL * sms) RY /= 2;
  const auto kern = plan.packed ? bm_rows_kernel<true> : bm_rows_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nx, (Hv + RY - 1) / RY, B);
  kern<<<grid, kRowThreads, plan.smem, stream>>>(lp, rp, out, H, W, D, mindisp, bs, cap, uniq, tex_thr, plan.NC, RY);
  return cudaGetLastError();
}

}  // namespace

// The form svt_bm_disparity takes on `device` (0 packed row form, 1 int32
// row form, 2 wide form); -1 for a failed device query.
SVT_EXPORT int svt_bm_form(int D, int mindisp, int bs, int cap, int device) {
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (optin < 0) return -1;
  return form_of(RowsPlan(D, mindisp, bs, cap, optin));
}

// Bytes of device scratch svt_bm_disparity needs on `device` (0: none);
// -1 for a failed device query.
SVT_EXPORT long long svt_bm_scratch_bytes(int B, int H, int W, int D, int mindisp, int bs, int cap, int device) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, device);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (sms < 1 || optin < 0) return -1;
  if (D < 1 || bs < 1 || H < bs || W < bs || B == 0 || form_of(RowsPlan(D, mindisp, bs, cap, optin)) != 2) return 0;
  const WidePlan plan(B, H, W, D, mindisp, bs, sms, optin);
  return (long long)plan.blocks * (long long)plan.slot * 4;
}

// (B, H, W) int32 prefiltered left/right, values 0..2 cap -> (B, H-bs+1,
// W-bs+1) float32 disparity of the window centres (invalid = mindisp - 1).
// D <= 1024: bm_rows_kernel, packed where bs^2 * 2 cap < 2^16 and cap <= 127,
// else int32; above 1024, or where no row layout fits the shared memory,
// bm_wide_kernel (with `scratch`, svt_bm_scratch_bytes of it, where V does
// not fit).
SVT_EXPORT int svt_bm_disparity(const void* lp, const void* rp, void* out, int B, int H, int W, int D, int mindisp,
                                int bs, int cap, int uniq, int tex_thr, void* scratch, void* stream) {
  if (D < 1 || bs < 1 || H < bs || W < bs) return cudaErrorInvalidValue;
  const auto l = static_cast<const int*>(lp);
  const auto r = static_cast<const int*>(rp);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, dev);
  const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (sms < 1 || optin < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const RowsPlan rows(D, mindisp, bs, cap, optin);
  if (form_of(rows) != 2) return launch_rows(rows, l, r, o, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, sms, st);
  const WidePlan plan(B, H, W, D, mindisp, bs, sms, optin);
  if (plan.slot && !scratch) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(bm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (e != cudaSuccess) return e;
  bm_wide_kernel<<<plan.blocks, kThreads, plan.smem, st>>>(l, r, o, H, W, D, mindisp, bs, cap, uniq, tex_thr,
                                                            plan.TX, plan.RY, static_cast<int*>(scratch), plan.slot,
                                                            plan.nx, plan.ny, plan.items);
  return cudaGetLastError();
}
