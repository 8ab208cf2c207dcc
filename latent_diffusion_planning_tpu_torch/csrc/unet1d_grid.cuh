// Kernel B's grid mode (fp16 only; diffusion_unet1d_f16.cu includes it
// after unet1d.cuh, whose GEMM, tiles and records it uses): one persistent
// launch of one block an SM runs every op of every step over all samples at
// once, so each weight tile is read once a step by the grid (from HBM, then
// from L2 for the other row items of its op), where the ordinary mode reads
// it once a step in every block (at 256 samples of the default planner, 128
// blocks x 122 MB a step). All samples' activations live in one global
// scratch (the fp32 buffers, the operand copies, the skips, the current
// sample and the GroupNorm statistics), and a grid-wide barrier orders the
// dependent phases:
//  * a GEMM (conv, stride-2, transpose, 1x1) is split into items of at
//    most 64 output rows (whole samples) by one 128-column group; item i
//    is column group i % n_col of row tile i / n_col, and block b takes
//    items b, b + grid, ... Each item is the ordinary GEMM on a view of
//    its rows and columns: its weight stripe (the group's tiles, taps x K,
//    contiguous in the stream) through a ring of cp.async stages, its
//    input rows copied into a window of shared memory. The rows an item,
//    the rows a pass, the ring's stages and the window's bytes of every
//    GEMM come from the launch (GridGemm, the wrapper's grid_table). A K
//    sum is never split, so two launches give the same bits;
//  * a conv that GroupNorm follows computes, in the item that wrote them,
//    the statistics of the (sample, group) pairs its rows and columns hold
//    whole (the wrapper takes the mode only where no group spans two
//    column groups), as group_norm_mish does: from fp16 x and x * x;
//  * the normalization, Mish, FiLM, the residual, the skips, the concat and
//    the step update are elementwise passes, each block over a contiguous
//    range of rows; the normalization first gathers its samples'
//    statistics, the JAX spread of a non-finite one included, in shared
//    memory.
// Every rounding point of the fp16 instance stays where it is, and a
// sample's output depends on that sample alone.
#pragma once

#include "unet1d.cuh"

namespace {

constexpr int kGridMt = 4;                    // m16 row tiles of an item
constexpr int kGridStatFloats = 2048;         // a block's (mu, rs) cache
constexpr int kGridMaxGemms = 64;             // GEMMs of a step at most
constexpr int kNGridDims = 12;                // gdims before the table

// How grid_gemm runs one GEMM: output rows an item and a pass (whole
// samples), ring stages, and bytes of the window at the end of `space`.
struct GridGemm {
  int item_rows, pass, stages, win_bytes;
};

struct GridDims {
  int blocks, smem, space;   // launch; bytes of the ring and the window
  long long x32, y32, xb, yb, skip, xcur, stats, bar;  // scratch offsets
  int n_gemms;               // GEMMs a step, in program order:
  GridGemm gemm[kGridMaxGemms];
};

// The barrier: thread 0 of each block arrives on bar[0]; the last to
// arrive resets it and moves the generation bar[1] on, which the others
// wait for. The fences order every block's writes before the barrier
// against every block's reads after it.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned next = gen + 1;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicExch(bar + 1, next);
    } else {
      while (*reinterpret_cast<volatile unsigned*>(bar + 1) != next) {
      }
    }
    __threadfence();
  }
  ++gen;
  __syncthreads();
}

// n uint4 from src to dst by the block, four loads a thread issued before
// their stores.
__device__ __forceinline__ void grid_copy(uint4* dst, const uint4* src,
                                          int n) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < n) v[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < n) dst[i] = v[k];
    }
  }
}

// This block's rows of an elementwise pass over M rows.
__device__ __forceinline__ void grid_rows(int M, int& lo, int& hi) {
  const int per = (M + gridDim.x - 1) / gridDim.x;
  lo = min(M, static_cast<int>(blockIdx.x) * per);
  hi = min(M, lo + per);
}

struct GridCtx {
  const f16* Wp;
  char* ring;       // the ring from the start of `space` bytes, the window
  int space;        // from their end
  uint32_t zero_addr;
  float* stats;     // (B x G) x (mean, variance) in global memory
  int G;
};

// Copy rows_in rows of `cinp` channels (stride lda) into the window (row
// stride cinp + 8, so ldmatrix's rows miss each other's banks) with
// cp.async, one commit group.
__device__ __forceinline__ void grid_stage(f16* win, const f16* A, int lda,
                                           int rows_in, int cinp) {
  const int per_row = cinp >> 3, ldw = cinp + 8;
  for (int i = threadIdx.x; i < rows_in * per_row; i += blockDim.x) {
    const int r = i / per_row, q = i - r * per_row;
    ldp::cp_async16(ldp::smem_u32(win + r * ldw + 8 * q),
                    A + static_cast<size_t>(r) * lda + 8 * q);
  }
  ldp::cp_async_commit();
}

// Every item of a GEMM over all rows (g.rows = B x Tout; g's pointers the
// whole buffers); tile0 its first tile in the main stream. lo: fp16's final
// conv, whose second pass adds the products of the lo half (the same rows
// and weights, from global memory). gn_ch > 0: the GroupNorm that follows
// has gn_ch channels a group; each item writes the statistics of its
// pairs. s: the item's rows, and its input rows copied whole into the
// window at the end of the shared memory (cp.async, under the ring's first
// stages) in passes of s.pass output rows (each pass one walk over the
// stripe), beside a ring of s.stages.
__device__ __noinline__ void grid_gemm(const GridCtx& cx, const Gemm<f16>& g,
                                       int tile0, const f16* lo, int gn_ch,
                                       GridGemm s) {
  const int n_col = (g.N + kGroupN - 1) / kGroupN;
  const int item_rows = s.item_rows, pass = s.pass, stages = s.stages;
  const int n_row = (g.rows + item_rows - 1) / item_rows;
  const int stripe = g.taps * (g.cin_pad >> 5);
  const int stripe_stages = (stripe + Fmt<f16>::kStageTiles - 1) /
                            Fmt<f16>::kStageTiles;
  const int ldw = g.cin_pad + 8;
  f16* win = reinterpret_cast<f16*>(cx.ring + cx.space - s.win_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Tiles<f16> tiles;
  for (int item = blockIdx.x; item < n_row * n_col; item += gridDim.x) {
    const int ng = item % n_col, r0 = (item / n_col) * item_rows;
    const int c0 = ng * kGroupN;
    const int rows = min(item_rows, g.rows - r0);
    const f16* wt = cx.Wp + static_cast<size_t>(tile0 + ng * stripe) *
                                kTileElems;
    for (int p0 = r0; p0 < r0 + rows; p0 += pass) {
      const size_t in0 = static_cast<size_t>(p0 / g.Tout * g.Tin) * g.lda;
      Gemm<f16> v = g;
      v.rows = min(pass, r0 + rows - p0);
      const int rows_in = v.rows / g.Tout * g.Tin;
      v.N = min(kGroupN, g.N - c0);
      v.bias = g.bias != nullptr ? g.bias + c0 : nullptr;
      v.out32 = g.out32 + static_cast<size_t>(p0) * g.ld32 + c0;
      v.outb = g.outb != nullptr
                   ? g.outb + static_cast<size_t>(p0) * g.ldob + c0
                   : nullptr;
      v.nb_cols = g.outb != nullptr ? min(kGroupN, g.nb_cols - c0) : 0;
      v.wtiles = wt;
      grid_stage(win, g.A + in0, g.lda, rows_in, g.cin_pad);
      v.A = win;
      v.lda = ldw;
      tiles.start(wt, cx.ring, stages, stripe_stages, stripe_stages);
      ldp::cp_async_wait_pending(stages - 1);   // the input's group
      __syncthreads();
      gemm<kGridMt>(v, tiles, cx.zero_addr);
      tiles.ring.drain();
      __syncthreads();   // the ring and the window are free again
      if (lo != nullptr) {
        grid_stage(win, lo + in0, g.lda, rows_in, g.cin_pad);
        ldp::cp_async_wait<0>();
        __syncthreads();
        v.bias = nullptr;
        v.accum = true;
        v.global_only = true;
        gemm<kGridMt>(v, tiles, cx.zero_addr);
        __syncthreads();
      }
    }
    if (gn_ch > 0) {
      // the item's pairs, one a warp: x and x * x rounded to fp16, summed
      // in fp32 in group_norm_mish's order
      const int Tl = g.Tout, n = Tl * gn_ch;
      const int groups = (min(kGroupN, g.N - c0) + gn_ch - 1) / gn_ch;
      const int pairs = rows / Tl * groups;
      const float* y0 = g.out32 + static_cast<size_t>(r0) * g.ld32 + c0;
      for (int p = warp; p < pairs; p += kWarps) {
        const int b = p / groups, q = p - b * groups;
        const float* yb = y0 + static_cast<size_t>(b * Tl) * g.ld32 +
                          q * gn_ch;
        float s = 0.f, s2 = 0.f;
        for (int i = lane; i < n; i += 32) {
          const float x = yb[(i / gn_ch) * g.ld32 + i % gn_ch];
          s += roundw<f16>(x);
          s2 += roundw<f16>(x * x);
        }
        const float mu = ldp::warp_sum(s) / n;
        const float e2 = ldp::warp_sum(s2) / n;
        if (lane == 0) {
          const int pg = (r0 / Tl + b) * cx.G + c0 / gn_ch + q;
          cx.stats[2 * pg] = mu;
          cx.stats[2 * pg + 1] = e2 - mu * mu;   // the variance, for now
        }
      }
    }
  }
}

// GroupNorm -> Mish (-> FiLM) (-> + res) over y's M = B x Tl rows from the
// statistics grid_gemm wrote; out32 / outb / outlo as group_norm_mish.
__device__ __noinline__ void grid_gn_apply(const GridCtx& cx, float* cache, const float* y,
                              int ldy, int C, int Tl, int M, const f16* gs,
                              const f16* gb, const Film* film,
                              const float* res, int ldr, float* out32,
                              f16* outb, int ldob, f16* outlo = nullptr) {
  int rlo, rhi;
  grid_rows(M, rlo, rhi);
  if (rlo >= rhi) return;   // block-uniform
  const int G = cx.G, Cg = C / G;
  const int blo = rlo / Tl, pairs = ((rhi - 1) / Tl + 1 - blo) * G;
  // JAX broadcasts the statistics with 0/1 matmuls: a non-finite mean
  // (variance) of one group is NaN in the sample's other groups
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int q0 = (blo + p / G) * G, own = q0 + p % G;
    bool bad_mu = false, bad_var = false;
    for (int q = q0; q < q0 + G; ++q)
      if (q != own) {
        bad_mu |= !isfinite(cx.stats[2 * q]);
        bad_var |= !isfinite(cx.stats[2 * q + 1]);
      }
    const float var =
        bad_var ? __int_as_float(0x7fc00000) : cx.stats[2 * own + 1];
    cache[2 * p] = bad_mu ? __int_as_float(0x7fc00000) : cx.stats[2 * own];
    cache[2 * p + 1] = rsqrtf(var + kGnEps);
  }
  __syncthreads();
  // FiLM's scale and bias rounded where the JAX kernel broadcasts them
  // with a matmul (a width not a multiple of 128, Tl > 1)
  const bool round_film = (C % 128) != 0 && Tl > 1;
  const int Cp = pad32(C), total = (rhi - rlo) * Cp;
  // kBatch elements a thread at a time, their loads issued before any
  // store (out32 may be y itself), so their latencies overlap
  constexpr int kBatch = 4;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float yv[kBatch], rv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x;
      const int r = rlo + i / Cp, c = i % Cp;
      yv[k] = rv[k] = 0.f;
      if (i < total && c < C) {
        yv[k] = y[static_cast<size_t>(r) * ldy + c];
        if (res != nullptr) rv[k] = res[static_cast<size_t>(r) * ldr + c];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i >= total) break;
      const int r = rlo + i / Cp, c = i % Cp;
      float v = 0.f;
      if (c < C) {
        const int b = r / Tl, p = (b - blo) * G + c / Cg;
        v = (yv[k] - cache[2 * p]) * cache[2 * p + 1] * tof(gs[c]) +
            tof(gb[c]);
        v = ldp::mishf(v);
        if (film != nullptr) {
          const float* fg = film->g + static_cast<size_t>(b) * film->ld;
          float sc = __ldg(film->t + c) + __ldg(fg + c);
          float bi = __ldg(film->t + C + c) + __ldg(fg + C + c);
          if (round_film) {
            sc = roundw<f16>(sc);
            bi = roundw<f16>(bi);
          }
          v = sc * v + bi;
        }
        if (res != nullptr) v += rv[k];
        if (out32 != nullptr) out32[static_cast<size_t>(r) * ldy + c] = v;
      }
      const size_t o = static_cast<size_t>(r) * ldob + c;
      if (outb != nullptr) outb[o] = fromf<f16>(v);
      if (outlo != nullptr) {
        const float hi = roundw<f16>(v);
        outlo[o] = fromf<f16>(isfinite(hi) ? v - hi : 0.f);
      }
    }
  }
  __syncthreads();   // the next pass refills the cache
}

// gd is read in place (__grid_constant__): the GEMM table is indexed by a
// counter, which would otherwise copy it to each thread's local memory.
__global__ void __launch_bounds__(kThreads, 1) unet1d_grid_kernel(
    const float* __restrict__ x_init, const float* __restrict__ coefs,
    const float* __restrict__ noise, const f16* __restrict__ Wp,
    const int* __restrict__ prog, const float* __restrict__ film_t,
    const float* __restrict__ film_g, char* scratch,
    float* __restrict__ out, Dims d, const __grid_constant__ GridDims gd,
    float clip) {
  extern __shared__ uint4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int B = d.B, T = d.T, D = d.D, K = d.K, G = d.G;
  // shared: [zero row | statistics cache | ring ... window]
  f16* zero = reinterpret_cast<f16*>(sm);
  float* cache = reinterpret_cast<float*>(sm + 32);
  GridCtx cx;
  cx.Wp = Wp;
  cx.ring = sm + 32 + 4 * kGridStatFloats;
  cx.space = gd.space;
  cx.zero_addr = ldp::smem_u32(zero);
  cx.stats = reinterpret_cast<float*>(scratch + gd.stats);
  cx.G = G;
  if (tid < 16) zero[tid] = fromf<f16>(0.f);
  unsigned* bar = reinterpret_cast<unsigned*>(scratch + gd.bar);
  unsigned gen = 0;
  float* X32 = reinterpret_cast<float*>(scratch + gd.x32);
  float* Y32 = reinterpret_cast<float*>(scratch + gd.y32);
  f16* Xb = reinterpret_cast<f16*>(scratch + gd.xb);
  f16* Yb = reinterpret_cast<f16*>(scratch + gd.yb);
  f16* skipb = reinterpret_cast<f16*>(scratch + gd.skip);
  float* skip32 = reinterpret_cast<float*>(skipb + d.skip_total);
  float* xcur = reinterpret_cast<float*>(scratch + gd.xcur);
  const f16* V = Wp + d.vec_base;
  const int M0 = B * T;
  const int lf = ld32(D), lb = ldb<f16>(D), Cd = pad32(D);
  int rlo, rhi;
  grid_rows(M0, rlo, rhi);

  // the initial sample, and its operand copies for step 0
  for (int i = tid; i < (rhi - rlo) * Cd; i += NT) {
    const int r = rlo + i / Cd, c = i % Cd;
    const float v = c < D ? x_init[static_cast<size_t>(r) * D + c] : 0.f;
    if (c < D) {
      xcur[static_cast<size_t>(r) * D + c] = v;
      X32[static_cast<size_t>(r) * lf + c] = v;
    }
    Xb[static_cast<size_t>(r) * lb + c] = fromf<f16>(v);
  }
  grid_sync(bar, gen);

  for (int step = 0; step < d.n_steps; ++step) {
    int gi = 0;   // the step's GEMMs so far: their row of gd.gemm
    for (int op = 0; op < d.n_ops; ++op) {
      const int* rec = prog + op * kRec;
      const int kind = rec[0];
      if (kind == kFilm) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const f16* v1 = V + rec[8];
        const f16* v2 = V + rec[9];
        const int rows = B * Tl, np = padn(ch);
        Gemm<f16> g{};
        g.A = Xb; g.lda = ldb<f16>(cin); g.cin_pad = pad32(cin); g.taps = K;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = rows; g.N = ch;
        g.bias = v1; g.out32 = Y32; g.ld32 = ld32(ch);
        grid_gemm(cx, g, rec[4], nullptr, ch / G, gd.gemm[gi++]);
        grid_sync(bar, gen);
        Film film{film_t + static_cast<size_t>(step) * d.film_ld + rec[6],
                  film_g + rec[6], d.film_ld, 0, B};
        grid_gn_apply(cx, cache, Y32, ld32(ch), ch, Tl, rows, v1 + np,
                      v1 + np + ch, &film, nullptr, 0, nullptr, Yb,
                      ldb<f16>(ch));
        grid_sync(bar, gen);
        g.A = Yb; g.lda = ldb<f16>(ch); g.cin_pad = pad32(ch); g.bias = v2;
        grid_gemm(cx, g, rec[5], nullptr, ch / G, gd.gemm[gi++]);
        grid_sync(bar, gen);
        if (rec[7] >= 0) {
          grid_gn_apply(cx, cache, Y32, ld32(ch), ch, Tl, rows, v2 + np,
                        v2 + np + ch, nullptr, nullptr, 0, Y32, nullptr, 0);
          grid_sync(bar, gen);
          Gemm<f16> p{};
          p.A = Xb; p.lda = ldb<f16>(cin); p.cin_pad = pad32(cin); p.taps = 1;
          p.mode = kSame; p.Tin = Tl; p.Tout = Tl; p.rows = rows; p.N = ch;
          p.bias = V + rec[10]; p.out32 = Y32; p.ld32 = ld32(ch);
          p.accum = true; p.outb = Yb; p.ldob = ldb<f16>(ch);
          p.nb_cols = pad32(ch);
          grid_gemm(cx, p, rec[7], nullptr, 0, gd.gemm[gi++]);
        } else {
          grid_gn_apply(cx, cache, Y32, ld32(ch), ch, Tl, rows, v2 + np,
                        v2 + np + ch, nullptr, X32, ld32(cin), Y32, Yb,
                        ldb<f16>(ch));
        }
        grid_sync(bar, gen);
        float* t32 = X32; X32 = Y32; Y32 = t32;
        f16* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kSave) {
        // the op after a SAVE reads Xb and writes Y32 and Yb only, and the
        // CONCAT that reads the skip comes after barriers: none here
        const int n = B * rec[3];
        int lo, hi;
        grid_rows(n, lo, hi);
        const int lsb = ldb<f16>(rec[2]) / 8;   // uint4 a row
        grid_copy(reinterpret_cast<uint4*>(skipb + rec[1]) + lo * lsb,
                  reinterpret_cast<const uint4*>(Xb) + lo * lsb,
                  (hi - lo) * lsb);
        if (rec[4]) {
          const int ls = ld32(rec[2]) / 4;
          grid_copy(reinterpret_cast<uint4*>(skip32 + rec[5]) + lo * ls,
                    reinterpret_cast<const uint4*>(X32) + lo * ls,
                    (hi - lo) * ls);
        }
      } else if (kind == kConcat) {
        const int C1 = rec[2], C2 = rec[3], Tl = rec[4], Cp = pad32(C1 + C2);
        const int l1 = ldb<f16>(C1), l2 = ldb<f16>(C2), lo = ldb<f16>(C1 + C2);
        const f16* sk = skipb + rec[1];
        int r0, r1;
        grid_rows(B * Tl, r0, r1);
        const int total = (r1 - r0) * Cp;
        for (int i0 = tid; i0 < total; i0 += 4 * NT) {
          f16 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = i0 + k * NT;
            const int r = r0 + i / Cp, c = i % Cp;
            v[k] = i >= total ? fromf<f16>(0.f)
                   : c < C1 ? Xb[static_cast<size_t>(r) * l1 + c]
                   : c < C1 + C2 ? sk[static_cast<size_t>(r) * l2 + c - C1]
                                 : fromf<f16>(0.f);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = i0 + k * NT;
            if (i < total)
              Yb[static_cast<size_t>(r0 + i / Cp) * lo + i % Cp] = v[k];
          }
        }
        if (rec[5]) {   // [h | skip] in fp32 too: the block's residual
          const float* s32 = skip32 + rec[6];
          const int C = C1 + C2, f1 = ld32(C1), f2 = ld32(C2), fo = ld32(C);
          for (int i = tid; i < (r1 - r0) * C; i += NT) {
            const int r = r0 + i / C, c = i % C;
            Y32[static_cast<size_t>(r) * fo + c] =
                c < C1 ? X32[static_cast<size_t>(r) * f1 + c]
                       : s32[static_cast<size_t>(r) * f2 + c - C1];
          }
        }
        grid_sync(bar, gen);
        f16* tb = Xb; Xb = Yb; Yb = tb;
        if (rec[5]) {
          float* t32 = X32; X32 = Y32; Y32 = t32;
        }
      } else if (kind == kDown || kind == kUp) {
        const int ch = rec[1], Tin = rec[2];
        const int Tout = kind == kDown ? Tin / 2 : 2 * Tin;
        Gemm<f16> g{};
        g.A = Xb; g.lda = ldb<f16>(ch); g.cin_pad = pad32(ch);
        g.taps = kind == kDown ? 3 : 4;
        g.mode = kind == kDown ? kStride2 : kTranspose;
        g.Tin = Tin; g.Tout = Tout; g.rows = B * Tout; g.N = ch;
        g.bias = V + rec[4]; g.out32 = Y32; g.ld32 = ld32(ch);
        g.outb = Yb; g.ldob = ldb<f16>(ch); g.nb_cols = pad32(ch);
        // the JAX kernel's downsample rounds its output where the width is
        // not a multiple of 128 (a selection matmul)
        g.round32 = kind == kDown && ch % 128 != 0;
        grid_gemm(cx, g, rec[3], nullptr, 0, gd.gemm[gi++]);
        grid_sync(bar, gen);
        float* t32 = X32; X32 = Y32; Y32 = t32;
        f16* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kFinalBlock) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const f16* v1 = V + rec[5];
        const int np = padn(ch);
        Gemm<f16> g{};
        g.A = Xb; g.lda = ldb<f16>(cin); g.cin_pad = pad32(cin); g.taps = K;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = B * Tl; g.N = ch;
        g.bias = v1; g.out32 = Y32; g.ld32 = ld32(ch);
        grid_gemm(cx, g, rec[4], nullptr, ch / G, gd.gemm[gi++]);
        grid_sync(bar, gen);
        // the lo half of the result into Xb (this GEMM's input, read)
        grid_gn_apply(cx, cache, Y32, ld32(ch), ch, Tl, B * Tl, v1 + np,
                      v1 + np + ch, nullptr, nullptr, 0, nullptr, Yb,
                      ldb<f16>(ch), Xb);
        grid_sync(bar, gen);
        f16* tb = Xb; Xb = Yb; Yb = tb;
      } else {  // kFinalConv: eps into Y32, the lo half's pass after
        const int cin = rec[1], Dout = rec[2], Tl = rec[3];
        Gemm<f16> g{};
        g.A = Xb; g.lda = ldb<f16>(cin); g.cin_pad = pad32(cin); g.taps = 1;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = B * Tl; g.N = Dout;
        g.bias = V + rec[5]; g.out32 = Y32; g.ld32 = ld32(Dout);
        grid_gemm(cx, g, rec[4], Yb, 0, gd.gemm[gi++]);
        grid_sync(bar, gen);
      }
    }

    if (gi != gd.n_gemms) __trap();   // the table is another program's
    // the step update, and the next step's copies of the sample
    const float k0 = coefs[step * 6 + 0], k1 = coefs[step * 6 + 1];
    const float k2 = coefs[step * 6 + 2], k3 = coefs[step * 6 + 3];
    const float k4 = coefs[step * 6 + 4], kx = coefs[step * 6 + 5];
    const float* nz = noise == nullptr ? nullptr
        : noise + static_cast<size_t>(step) * B * T * D;
    for (int i = tid; i < (rhi - rlo) * Cd; i += NT) {
      const int r = rlo + i / Cd, c = i % Cd;
      float xn = 0.f;
      if (c < D) {
        const size_t e = static_cast<size_t>(r) * D + c;
        const float x = xcur[e];
        float x0 = k0 * fmaf(-k1, Y32[static_cast<size_t>(r) * lf + c],
                             __fmul_rn(kx, x));
        if (x0 == x0) x0 = fminf(fmaxf(x0, -clip), clip);   // NaN kept
        xn = k2 * x0 + k3 * x;
        if (nz != nullptr) xn += k4 * __ldg(nz + e);
        xcur[e] = xn;
        X32[static_cast<size_t>(r) * lf + c] = xn;
      }
      Xb[static_cast<size_t>(r) * lb + c] = fromf<f16>(xn);
    }
    grid_sync(bar, gen);
  }
  for (int i = rlo * D + tid; i < rhi * D; i += NT) out[i] = xcur[i];
}

// The host side of a grid-mode call: the prologue, then the grid kernel as
// a cooperative launch (every block resident at once, which the barrier
// needs). Returns a cudaError_t.
inline int unet1d_sample_grid(const float* gcond, const float* x_init,
                              const int* ts, const float* coefs,
                              const float* noise, const void* w,
                              const int* prog, float* film_t, float* film_g,
                              void* scratch, float* out, const int* dims,
                              int n_dims, const long long* gdims,
                              int n_gdims, float clip, void* stream) {
  if (n_dims != kNDims || n_gdims < kNGridDims || scratch == nullptr ||
      gdims[11] < 1 || gdims[11] > kGridMaxGemms ||
      n_gdims != kNGridDims + 4 * gdims[11])
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  int* fields = reinterpret_cast<int*>(&d);
  for (int i = 0; i < kNDims; ++i) fields[i] = dims[i];
  GridDims gd;
  gd.blocks = static_cast<int>(gdims[0]);
  gd.smem = static_cast<int>(gdims[1]);
  gd.space = static_cast<int>(gdims[2]);
  gd.x32 = gdims[3]; gd.y32 = gdims[4]; gd.xb = gdims[5]; gd.yb = gdims[6];
  gd.skip = gdims[7]; gd.xcur = gdims[8]; gd.stats = gdims[9];
  gd.bar = gdims[10];
  gd.n_gemms = static_cast<int>(gdims[11]);
  // each GEMM's items of whole m16 tiles (kGridMt at most), passes that
  // divide them, and a window beside a ring of 2 to 8 stages in `space`
  for (int i = 0; i < gd.n_gemms; ++i) {
    const long long* r = gdims + kNGridDims + 4 * i;
    GridGemm& s = gd.gemm[i];
    s = GridGemm{static_cast<int>(r[0]), static_cast<int>(r[1]),
                 static_cast<int>(r[2]), static_cast<int>(r[3])};
    if (s.item_rows < 1 || s.item_rows > 16 * kGridMt || s.pass < 1 ||
        s.item_rows % s.pass || s.stages < 2 || s.stages > 8 ||
        s.win_bytes < 0 || s.win_bytes % 128 ||
        s.win_bytes + s.stages * Sizes<f16>::kStageBytes > gdims[2])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d.tile_n != kGroupN || gd.blocks < 1 ||
      d.cond_rows != kCondRows || gd.bar % 8 ||
      gd.space != gd.smem - 32 - 4 * kGridStatFloats ||
      d.cond_chunk < 32 || d.cond_chunk % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto Wp = static_cast<const f16*>(w);
  auto sc = static_cast<char*>(scratch);
  cudaError_t err = ldp::allow_smem(unet1d_prologue_kernel<f16>, d.smem_pro);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pro_grid = d.n_steps + (d.B + d.cond_rows - 1) / d.cond_rows;
  unet1d_prologue_kernel<f16><<<pro_grid, kThreads, d.smem_pro, st>>>(
      gcond, ts, Wp, film_t, film_g, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(sc + gd.bar, 0, 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ldp::allow_smem(unet1d_grid_kernel, gd.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<float**>(&x_init), const_cast<float**>(&coefs),
                  const_cast<float**>(&noise),  const_cast<f16**>(&Wp),
                  const_cast<int**>(&prog),     &film_t,
                  &film_g,                      &sc,
                  &out,                         &d,
                  &gd,                          &clip};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(unet1d_grid_kernel), dim3(gd.blocks),
      dim3(kThreads), args, gd.smem, st);
  return static_cast<int>(err);
}

}  // namespace
