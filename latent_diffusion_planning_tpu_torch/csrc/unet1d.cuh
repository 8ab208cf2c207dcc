// Kernel B's implementation (see diffusion_unet1d.cu for the design),
// templated on the type W of the weights and of the GEMM operand buffers:
//   bf16  (diffusion_unet1d.cu): mma.sync m16n8k16 bf16 x bf16, operands
//         read with ldmatrix; a ring stage is 3 tiles of 8 KB;
//   fp16  (diffusion_unet1d_f16.cu): the JAX kernel's dtype=float16, the
//         bf16 program with fp16 operands (mma.sync m16n8k16 f16 x f16),
//         which rounds where the JAX kernel rounds: GroupNorm's statistics
//         from x and x*x rounded to fp16 (E[x^2] - E[x]^2, non-finite
//         statistics spread to the sample's other groups as JAX's 0/1
//         broadcast matmuls spread them), FiLM's scale and bias and the
//         downsample's output rounded where the JAX kernel's layout rounds
//         them (a level whose width is not a multiple of 128), the final
//         1x1 conv on the fp32 activations (split hi + lo in fp16), and a
//         NaN kept through the clip;
//   float (diffusion_unet1d_f32.cu): the JAX kernel's dtype=float32. Every
//         product runs as error-compensated TF32 on the tensor cores, as in
//         kernel A: each operand split a = hi + lo, hi*hi + hi*lo + lo*hi on
//         mma.sync m16n8k8 summed in fp32, a tile's products from zero and
//         added to the fp32 sum on the CUDA cores (fp32-accurate results).
//         Tiles are 16 KB. The main kernel streams them through SliceTiles:
//         a warp reads 1 KB of each tile, so each thread copies exactly the
//         32 bytes it reads into a ring of its own (cp.async), and no stage
//         costs a barrier; the prologue keeps WeightRing. A row's K slots
//         of a 16-channel half are four consecutive channels (the tiles'
//         order), read as one 16-byte plain load at a row stride of 16 mod
//         32 floats (conflict-free), so the wide mode can keep the fp32
//         buffers and skips (and, where they do not fit, the operand
//         buffers) in the per-block global scratch, which frees shared
//         memory for two samples a block at the default widths. The wide
//         instance's GEMM splits each tile's K between warp pairs, so one A
//         split feeds two n8 column blocks, and for at most 8 rows (the
//         deepest level) runs transposed: 16 output columns by the 8 rows a
//         mma, no empty rows.
// One translation unit instantiates one W, so the three build in parallel
// and no instance set costs another registers.
//
// A GEMM of more rows than an instance holds (a plan past 256 steps in
// bf16 / fp16, past 128 rows in fp32, past 32 in the fp32 wide mode) walks
// its row tiles in groups of the instance's limit, each group one pass over
// the GEMM's weight tiles: the last group takes them from the stream's ring,
// the ones before read them from global memory (Gemm::wtiles; the stream
// brings them into L2). Only the largest instance of a mode takes such rows,
// in a copy of its own (kGroups), so no other instance pays registers for
// the groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "stream.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

enum Op : int {
  kFilm = 0,        // cin ch Tl t1 t2 film_off tproj v1 v2 vproj
  kSave = 1,        // skip_off C Tl
  kConcat = 2,      // skip_off C_h C_skip Tl
  kDown = 3,        // ch Tl_in tile vec
  kUp = 4,          // ch Tl_in tile vec
  kFinalBlock = 5,  // cin ch Tl tile vec
  kFinalConv = 6,   // cin D Tl tile vec
};
constexpr int kRec = 12;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupN = 8 * kWarps;             // columns of a tile: 8 a warp
constexpr int kTileElems = 32 * kGroupN;        // 32 K-rows x kGroupN columns
constexpr int kChunk = 3;          // bf16 tiles a warp takes at a time
constexpr int kCondRows = 64;      // samples per prologue cond block
constexpr float kGnEps = 1e-6f;

template <typename W>
struct Fmt;
template <>
struct Fmt<bf16> {
  static constexpr int kStageTiles = 3;
  static constexpr int kPad = 8;    // ldmatrix rows miss each other's banks
};
template <>
struct Fmt<f16> : Fmt<bf16> {};
template <>
struct Fmt<float> {
  static constexpr int kStageTiles = 1;
  static constexpr int kPad = 16;   // a quarter warp's two rows of 16-byte
                                    // loads miss each other's banks
};
template <typename W>
struct Sizes {
  static constexpr int kTileBytes = kTileElems * static_cast<int>(sizeof(W));
  static constexpr int kStageBytes = Fmt<W>::kStageTiles * kTileBytes;
};

enum ConvMode { kSame = 0, kStride2 = 1, kTranspose = 2 };

__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tof(f16 v) { return __half2float(v); }
__device__ __forceinline__ float tof(float v) { return v; }
template <typename W>
__device__ __forceinline__ W fromf(float v);
template <>
__device__ __forceinline__ bf16 fromf<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ f16 fromf<f16>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float fromf<float>(float v) { return v; }
// v through W and back (the value an operand of type W holds)
template <typename W>
__device__ __forceinline__ float roundw(float v) {
  return tof(fromf<W>(v));
}

__device__ __forceinline__ int pad32(int c) { return (c + 31) & ~31; }
__device__ __forceinline__ int padn(int c) {
  return (c + kGroupN - 1) / kGroupN * kGroupN;
}
template <typename W>
__device__ __forceinline__ int ldb(int c) { return pad32(c) + Fmt<W>::kPad; }
__device__ __forceinline__ int ld32(int c) { return c + 8; }

// The packed stream, tile by tile, through the ring.
template <typename W>
struct Tiles {
  static constexpr int kStageTiles = Fmt<W>::kStageTiles;
  ldp::WeightRing<Sizes<W>::kStageBytes> ring;
  const char* stage;
  int pos;

  __device__ void start(const W* stream, void* smem, int stages, int cycle,
                        int total) {
    ring.start(stream, smem, stages, cycle, total);
    pos = kStageTiles;
  }
  // Tiles left in the current stage (entering the next one when it is
  // used up), and a pointer to the next n of them.
  __device__ int avail() {
    if (pos == kStageTiles) {
      stage = ring.enter();
      pos = 0;
    }
    return kStageTiles - pos;
  }
  __device__ const char* take(int n) {
    const char* p = stage + pos * Sizes<W>::kTileBytes;
    pos += n;
    return p;
  }
  // Skip the zero tiles that pad the stream to whole stages.
  __device__ void align() { pos = kStageTiles; }
  // The fp32 GEMM's interface (SliceTiles'): the next tile, and the end of
  // its reads (nothing to do: enter() holds the block's barrier).
  __device__ const W* tile() {
    avail();
    return reinterpret_cast<const W*>(take(1));
  }
  __device__ void release() {}
};

// The fp32 main kernel's stream as each thread's own: a warp's fp32 GEMM
// reads 1 KB of each 16 KB tile, two 512-byte runs (kSplitK false: its own
// 8 columns, warp w's slice; true, the k-split GEMM's: the k-half w / 8 of
// slices 2 (w % 8) and 2 (w % 8) + 1), and each lane reads 16 bytes of each
// run at lane * 16, so each thread copies exactly what it reads with two
// 16-byte cp.async a tile into a ring of `stages` tiles, waits on its own
// copies and refills the slot it has read: no barrier of any kind.
template <bool kSplitK>
struct SliceTiles {
  const char* src;
  char* buf;
  int stages, cycle, left, src_stage, fill_slot, slot;
  int off0, off1;   // this lane's 16 bytes of the two runs, in a tile

  __device__ void fill() {
    if (left > 0) {
      const char* s = src + static_cast<size_t>(src_stage) *
                                Sizes<float>::kTileBytes;
      const uint32_t d = ldp::smem_u32(buf + fill_slot *
                                             Sizes<float>::kTileBytes);
      ldp::cp_async16(d + off0, s + off0);
      ldp::cp_async16(d + off1, s + off1);
      --left;
      if (++src_stage == cycle) src_stage = 0;
    }
    if (++fill_slot == stages) fill_slot = 0;
    ldp::cp_async_commit();
  }
  __device__ void start(const float* stream, void* smem, int ring_stages,
                        int cycle_stages, int total) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    src = reinterpret_cast<const char*>(stream);
    buf = static_cast<char*>(smem);
    stages = ring_stages;
    cycle = cycle_stages;
    left = total;
    src_stage = fill_slot = slot = 0;
    if (kSplitK) {
      off0 = 2 * (warp & 7) * 1024 + (warp >> 3) * 512 + lane * 16;
      off1 = off0 + 1024;
    } else {
      off0 = warp * 1024 + lane * 16;
      off1 = off0 + 512;
    }
    for (int n = 0; n < stages - 1; ++n) fill();
  }
  __device__ const float* tile() {
    ldp::cp_async_wait_pending(stages - 2);
    fill();   // the slot this thread read last
    const char* p = buf + slot * Sizes<float>::kTileBytes;
    if (++slot == stages) slot = 0;
    return reinterpret_cast<const float*>(p);
  }
  __device__ void release() {}
  __device__ void align() {}
  __device__ void finish() { ldp::cp_async_wait<0>(); }
};

// Source row of output row r for one tap, or -1 (reads zeros).
__device__ __forceinline__ int src_row(int mode, int r, int rows, int Tin,
                                       int Tout, int tap, int pad) {
  if (r >= rows) return -1;
  const int b = r / Tout, t = r - b * Tout;
  int s;
  if (mode == kSame) {
    s = t + tap - pad;
    if (s < 0 || s >= Tin) return -1;
  } else if (mode == kStride2) {
    s = 2 * t + tap;
    if (s >= Tin) return -1;
  } else {
    s = t + tap - 2;
    if (s < 0 || (s & 1) || (s >> 1) >= Tin) return -1;
    s >>= 1;
  }
  return b * Tin + s;
}

template <typename W>
struct Gemm {
  const W* A;       // operand rows (shared memory; or global, fp32 read
                    // directly, bf16 through `stage`)
  int lda;          // its row stride, elements
  W* stage;         // bf16 with A in global memory: a window of A's
                    // channels for every input row in shared memory (room
                    // for stage_cap elements); else null
  int stage_cap;
  int cin_pad;      // channels per tap, padded to 32
  int taps, mode, Tin, Tout;
  int rows;         // nb * Tout
  int N;            // output columns
  const W* bias;    // padn(N) values, or null
  float* out32;     // fp32 result (shared or global), or null
  int ld32;
  bool accum;       // add to what out32 holds
  bool mish;
  W* outb;          // operand copy of the result (of the next GEMM)
  int ldob;
  int nb_cols;      // columns of outb to write (zeros from N on)
  bool round32;     // out32 holds the result rounded through W (fp16: where
                    // the JAX kernel rounds it)
  const W* wtiles;  // the GEMM's first weight tile in global memory, read
                    // by the row groups before the last (or null)
  bool global_only; // every row group reads wtiles; the ring is untouched
};

// The epilogue of one 128-column group: bias + sum (+ out32), Mish, out32,
// and the operand copy.
template <typename W, int kMtMax>
__device__ __forceinline__ void gemm_store(const Gemm<W>& g, int MT, int col,
                                           int gq, float (&acc)[kMtMax][4],
                                           int r0 = 0) {
#pragma unroll
  for (int mt = 0; mt < kMtMax; ++mt) {
    if (mt < MT) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + mt * 16 + gq + 8 * h;
        if (r < g.rows) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col + e;
            float v = acc[mt][2 * h + e];
            if (c < g.N) {
              if (g.accum) v += g.out32[static_cast<size_t>(r) * g.ld32 + c];
              if (g.mish) v = ldp::mishf(v);
              if constexpr (std::is_same<W, f16>::value)
                if (g.round32) v = roundw<W>(v);
              if (g.out32 != nullptr)
                g.out32[static_cast<size_t>(r) * g.ld32 + c] = v;
            } else {
              v = 0.f;
            }
            if (g.outb != nullptr && c < g.nb_cols)
              g.outb[r * g.ldob + c] = fromf<W>(v);
          }
        }
      }
    }
  }
}

// x = hi + lo: hi rounded to TF32, lo the exact rest, which the tensor
// core reads as TF32 by dropping its low 13 bits (an error of at most
// 2^-21 |x|, where rounding lo too would cost an instruction an operand).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = ldp::to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc += (A rows of one m16 row tile) x (a tile's B fragments), 3xTF32:
// r0 / r1 the lane's rows g and g + 8 (l0 / l1: inside a sample), the four
// k8 steps in two independent chains, each summed from zero on the tensor
// core (which truncates) and added on the CUDA cores (which round to
// nearest). kUpper false: rows 8-15 of the tile lie past the block's rows
// (warp-uniform; a tile of 8 rows, the deep levels at two samples), so
// their operands are neither read nor split.
template <bool kUpper>
__device__ __forceinline__ void row_tile_products(
    float (&acc)[4], const float* r0, const float* r1, bool l0, bool l1,
    const uint32_t (&bh)[4][2], const uint32_t (&bl)[4][2]) {
  // the lane's K slots of each 16-row half h: channels 16 h + 4 tq .. + 3,
  // one 16-byte load a row (tile_matrix_f32's order)
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 f0[2], f1[2] = {z, z};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f0[h] = l0 ? *reinterpret_cast<const float4*>(r0 + 16 * h) : z;
    if constexpr (kUpper)
      f1[h] = l1 ? *reinterpret_cast<const float4*>(r1 + 16 * h) : z;
  }
  float p[2][4];
#pragma unroll
  for (int k8 = 0; k8 < 4; ++k8) {
    const float4& u = f0[k8 >> 1];
    const float4& v = f1[k8 >> 1];
    const bool odd = k8 & 1;
    uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
    split_tf32(odd ? u.z : u.x, ah[0], al[0]);
    split_tf32(odd ? u.w : u.y, ah[2], al[2]);
    if constexpr (kUpper) {
      split_tf32(odd ? v.z : v.x, ah[1], al[1]);
      split_tf32(odd ? v.w : v.y, ah[3], al[3]);
    }
    float (&c)[4] = p[k8 & 1];
    if (k8 < 2)
      ldp::mma_tf32_zero(c, al, bh[k8][0], bh[k8][1]);
    else
      ldp::mma_tf32(c, al, bh[k8][0], bh[k8][1]);
    ldp::mma_tf32(c, ah, bl[k8][0], bl[k8][1]);
    ldp::mma_tf32(c, ah, bh[k8][0], bh[k8][1]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[0][e] + p[1][e];
}

// out[r][n] = bias[n] + sum_tap sum_c A[src(r, tap)][c] W[tap][c][n], the
// weights taken tile by tile from the stream. Every thread of the block
// takes part in every tile. With g.stage set, A lies in global memory and
// ldmatrix reads a window of its channels that every input row has copied
// into g.stage: as many 32-channel runs as stage_cap holds at this GEMM's
// rows (all of cin where they fit), copied between two barriers only when a
// run of tiles reaches past the window, so a GEMM whose input fits copies
// it once for all its column groups and taps. Past 8 row tiles (a 256-row
// plan) the warp takes one tile at a time, which keeps its operand
// fragments to 8 registers beside 64 of accumulators. W is bf16 or fp16 (2
// bytes, the same fragments and tiles). Past kMtMax row tiles the rows are
// walked in groups of kMtMax (see the note at the top).
template <int kMtMax, bool kGroups = false, typename W,
          std::enable_if_t<sizeof(W) == 2, int> = 0>
__device__ void gemm(const Gemm<W>& g, Tiles<W>& tiles, uint32_t zero_addr) {
  constexpr int kTileBytes = Sizes<W>::kTileBytes;
  constexpr int kCh = kMtMax > 8 ? 1 : kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt_all = (g.rows + 15) >> 4;
  const int n_rg = kGroups ? (mt_all + kMtMax - 1) / kMtMax : 1;
  const int n_groups = (g.N + kGroupN - 1) / kGroupN;
  const int kt_per_tap = g.cin_pad >> 5;
  const bool staged = g.stage != nullptr;
  const int rows_in = g.Tin * (g.rows / g.Tout + (g.rows % g.Tout != 0));
  // the window: wt tiles of channels a row at stride 32 wt + 8 (a stride
  // of 16 bytes past a multiple of 64, so ldmatrix's rows miss each other's
  // banks); w0 its first tile, -1 before the first copy
  const int wt = staged ? min(kt_per_tap, (g.stage_cap / rows_in - 8) >> 5)
                        : 0;
  int w0 = -1;
  const int lda = staged ? 32 * wt + 8 : g.lda;
  const uint32_t a_base =
      ldp::smem_u32(staged ? g.stage : g.A) + (lane >> 4) * 16;
  const int pad = g.taps >> 1;
  for (int rg = 0; rg < n_rg; ++rg) {
    // block-uniform: the last group takes the ring's tiles, the ones
    // before read the same tiles from global memory (fp16's second pass of
    // the final conv reads them all from there)
    const bool ring = (!kGroups || rg == n_rg - 1) &&
                      !(std::is_same<W, f16>::value && g.global_only);
    const int mt0 = rg * kMtMax;
    const int MT = kGroups ? min(kMtMax, mt_all - mt0) : mt_all;
    const char* wg = reinterpret_cast<const char*>(g.wtiles);
    for (int ng = 0; ng < n_groups; ++ng) {
      const int col = ng * kGroupN + warp * 8 + 2 * tq;
      float acc[kMtMax][4];
      const float b0 = g.bias != nullptr ? tof(g.bias[col]) : 0.f;
      const float b1 = g.bias != nullptr ? tof(g.bias[col + 1]) : 0.f;
#pragma unroll
      for (int mt = 0; mt < kMtMax; ++mt) {
        acc[mt][0] = b0; acc[mt][1] = b1; acc[mt][2] = b0; acc[mt][3] = b1;
      }
      for (int tap = 0; tap < g.taps; ++tap) {
        uint32_t raddr[kMtMax];
        uint32_t live = 0;
#pragma unroll
        for (int mt = 0; mt < kMtMax; ++mt) {
          raddr[mt] = zero_addr;
          if (mt < MT) {
            const int sr = src_row(g.mode, (mt0 + mt) * 16 + (lane & 15),
                                   g.rows, g.Tin, g.Tout, tap, pad);
            if (sr >= 0) {
              raddr[mt] = a_base + static_cast<uint32_t>(sr * lda) * 2;
              live |= 1u << mt;
            }
          }
        }
        // up to kChunk tiles at a time: all their loads are
        // started before the products that need them, and the products run
        // in two independent chains, so a warp with one row tile (the deep
        // levels) is not a single chain of dependent instructions
        for (int kt = 0; kt < kt_per_tap;) {
          const int n = min(min(ring ? tiles.avail() : kCh, kCh),
                            kt_per_tap - kt);
          const char* tile =
              (ring ? tiles.take(n)
                    : wg + static_cast<size_t>((ng * g.taps + tap) *
                                                   kt_per_tap + kt) *
                               kTileBytes) +
              warp * 512 + lane * 16;
          if (staged && (w0 < 0 || kt < w0 || kt + n > w0 + wt)) {
            // channels [32 kt, 32 (kt + nw)) of every input row, 8 at a
            // time (block-uniform: every thread takes the same tiles)
            w0 = kt;
            const int nw = min(wt, kt_per_tap - kt);
            __syncthreads();   // no warp still reads the window before
            const int per_row = 4 * nw;
            for (int i = threadIdx.x; i < rows_in * per_row;
                 i += blockDim.x) {
              const int r = i / per_row, q = i - r * per_row;
              *reinterpret_cast<uint4*>(g.stage + r * lda + 8 * q) =
                  *reinterpret_cast<const uint4*>(g.A + r * g.lda + 32 * kt +
                                                  8 * q);
            }
            __syncthreads();
          }
          uint4 bq[kCh];
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            if (j < n)
              bq[j] = *reinterpret_cast<const uint4*>(tile + j * kTileBytes);
          const uint32_t k0 = (kt - (staged ? w0 : 0)) * 64;
#pragma unroll
          for (int mt = 0; mt < kMtMax; ++mt) {
            if (mt < MT) {
              const bool on = (live >> mt) & 1;
              const uint32_t ad = raddr[mt] + (on ? k0 : 0u);
              uint32_t a[kCh][2][4];
#pragma unroll
              for (int j = 0; j < kCh; ++j)
                if (j < n) {
                  ldp::ldmatrix_x4(a[j][0], ad + (on ? 64u * j : 0u));
                  ldp::ldmatrix_x4(a[j][1], ad + (on ? 64u * j + 32u : 0u));
                }
              // the tensor core truncates when it adds into its
              // accumulator; sum these tiles' products from zero there and
              // add the partial sums on the CUDA cores, which round to
              // nearest
              float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int j = 0; j < kCh; ++j)
                if (j < n) {
                  if constexpr (std::is_same<W, bf16>::value) {
                    ldp::mma_bf16(p0, a[j][0], bq[j].x, bq[j].y);
                    ldp::mma_bf16(p1, a[j][1], bq[j].z, bq[j].w);
                  } else {
                    ldp::mma_f16(p0, a[j][0], bq[j].x, bq[j].y);
                    ldp::mma_f16(p1, a[j][1], bq[j].z, bq[j].w);
                  }
                }
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][e] += p0[e] + p1[e];
            }
          }
          kt += n;
        }
      }
      gemm_store<W, kMtMax>(g, MT, col, gq, acc, mt0 * 16);
    }
  }
}

// The fp32 GEMM: one 16 KB tile (32 K-rows) at a time. Lane l of warp w
// holds the tile's m16n8k8 B fragments of columns [8w, 8w + 8) as two
// float4: (k8 0, b0 b1; k8 1, b0 b1) and (k8 2 ...; k8 3 ...), each read of
// the warp one contiguous 512 bytes; once they are split into registers the
// warp releases the tile, and the split feeds every row tile. The K slots
// tq and tq + 4 of a k8 step s of K-half h are rows 16 h + 4 tq + 2 s and
// + 1 (tile_matrix_f32), so the A fragments of a row (rows g and g + 8 of
// each row tile) for a half are one 16-byte load of channels 16 h + 4 tq ..
// + 3; a row outside its sample reads zeros. TilesT: Tiles<float> (the
// prologue) or SliceTiles<false> (the main kernel). Past kMtMax row tiles
// the rows are walked in groups (see the note at the top).
template <int kMtMax, bool kGroups = false, typename TilesT>
__device__ void gemm(const Gemm<float>& g, TilesT& tiles, uint32_t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt_all = (g.rows + 15) >> 4;
  const int n_rg = kGroups ? (mt_all + kMtMax - 1) / kMtMax : 1;
  const int n_groups = (g.N + kGroupN - 1) / kGroupN;
  const int kt_per_tap = g.cin_pad >> 5;
  const int pad = g.taps >> 1;
  for (int rg = 0; rg < n_rg; ++rg) {
    const bool ring = !kGroups || rg == n_rg - 1;
    const int mt0 = rg * kMtMax;
    const int MT = kGroups ? min(kMtMax, mt_all - mt0) : mt_all;
    for (int ng = 0; ng < n_groups; ++ng) {
      const int col = ng * kGroupN + warp * 8 + 2 * tq;
      float acc[kMtMax][4];
      const float b0 = g.bias != nullptr ? g.bias[col] : 0.f;
      const float b1 = g.bias != nullptr ? g.bias[col + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < kMtMax; ++mt) {
        acc[mt][0] = b0; acc[mt][1] = b1; acc[mt][2] = b0; acc[mt][3] = b1;
      }
      for (int tap = 0; tap < g.taps; ++tap) {
        int off[kMtMax][2];
        uint32_t live = 0;
#pragma unroll
        for (int mt = 0; mt < kMtMax; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            off[mt][h] = 0;
            if (mt < MT) {
              const int sr = src_row(g.mode, (mt0 + mt) * 16 + gq + 8 * h,
                                     g.rows, g.Tin, g.Tout, tap, pad);
              if (sr >= 0) {
                off[mt][h] = sr * g.lda + 4 * tq;
                live |= 1u << (2 * mt + h);
              }
            }
          }
        for (int kt = 0; kt < kt_per_tap; ++kt) {
          const float* tile =
              (ring ? tiles.tile()
                    : g.wtiles + static_cast<size_t>((ng * g.taps + tap) *
                                                         kt_per_tap + kt) *
                                     kTileElems) +
              warp * 256 + lane * 4;
          const float4 q0 = *reinterpret_cast<const float4*>(tile);
          const float4 q1 = *reinterpret_cast<const float4*>(tile + 128);
          const float bv[4][2] = {{q0.x, q0.y}, {q0.z, q0.w},
                                  {q1.x, q1.y}, {q1.z, q1.w}};
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int k8 = 0; k8 < 4; ++k8) {
            split_tf32(bv[k8][0], bh[k8][0], bl[k8][0]);
            split_tf32(bv[k8][1], bh[k8][1], bl[k8][1]);
          }
          if (ring) tiles.release();
          const int k0 = kt * 32;
#pragma unroll
          for (int mt = 0; mt < kMtMax; ++mt) {
            if (mt < MT) {
              const bool l0 = (live >> (2 * mt)) & 1;
              const bool l1 = (live >> (2 * mt + 1)) & 1;
              const float* r0 = g.A + off[mt][0] + k0;
              const float* r1 = g.A + off[mt][1] + k0;
              if ((mt0 + mt) * 16 + 8 < g.rows)
                row_tile_products<true>(acc[mt], r0, r1, l0, l1, bh, bl);
              else
                row_tile_products<false>(acc[mt], r0, r1, l0, l1, bh, bl);
            }
          }
        }
      }
      gemm_store<float, kMtMax>(g, MT, col, gq, acc, mt0 * 16);
    }
  }
}

// The wide instance's fp32 GEMM (two row tiles at most): the warps split
// each tile's K in halves and its columns in blocks of 16, so one A
// fragment split feeds two n8 column blocks. Warp w takes columns [16 (w %
// 8), +16) of the 128-column group and k8 steps {2 h, 2 h + 1}, h = w / 8
// (its B fragments: two float4 of the tile's layout); each (n8 block, k8)
// is a chain of three products. At a group's end each warp of a pair (w,
// w ^ 8) keeps one n8 block, sends the other's partial sums through `red`
// (per block, in the global scratch, two buffers by the group's parity)
// and adds what its partner sent, behind a barrier of the pair alone.
constexpr int kRedFloats = 2 * kWarps * 32 * 2 * 4;   // two buffers, kMt 2

template <bool kUpper>
__device__ __forceinline__ void ksplit_products(
    float (&acc0)[4], float (&acc1)[4], const float* r0, const float* r1,
    bool l0, bool l1, const uint32_t (&bh)[2][2][2],
    const uint32_t (&bl)[2][2][2]) {
  // the lane's K slots of the warp's half: 4 channels, one 16-byte load
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 u = l0 ? *reinterpret_cast<const float4*>(r0) : z;
  float4 v = z;
  if constexpr (kUpper) v = l1 ? *reinterpret_cast<const float4*>(r1) : z;
  float p[2][2][4];   // [n8 block][k8]
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
    split_tf32(kk ? u.z : u.x, ah[0], al[0]);
    split_tf32(kk ? u.w : u.y, ah[2], al[2]);
    if constexpr (kUpper) {
      split_tf32(kk ? v.z : v.x, ah[1], al[1]);
      split_tf32(kk ? v.w : v.y, ah[3], al[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ldp::mma_tf32_zero(p[j][kk], al, bh[j][kk][0], bh[j][kk][1]);
      ldp::mma_tf32(p[j][kk], ah, bl[j][kk][0], bl[j][kk][1]);
      ldp::mma_tf32(p[j][kk], ah, bh[j][kk][0], bh[j][kk][1]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc0[e] += p[0][0][e] + p[0][1][e];
    acc1[e] += p[1][0][e] + p[1][1][e];
  }
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// One output element of the fp32 GEMM's epilogue (gemm_store's, for the
// transposed k-split GEMM): bias and sum in v, + out32, Mish, out32, the
// operand copy.
__device__ __forceinline__ void store_elem(const Gemm<float>& g, int r, int c,
                                           float v) {
  if (r >= g.rows) return;
  if (c < g.N) {
    if (g.accum) v += g.out32[static_cast<size_t>(r) * g.ld32 + c];
    if (g.mish) v = ldp::mishf(v);
    if (g.out32 != nullptr) g.out32[static_cast<size_t>(r) * g.ld32 + c] = v;
  } else {
    v = 0.f;
  }
  if (g.outb != nullptr && c < g.nb_cols) g.outb[r * g.ldob + c] = v;
}

// gemm_ksplit for at most 8 rows (the deepest level at two samples, most of
// the default widths' tiles): the product transposed, out^T = W^T A^T, so
// the 16 x 8 mma tile holds 16 output columns by the 8 rows and carries no
// empty rows. The weights' fragments are the A operand as they stand: n8
// blocks 2 cb and 2 cb + 1 of a tile give rows g and g + 8 (columns 16 cb +
// g, + 8); a lane's activation row g, its K slots (four channels, one
// 16-byte load), is the B fragment. Warp w takes columns [16 (w % 8), +16)
// and k8 steps {2 h, 2 h + 1}, h = w / 8, as gemm_ksplit does; at a
// group's end warp h keeps the columns 16 cb + g + 8 h and takes its
// partner's partial sums of them. Rows row0 to row0 + 7; ring and round0 as
// in gemm_ksplit_rows.
template <typename TilesT>
__device__ void gemm_ksplit_t(const Gemm<float>& g, TilesT& tiles,
                              float* red, int row0, bool ring, int round0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int cb = warp & 7, kh = warp >> 3;
  const int n_groups = (g.N + kGroupN - 1) / kGroupN;
  const int kt_per_tap = g.cin_pad >> 5;
  const int pad = g.taps >> 1;
  for (int ng = 0; ng < n_groups; ++ng) {
    const int c0 = ng * kGroupN + cb * 16 + gq;   // this lane's columns c0, +8
    const bool biased = kh == 0 && g.bias != nullptr;
    const float blo = biased ? g.bias[c0] : 0.f;
    const float bhi = biased ? g.bias[c0 + 8] : 0.f;
    // (column c0, row 2 tq), (c0, 2 tq + 1), (c0 + 8, 2 tq), (c0 + 8, ...)
    float acc[4] = {blo, blo, bhi, bhi};
    for (int tap = 0; tap < g.taps; ++tap) {
      const int sr = src_row(g.mode, row0 + gq, g.rows, g.Tin, g.Tout, tap,
                             pad);
      const bool live = sr >= 0;
      const int off = live ? sr * g.lda + 4 * tq : 0;
      for (int kt = 0; kt < kt_per_tap; ++kt) {
        const float* tile =
            (ring ? tiles.tile()
                  : g.wtiles + static_cast<size_t>((ng * g.taps + tap) *
                                                       kt_per_tap + kt) *
                                   kTileElems) +
            kh * 128 + lane * 4;
        const float4 q0 = *reinterpret_cast<const float4*>(tile + 512 * cb);
        const float4 q1 =
            *reinterpret_cast<const float4*>(tile + 512 * cb + 256);
        // the weights as the A fragment of k8 step kk: (g, tq), (g + 8,
        // tq), (g, tq + 4), (g + 8, tq + 4)
        const float wv[2][4] = {{q0.x, q1.x, q0.y, q1.y},
                                {q0.z, q1.z, q0.w, q1.w}};
        uint32_t wh[2][4], wl[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(wv[kk][e], wh[kk][e], wl[kk][e]);
        if (ring) tiles.release();
        // the lane's K slots: 4 channels of its row, one 16-byte load
        const float4 x = live ? *reinterpret_cast<const float4*>(
                                    g.A + off + kt * 32 + 16 * kh)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        float p[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t xh0, xl0, xh1, xl1;
          split_tf32(kk ? x.z : x.x, xh0, xl0);
          split_tf32(kk ? x.w : x.y, xh1, xl1);
          ldp::mma_tf32_zero(p[kk], wl[kk], xh0, xh1);
          ldp::mma_tf32(p[kk], wh[kk], xl0, xl1);
          ldp::mma_tf32(p[kk], wh[kk], xh0, xh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p[0][e] + p[1][e];
      }
    }
    // warp kh keeps columns c0 + 8 kh and sends its partner the other two
    const int par = (round0 + ng) & 1;
    float* mine = red + ((par * kWarps + warp) * 32 + lane) * 8;
    const float* theirs =
        red + ((par * kWarps + (warp ^ 8)) * 32 + lane) * 8;
    mine[0] = kh ? acc[0] : acc[2];
    mine[1] = kh ? acc[1] : acc[3];
    pair_sync(1 + cb);
    const float v0 = (kh ? acc[2] : acc[0]) + theirs[0];
    const float v1 = (kh ? acc[3] : acc[1]) + theirs[1];
    store_elem(g, row0 + 2 * tq, c0 + 8 * kh, v0);
    store_elem(g, row0 + 2 * tq + 1, c0 + 8 * kh, v1);
  }
}

// gemm_ksplit over one group of rows, row0 to row0 + 16 kMtMax (more than
// 8);
// ring false: the weight tiles from global memory (a group before the last).
// round0: the column groups run before it in this GEMM (the partial sums'
// buffer parity continues across groups).
template <int kMtMax, typename TilesT>
__device__ void gemm_ksplit_rows(const Gemm<float>& g, TilesT& tiles,
                                 float* red, int row0, bool ring,
                                 int round0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int cb = warp & 7, kh = warp >> 3;
  const int MT = min(kMtMax, (g.rows - row0 + 15) >> 4);
  const int n_groups = (g.N + kGroupN - 1) / kGroupN;
  const int kt_per_tap = g.cin_pad >> 5;
  const int pad = g.taps >> 1;
  for (int ng = 0; ng < n_groups; ++ng) {
    const int col = ng * kGroupN + cb * 16 + 2 * tq;   // n8 block 2 cb; +8
    float acc0[kMtMax][4], acc1[kMtMax][4];
    const bool biased = kh == 0 && g.bias != nullptr;
    const float b00 = biased ? g.bias[col] : 0.f;
    const float b01 = biased ? g.bias[col + 1] : 0.f;
    const float b10 = biased ? g.bias[col + 8] : 0.f;
    const float b11 = biased ? g.bias[col + 9] : 0.f;
#pragma unroll
    for (int mt = 0; mt < kMtMax; ++mt) {
      acc0[mt][0] = b00; acc0[mt][1] = b01; acc0[mt][2] = b00;
      acc0[mt][3] = b01;
      acc1[mt][0] = b10; acc1[mt][1] = b11; acc1[mt][2] = b10;
      acc1[mt][3] = b11;
    }
    for (int tap = 0; tap < g.taps; ++tap) {
      int off[kMtMax][2];
      uint32_t live = 0;
#pragma unroll
      for (int mt = 0; mt < kMtMax; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          off[mt][h] = 0;
          if (mt < MT) {
            const int sr = src_row(g.mode, row0 + mt * 16 + gq + 8 * h,
                                   g.rows, g.Tin, g.Tout, tap, pad);
            if (sr >= 0) {
              off[mt][h] = sr * g.lda + 4 * tq;
              live |= 1u << (2 * mt + h);
            }
          }
        }
      for (int kt = 0; kt < kt_per_tap; ++kt) {
        const float* tile =
            (ring ? tiles.tile()
                  : g.wtiles + static_cast<size_t>((ng * g.taps + tap) *
                                                       kt_per_tap + kt) *
                                   kTileElems) +
            kh * 128 + lane * 4;
        const float4 q0 = *reinterpret_cast<const float4*>(tile + 512 * cb);
        const float4 q1 =
            *reinterpret_cast<const float4*>(tile + 512 * cb + 256);
        const float bv[2][2][2] = {{{q0.x, q0.y}, {q0.z, q0.w}},
                                   {{q1.x, q1.y}, {q1.z, q1.w}}};
        uint32_t bh[2][2][2], bl[2][2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            split_tf32(bv[j][kk][0], bh[j][kk][0], bl[j][kk][0]);
            split_tf32(bv[j][kk][1], bh[j][kk][1], bl[j][kk][1]);
          }
        if (ring) tiles.release();
        const int k0 = kt * 32 + 16 * kh;
#pragma unroll
        for (int mt = 0; mt < kMtMax; ++mt) {
          if (mt < MT) {
            const bool l0 = (live >> (2 * mt)) & 1;
            const bool l1 = (live >> (2 * mt + 1)) & 1;
            const float* r0 = g.A + off[mt][0] + k0;
            const float* r1 = g.A + off[mt][1] + k0;
            if (row0 + mt * 16 + 8 < g.rows)
              ksplit_products<true>(acc0[mt], acc1[mt], r0, r1, l0, l1, bh,
                                    bl);
            else
              ksplit_products<false>(acc0[mt], acc1[mt], r0, r1, l0, l1, bh,
                                     bl);
          }
        }
      }
    }
    // warp kh keeps n8 block 2 cb + kh and sends its partner the other
    const int par = (round0 + ng) & 1;
    float* mine = red + ((par * kWarps + warp) * 32 + lane) * 8;
    const float* theirs =
        red + ((par * kWarps + (warp ^ 8)) * 32 + lane) * 8;
#pragma unroll
    for (int mt = 0; mt < kMtMax; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[mt * 4 + e] = kh ? acc0[mt][e] : acc1[mt][e];
    pair_sync(1 + cb);
#pragma unroll
    for (int mt = 0; mt < kMtMax; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = theirs[mt * 4 + e];
        if (kh)
          acc1[mt][e] += t;
        else
          acc0[mt][e] += t;
      }
    if (kh)
      gemm_store<float, kMtMax>(g, MT, col + 8, gq, acc1, row0);
    else
      gemm_store<float, kMtMax>(g, MT, col, gq, acc0, row0);
  }
}

// The k-split GEMM over the rows (with kGroups in groups of 16 kMtMax, see
// the note at the top), each run transposed where it has at most 8.
template <int kMtMax, bool kGroups, typename TilesT>
__device__ void gemm_ksplit(const Gemm<float>& g, TilesT& tiles, float* red) {
  static_assert(kMtMax <= 2, "the k-split GEMM holds two row tiles");
  if constexpr (!kGroups) {
    if (g.rows <= 8)
      gemm_ksplit_t(g, tiles, red, 0, true, 0);
    else
      gemm_ksplit_rows<kMtMax>(g, tiles, red, 0, true, 0);
    return;
  }
  const int n_rg = (g.rows + 16 * kMtMax - 1) / (16 * kMtMax);
  for (int rg = 0; rg < n_rg; ++rg) {
    const bool ring = rg == n_rg - 1;
    const int r0 = rg * 16 * kMtMax;
    const int round0 = rg * ((g.N + kGroupN - 1) / kGroupN);
    if (g.rows - r0 <= 8)
      gemm_ksplit_t(g, tiles, red, r0, ring, round0);
    else
      gemm_ksplit_rows<kMtMax>(g, tiles, red, r0, ring, round0);
  }
}

struct Film {
  const float* __restrict__ t;  // this step's time half (scale [c], bias [C+c])
  const float* __restrict__ g;  // per-sample condition half, row stride ld
  int ld, b0, B;
};

// GroupNorm(G, eps 1e-6) -> Mish over y (nb*Tl rows x C, stride ldy), then
// FiLM when given, then + res when given. Writes the fp32 result to out32
// (stride ldy; may be y itself) and its operand copy, channels zero-padded
// to 32, to outb, each where given; outlo (fp16: the final block) gets what
// the operand copy misses of each value, v - hi, in W, so hi + lo carries
// the fp32 value to the final 1x1 conv. The fp16 instance computes the JAX
// kernel's statistics (see the note at the top).
template <typename W>
__device__ void group_norm_mish(const float* y, int ldy, int C, int Tl, int nb,
                                int G, const W* gs, const W* gb,
                                float* stats, const Film* film,
                                const float* res, int ldr, float* out32,
                                W* outb, int ldob, W* outlo = nullptr) {
  constexpr bool kJax = std::is_same<W, f16>::value;
  const int Cg = C / G, n = Tl * Cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int p = warp; p < nb * G; p += n_warps) {
    const int b = p / G, g = p - b * G;
    const float* yb = y + b * Tl * ldy + g * Cg;
    if constexpr (kJax) {
      // E[x] and E[x^2] of x and x * x rounded to fp16, summed in fp32
      float s = 0.f, s2 = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float v = yb[(i / Cg) * ldy + i % Cg];
        s += roundw<W>(v);
        s2 += roundw<W>(v * v);
      }
      const float mu = ldp::warp_sum(s) / n;
      const float e2 = ldp::warp_sum(s2) / n;
      if (lane == 0) {
        stats[2 * p] = mu;
        stats[2 * p + 1] = e2 - mu * mu;   // the variance, for now
      }
    } else {
      float s = 0.f;
      for (int i = lane; i < n; i += 32) s += yb[(i / Cg) * ldy + i % Cg];
      const float mu = ldp::warp_sum(s) / n;
      float sq = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float d = yb[(i / Cg) * ldy + i % Cg] - mu;
        sq = fmaf(d, d, sq);
      }
      const float var = ldp::warp_sum(sq) / n;
      if (lane == 0) {
        stats[2 * p] = mu;
        stats[2 * p + 1] = rsqrtf(var + kGnEps);
      }
    }
  }
  __syncthreads();
  if constexpr (kJax) {
    // JAX broadcasts the statistics back to the channels through 0/1
    // matmuls, so a non-finite mean (variance) of one group makes every
    // other group's of the sample NaN (0 x inf); at most 4 (sample, group)
    // pairs a thread (the wrapper holds nb * G to 4 blocks of threads)
    float mu[4], rs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      if (p < nb * G) {
        const int b0 = p / G * G;
        bool bad_mu = false, bad_var = false;
        for (int q = b0; q < b0 + G; ++q)
          if (q != p) {
            bad_mu |= !isfinite(stats[2 * q]);
            bad_var |= !isfinite(stats[2 * q + 1]);
          }
        mu[k] = bad_mu ? __int_as_float(0x7fc00000) : stats[2 * p];
        const float var =
            bad_var ? __int_as_float(0x7fc00000) : stats[2 * p + 1];
        rs[k] = rsqrtf(var + kGnEps);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      if (p < nb * G) {
        stats[2 * p] = mu[k];
        stats[2 * p + 1] = rs[k];
      }
    }
    __syncthreads();
  }
  // fp16: the JAX kernel rounds FiLM's scale and bias to its dtype where it
  // broadcasts them with a matmul (a width not a multiple of 128, Tl > 1)
  const bool round_film = kJax && (C % 128) != 0 && Tl > 1;
  const int Cp = pad32(C);
#pragma unroll 4
  for (int i = threadIdx.x; i < nb * Tl * Cp; i += blockDim.x) {
    const int r = i / Cp, c = i - r * Cp;
    float v = 0.f;
    if (c < C) {
      const int b = r / Tl, p = b * G + c / Cg;
      v = (y[r * ldy + c] - stats[2 * p]) * stats[2 * p + 1] * tof(gs[c])
          + tof(gb[c]);
      v = ldp::mishf(v);
      if (film != nullptr) {
        const float* fg = film->g
            + static_cast<size_t>(min(film->b0 + b, film->B - 1)) * film->ld;
        if constexpr (kJax) {
          float sc = __ldg(film->t + c) + __ldg(fg + c);
          float bi = __ldg(film->t + C + c) + __ldg(fg + C + c);
          if (round_film) {
            sc = roundw<W>(sc);
            bi = roundw<W>(bi);
          }
          v = sc * v + bi;
        } else {
          v = (__ldg(film->t + c) + __ldg(fg + c)) * v
              + (__ldg(film->t + C + c) + __ldg(fg + C + c));
        }
      }
      if (res != nullptr) v += res[r * ldr + c];
      if (out32 != nullptr) out32[r * ldy + c] = v;
    }
    if (outb != nullptr) outb[r * ldob + c] = fromf<W>(v);
    if constexpr (kJax) {
      if (outlo != nullptr) {
        const float hi = roundw<W>(v);
        outlo[r * ldob + c] = fromf<W>(isfinite(hi) ? v - hi : 0.f);
      }
    }
  }
  __syncthreads();
}

struct Dims {
  int B, T, D, Dc, dsed, K, G, nb, max32, maxb, skip_total, n_ops, n_steps,
      film_total, film_ld, main_stages, time_tile_base, time_stages,
      cond_tile_base, cond_stages, vec_base, v_time0, v_time1, v_film_t,
      smem_main, smem_pro, stages_main, stages_pro, tile_n, cond_rows,
      wide, scratch_bytes, cond_chunk, skip32_total;
};
constexpr int kNDims = 34;

template <typename W>
__device__ __forceinline__ Gemm<W> dense(const W* A, int K, int rows, int N,
                                         const W* bias) {
  Gemm<W> g{};
  g.A = A; g.lda = ldb<W>(K); g.cin_pad = pad32(K); g.taps = 1; g.mode = kSame;
  g.Tin = 1; g.Tout = 1; g.rows = rows; g.N = N; g.bias = bias;
  return g;
}

// What does not depend on the sample, or not on the step. Blocks [0, S):
// step s's time embedding -> time MLP -> Mish -> the time half of every
// FiLM projection (+ bias) into film_t[s]. Blocks from S on: the condition
// half for kCondRows samples each into film_g. The condition is walked in
// chunks of cond_chunk channels (the stream holds the half's weights chunk
// by chunk), mish(condition) of one chunk in the operand buffer at a time
// and its product added to film_g, so a condition of any width fits.
template <typename W>
__global__ void __launch_bounds__(kThreads, 1) unet1d_prologue_kernel(
    const float* __restrict__ gcond, const int* __restrict__ ts,
    const W* __restrict__ Wp, float* __restrict__ film_t,
    float* __restrict__ film_g, Dims d) {
  constexpr int kMt = kCondRows / 16;
  extern __shared__ uint4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int hb = max(16 * ldb<W>(4 * d.dsed), d.cond_rows * ldb<W>(d.cond_chunk));
  W* Pb = reinterpret_cast<W*>(sm + d.stages_pro * Sizes<W>::kStageBytes);
  W* Qb = Pb + hb;
  W* zero = Qb + hb;
  if (tid < 16) zero[tid] = fromf<W>(0.f);
  const uint32_t zero_addr = ldp::smem_u32(zero);
  const W* V = Wp + d.vec_base;
  Tiles<W> tiles;

  if (static_cast<int>(blockIdx.x) < d.n_steps) {
    const int step = blockIdx.x;
    tiles.start(Wp + static_cast<size_t>(d.time_tile_base) * kTileElems, sm,
                d.stages_pro, d.time_stages, d.time_stages);
    const float t = static_cast<float>(ts[step]);
    const int half = d.dsed / 2;
    for (int i = tid; i < pad32(d.dsed); i += NT) {
      float v = 0.f;
      if (i < d.dsed) {
        const int k = i < half ? i : i - half;
        const float ang = t * expf(-logf(10000.f) * k / (half - 1));
        v = i < half ? sinf(ang) : cosf(ang);
      }
      Pb[i] = fromf<W>(v);
    }
    __syncthreads();
    Gemm<W> g = dense<W>(Pb, d.dsed, 1, 4 * d.dsed, V + d.v_time0);
    g.mish = true; g.outb = Qb; g.ldob = ldb<W>(4 * d.dsed);
    g.nb_cols = pad32(4 * d.dsed);
    gemm<kMt>(g, tiles, zero_addr);
    __syncthreads();
    g = dense<W>(Qb, 4 * d.dsed, 1, d.dsed, V + d.v_time1);
    g.mish = true; g.outb = Pb; g.ldob = ldb<W>(d.dsed);
    g.nb_cols = pad32(d.dsed);
    gemm<kMt>(g, tiles, zero_addr);
    __syncthreads();
    g = dense<W>(Pb, d.dsed, 1, d.film_total, V + d.v_film_t);
    g.out32 = film_t + static_cast<size_t>(step) * d.film_ld;
    g.ld32 = d.film_ld;
    gemm<kMt>(g, tiles, zero_addr);
  } else {
    const int s0 = (blockIdx.x - d.n_steps) * d.cond_rows;
    const int rows = min(d.cond_rows, d.B - s0);
    tiles.start(Wp + static_cast<size_t>(d.cond_tile_base) * kTileElems, sm,
                d.stages_pro, d.cond_stages, d.cond_stages);
    for (int c0 = 0; c0 < d.Dc; c0 += d.cond_chunk) {
      const int cw = min(d.cond_chunk, d.Dc - c0);
      const int ld = ldb<W>(cw), Cp = pad32(cw);
      __syncthreads();   // the chunk before is no longer read
      for (int i = tid; i < d.cond_rows * Cp; i += NT) {
        const int r = i / Cp, c = i - r * Cp;
        float v = 0.f;
        if (r < rows && c < cw)
          v = ldp::mishf(gcond[static_cast<size_t>(s0 + r) * d.Dc + c0 + c]);
        Pb[r * ld + c] = fromf<W>(v);
      }
      __syncthreads();
      Gemm<W> g = dense<W>(Pb, cw, rows, d.film_total, nullptr);
      g.out32 = film_g + static_cast<size_t>(s0) * d.film_ld;
      g.ld32 = d.film_ld;
      g.accum = c0 > 0;
      gemm<kMt>(g, tiles, zero_addr);
    }
  }
  tiles.ring.drain();
}

// kWide: the fp32 buffers and the skips (with d.wide 2: also the operand
// buffers, which the bf16 GEMM stages through shared memory) in this
// block's slice of the global scratch (a template parameter, so the
// ordinary instances keep their registers). The fp32 skips an up block
// without a projection reads back (d.skip32_total floats) follow the bf16
// skips wherever those are. kGroups: the GEMMs walk rows past kMt row
// tiles in groups.
template <typename W, int kMt, bool kWide, bool kGroups>
__global__ void __launch_bounds__(kThreads, 1) unet1d_sampler_kernel(
    const float* __restrict__ x_init, const float* __restrict__ coefs,
    const float* __restrict__ noise, const W* __restrict__ Wp,
    const int* __restrict__ prog, const float* __restrict__ film_t,
    const float* __restrict__ film_g, char* scratch,
    float* __restrict__ out, Dims d, float clip) {
  constexpr bool kF32 = std::is_same<W, float>::value;
  constexpr bool kF16 = std::is_same<W, f16>::value;
  extern __shared__ uint4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int nb = d.nb, T = d.T, D = d.D, K = d.K, G = d.G;
  // a GEMM's weight tiles in global memory, for its row groups before the
  // last and fp16's second pass of the final conv (the main stream starts
  // the packed buffer); null in the instances that read none
  auto wtiles = [&](int tile) -> const W* {
    if constexpr (kGroups || kF16)
      return Wp + static_cast<size_t>(tile) * kTileElems;
    else
      return nullptr;
  };
  const int b0 = blockIdx.x * nb;
  const int n_valid = min(nb, d.B - b0);
  const int ring_bytes = d.stages_main * Sizes<W>::kStageBytes;

  // shared: [ring | X32 Y32 | xcur | stats | Xb Yb | skips | zero]; in wide
  // mode X32, Y32 and the skips sit in this block's slice of the scratch,
  // and Xb and Yb too where d.wide is 2 (bf16: a staging window for them
  // in the shared memory after zero)
  float* X32;
  float* Y32;
  float* xcur;
  W* Xb;
  W* Yb;
  W* skipb;
  W* zero;
  W* stageb = nullptr;
  int stage_cap = 0;
  if constexpr (kWide) {
    X32 = reinterpret_cast<float*>(
        scratch + static_cast<size_t>(blockIdx.x) * d.scratch_bytes);
    Y32 = X32 + d.max32;
    xcur = reinterpret_cast<float*>(sm + ring_bytes);
    const int n_floats = (nb * T * D + 2 * nb * G + 3) & ~3;
    if (d.wide == 2) {   // the operand buffers too
      Xb = reinterpret_cast<W*>(Y32 + d.max32);
      Yb = Xb + d.maxb;
      skipb = Yb + d.maxb;
      zero = reinterpret_cast<W*>(xcur + n_floats);
      if constexpr (!kF32) {   // the staging window: the rest of the block's
        stageb = zero + 16;    // shared memory
        stage_cap = (d.smem_main - ring_bytes - 4 * n_floats) / 2 - 16;
      }
    } else {
      skipb = reinterpret_cast<W*>(Y32 + d.max32);
      Xb = reinterpret_cast<W*>(xcur + n_floats);
      Yb = Xb + d.maxb;
      zero = Yb + d.maxb;
    }
  } else {
    X32 = reinterpret_cast<float*>(sm + ring_bytes);
    Y32 = X32 + d.max32;
    xcur = Y32 + d.max32;                       // nb*T x D
    const int n_floats = (2 * d.max32 + nb * T * D + 2 * nb * G + 3) & ~3;
    Xb = reinterpret_cast<W*>(X32 + n_floats);
    Yb = Xb + d.maxb;
    skipb = Yb + d.maxb;
    zero = reinterpret_cast<W*>(
        reinterpret_cast<float*>(skipb + d.skip_total) + d.skip32_total);
  }
  float* skip32 = reinterpret_cast<float*>(skipb + d.skip_total);
  float* stats = xcur + nb * T * D;             // nb x G x 2
  if (tid < 16) zero[tid] = fromf<W>(0.f);
  const uint32_t zero_addr = ldp::smem_u32(zero);
  const W* V = Wp + d.vec_base;

  std::conditional_t<kF32, SliceTiles<kWide>, Tiles<W>> tiles;
  // fp32 in wide mode: the k-split GEMM, its partial sums at the end of
  // this block's slice of the scratch
  float* red = nullptr;
  if constexpr (kF32 && kWide)
    red = reinterpret_cast<float*>(
        scratch + static_cast<size_t>(blockIdx.x + 1) * d.scratch_bytes) -
        kRedFloats;
  auto run_gemm = [&](Gemm<W> g) {
    if constexpr (kF32 && kWide) {
      gemm_ksplit<kMt, kGroups>(g, tiles, red);
    } else {
      g.stage = stageb;
      g.stage_cap = stage_cap;
      gemm<kMt, kGroups>(g, tiles, zero_addr);
    }
  };
  tiles.start(Wp, sm, d.stages_main, d.main_stages, d.main_stages * d.n_steps);

  for (int i = tid; i < nb * T * D; i += NT) {
    const int b = i / (T * D);
    xcur[i] = b < n_valid ? x_init[static_cast<size_t>(b0) * T * D + i] : 0.f;
  }
  __syncthreads();

  for (int step = 0; step < d.n_steps; ++step) {
    {
      const int Cp = pad32(D), lb = ldb<W>(D), lf = ld32(D);
      for (int i = tid; i < nb * T * Cp; i += NT) {
        const int r = i / Cp, c = i - r * Cp;
        const float v = c < D ? xcur[r * D + c] : 0.f;
        if (c < D) X32[r * lf + c] = v;
        Xb[r * lb + c] = fromf<W>(v);
      }
    }
    __syncthreads();

    for (int op = 0; op < d.n_ops; ++op) {
      const int* rec = prog + op * kRec;
      const int kind = rec[0];
      if (kind == kFilm) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const W* v1 = V + rec[8];
        const W* v2 = V + rec[9];
        const int rows = nb * Tl, np = padn(ch);
        Gemm<W> g{};
        g.A = Xb; g.lda = ldb<W>(cin); g.cin_pad = pad32(cin); g.taps = K;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = rows; g.N = ch;
        g.bias = v1; g.out32 = Y32; g.ld32 = ld32(ch);
        g.wtiles = wtiles(rec[4]);
        run_gemm(g);
        __syncthreads();
        Film film{film_t + static_cast<size_t>(step) * d.film_ld + rec[6],
                  film_g + rec[6], d.film_ld, b0, d.B};
        group_norm_mish<W>(Y32, ld32(ch), ch, Tl, nb, G, v1 + np,
                           v1 + np + ch, stats, &film, nullptr, 0, nullptr,
                           Yb, ldb<W>(ch));
        g.A = Yb; g.lda = ldb<W>(ch); g.cin_pad = pad32(ch); g.bias = v2;
        g.wtiles = wtiles(rec[5]);
        run_gemm(g);
        __syncthreads();
        if (rec[7] >= 0) {
          group_norm_mish<W>(Y32, ld32(ch), ch, Tl, nb, G, v2 + np,
                             v2 + np + ch, stats, nullptr, nullptr, 0, Y32,
                             nullptr, 0);
          Gemm<W> p{};
          p.A = Xb; p.lda = ldb<W>(cin); p.cin_pad = pad32(cin); p.taps = 1;
          p.mode = kSame; p.Tin = Tl; p.Tout = Tl; p.rows = rows; p.N = ch;
          p.bias = V + rec[10]; p.out32 = Y32; p.ld32 = ld32(ch);
          p.accum = true; p.outb = Yb; p.ldob = ldb<W>(ch);
          p.nb_cols = pad32(ch); p.wtiles = wtiles(rec[7]);
          run_gemm(p);
          __syncthreads();
        } else {
          group_norm_mish<W>(Y32, ld32(ch), ch, Tl, nb, G, v2 + np,
                             v2 + np + ch, stats, nullptr, X32, ld32(cin),
                             Y32, Yb, ldb<W>(ch));
        }
        float* t32 = X32; X32 = Y32; Y32 = t32;
        W* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kSave) {
        const int n = nb * rec[3] * ldb<W>(rec[2]);
        for (int i = tid; i < n; i += NT) skipb[rec[1] + i] = Xb[i];
        if (rec[4]) {   // and the fp32 copy an up block's residual reads
          const int m = nb * rec[3] * ld32(rec[2]);
          for (int i = tid; i < m; i += NT) skip32[rec[5] + i] = X32[i];
        }
        __syncthreads();
      } else if (kind == kConcat) {
        const int C1 = rec[2], C2 = rec[3], Cp = pad32(C1 + C2);
        const int l1 = ldb<W>(C1), l2 = ldb<W>(C2), lo = ldb<W>(C1 + C2);
        const W* sk = skipb + rec[1];
        for (int i = tid; i < nb * rec[4] * Cp; i += NT) {
          const int r = i / Cp, c = i - r * Cp;
          Yb[r * lo + c] = c < C1 ? Xb[r * l1 + c]
                           : c < C1 + C2 ? sk[r * l2 + c - C1]
                                         : fromf<W>(0.f);
        }
        if (rec[5]) {   // [h | skip] in fp32 too: the block's residual
          const float* s32 = skip32 + rec[6];
          const int C = C1 + C2, f1 = ld32(C1), f2 = ld32(C2), fo = ld32(C);
          for (int i = tid; i < nb * rec[4] * C; i += NT) {
            const int r = i / C, c = i - r * C;
            Y32[r * fo + c] = c < C1 ? X32[r * f1 + c] : s32[r * f2 + c - C1];
          }
        }
        __syncthreads();
        W* tb = Xb; Xb = Yb; Yb = tb;
        if (rec[5]) {
          float* t32 = X32; X32 = Y32; Y32 = t32;
        }
      } else if (kind == kDown || kind == kUp) {
        const int ch = rec[1], Tin = rec[2];
        const int Tout = kind == kDown ? Tin / 2 : 2 * Tin;
        Gemm<W> g{};
        g.A = Xb; g.lda = ldb<W>(ch); g.cin_pad = pad32(ch);
        g.taps = kind == kDown ? 3 : 4;
        g.mode = kind == kDown ? kStride2 : kTranspose;
        g.Tin = Tin; g.Tout = Tout; g.rows = nb * Tout; g.N = ch;
        g.bias = V + rec[4]; g.out32 = Y32; g.ld32 = ld32(ch);
        g.outb = Yb; g.ldob = ldb<W>(ch); g.nb_cols = pad32(ch);
        g.wtiles = wtiles(rec[3]);
        // fp16: the JAX kernel's downsample rounds its output where the
        // width is not a multiple of 128 (a selection matmul)
        g.round32 = kF16 && kind == kDown && ch % 128 != 0;
        run_gemm(g);
        __syncthreads();
        float* t32 = X32; X32 = Y32; Y32 = t32;
        W* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kFinalBlock) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const W* v1 = V + rec[5];
        const int np = padn(ch);
        Gemm<W> g{};
        g.A = Xb; g.lda = ldb<W>(cin); g.cin_pad = pad32(cin); g.taps = K;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = nb * Tl; g.N = ch;
        g.bias = v1; g.out32 = Y32; g.ld32 = ld32(ch);
        g.wtiles = wtiles(rec[4]);
        run_gemm(g);
        __syncthreads();
        // fp16: the lo half of the result into Xb (this GEMM's input, read)
        group_norm_mish<W>(Y32, ld32(ch), ch, Tl, nb, G, v1 + np,
                           v1 + np + ch, stats, nullptr, nullptr, 0, nullptr,
                           Yb, ldb<W>(ch), kF16 ? Xb : nullptr);
        W* tb = Xb; Xb = Yb; Yb = tb;
      } else {  // kFinalConv: eps into Y32
        const int cin = rec[1], Dout = rec[2], Tl = rec[3];
        Gemm<W> g{};
        g.A = Xb; g.lda = ldb<W>(cin); g.cin_pad = pad32(cin); g.taps = 1;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = nb * Tl; g.N = Dout;
        g.bias = V + rec[5]; g.out32 = Y32; g.ld32 = ld32(Dout);
        g.wtiles = wtiles(rec[4]);
        run_gemm(g);
        if constexpr (kF16) {
          // the JAX kernel's final conv takes the fp32 activations: add the
          // lo half's products (the same weights, from global memory)
          __syncthreads();
          g.A = Yb; g.bias = nullptr; g.accum = true; g.global_only = true;
          run_gemm(g);
        }
        __syncthreads();
      }
    }
    tiles.align();

    const float k0 = coefs[step * 6 + 0], k1 = coefs[step * 6 + 1];
    const float k2 = coefs[step * 6 + 2], k3 = coefs[step * 6 + 3];
    const float k4 = coefs[step * 6 + 4], kx = coefs[step * 6 + 5];
    const int lf = ld32(D);
    // this step's noise for the block's samples: (n_steps, B, T, D), the
    // rows of sample b0 on; the padding samples past n_valid read none
    const float* nz = noise == nullptr ? nullptr
        : noise + (static_cast<size_t>(step) * d.B + b0) * T * D;
    for (int i = tid; i < nb * T * D; i += NT) {
      const int r = i / D, c = i - r * D;
      const float x = xcur[i];
      // x0 = clip(k0 (kx x - k1 y)): kx = 1 for eps, 0 for sample (x0
      // prediction), sqrt(abar) for v; 1 * x is x, so eps runs as before
      float x0 = k0 * fmaf(-k1, Y32[r * lf + c], __fmul_rn(kx, x));
      // fp16 keeps a NaN as the JAX kernel's clip does (an overflow of its
      // GroupNorm statistics shows)
      if (!kF16 || x0 == x0) x0 = fminf(fmaxf(x0, -clip), clip);
      float xn = k2 * x0 + k3 * x;
      if (nz != nullptr && i < n_valid * T * D) xn += k4 * __ldg(nz + i);
      xcur[i] = xn;
    }
    __syncthreads();
  }
  if constexpr (kF32)
    tiles.finish();
  else
    tiles.ring.drain();

  for (int i = tid; i < n_valid * T * D; i += NT)
    out[static_cast<size_t>(b0) * T * D + i] = xcur[i];
}

template <typename W, int kMt, bool kWide, bool kGroups = false>
int launch_main(const float* x_init, const float* coefs, const float* noise,
                const W* Wp, const int* prog, const float* film_t,
                const float* film_g, char* scratch, float* out, const Dims& d,
                float clip, cudaStream_t st) {
  auto kernel = unet1d_sampler_kernel<W, kMt, kWide, kGroups>;
  cudaError_t err = ldp::allow_smem(kernel, d.smem_main);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (d.B + d.nb - 1) / d.nb;
  kernel<<<grid, kThreads, d.smem_main, st>>>(x_init, coefs, noise, Wp, prog,
                                              film_t, film_g, scratch, out, d,
                                              clip);
  return static_cast<int>(cudaGetLastError());
}

// The host side of one call: checks `dims`, launches the prologue and then
// the main kernel with the instance the tile's rows need. Returns a
// cudaError_t.
template <typename W>
int unet1d_sample(const float* gcond, const float* x_init, const int* ts,
                  const float* coefs, const float* noise, const void* w,
                  const int* prog, float* film_t, float* film_g, void* scratch,
                  float* out, const int* dims, int n_dims, float clip,
                  void* stream) {
  if (n_dims != kNDims) return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  int* fields = reinterpret_cast<int*>(&d);
  for (int i = 0; i < kNDims; ++i) fields[i] = dims[i];
  constexpr bool kF32 = std::is_same<W, float>::value;
  // rows past an instance's are walked in groups; fp16's GroupNorm holds
  // at most 4 (sample, group) pairs a thread
  if (d.nb < 1 || d.T < 1 || d.tile_n != kGroupN ||
      (std::is_same<W, f16>::value && d.nb * d.G > 4 * kThreads) ||
      d.stages_main < 2 || d.stages_main > 8 || d.stages_pro < 2 ||
      d.stages_pro > 8 || d.cond_rows != kCondRows || d.cond_chunk < 32 ||
      d.cond_chunk % 32 || d.wide < 0 || d.wide > 2 || d.skip32_total < 0 ||
      (d.wide && (scratch == nullptr || d.scratch_bytes % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto sc = static_cast<char*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  auto Wp = static_cast<const W*>(w);
  cudaError_t err = ldp::allow_smem(unet1d_prologue_kernel<W>, d.smem_pro);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pro_grid = d.n_steps + (d.B + d.cond_rows - 1) / d.cond_rows;
  unet1d_prologue_kernel<W><<<pro_grid, kThreads, d.smem_pro, st>>>(
      gcond, ts, Wp, film_t, film_g, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // accumulators sized to the rows the tile holds: 2, 4, 8 or (bf16,
  // fp16) 16 m16 tiles, more rows in groups of the largest; the fp32 wide
  // mode (its k-split GEMM) holds 2
  const int mt = (d.nb * d.T + 15) / 16;
  if (d.wide) {
    if constexpr (kF32) {
      if (mt > 2)
        return launch_main<W, 2, true, true>(x_init, coefs, noise, Wp, prog,
                                             film_t, film_g, sc, out, d, clip,
                                             st);
    }
    if (mt <= 2)
      return launch_main<W, 2, true>(x_init, coefs, noise, Wp, prog, film_t,
                                     film_g, sc, out, d, clip, st);
    if constexpr (!kF32) {
      if (mt <= 4)
        return launch_main<W, 4, true>(x_init, coefs, noise, Wp, prog,
                                       film_t, film_g, sc, out, d, clip, st);
      if (mt <= 8)
        return launch_main<W, 8, true>(x_init, coefs, noise, Wp, prog,
                                       film_t, film_g, sc, out, d, clip, st);
      if (mt > 16)
        return launch_main<W, 16, true, true>(x_init, coefs, noise, Wp, prog,
                                              film_t, film_g, sc, out, d,
                                              clip, st);
      return launch_main<W, 16, true>(x_init, coefs, noise, Wp, prog, film_t,
                                      film_g, sc, out, d, clip, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mt <= 2)
    return launch_main<W, 2, false>(x_init, coefs, noise, Wp, prog, film_t,
                                    film_g, sc, out, d, clip, st);
  if (mt <= 4)
    return launch_main<W, 4, false>(x_init, coefs, noise, Wp, prog, film_t,
                                    film_g, sc, out, d, clip, st);
  if (mt <= 8)
    return launch_main<W, 8, false>(x_init, coefs, noise, Wp, prog, film_t,
                                    film_g, sc, out, d, clip, st);
  if constexpr (kF32) {
    return launch_main<W, 8, false, true>(x_init, coefs, noise, Wp, prog,
                                          film_t, film_g, sc, out, d, clip,
                                          st);
  } else {
    if (mt <= 16)
      return launch_main<W, 16, false>(x_init, coefs, noise, Wp, prog,
                                       film_t, film_g, sc, out, d, clip, st);
    return launch_main<W, 16, false, true>(x_init, coefs, noise, Wp, prog,
                                           film_t, film_g, sc, out, d, clip,
                                           st);
  }
}

}  // namespace
