// Fused reverse process of ConditionalUnet1D on the tensor cores, strided
// DDIM (eta = 0) or ancestral DDPM with per-step noise: bf16 weights and
// bf16 activation operands, fp32 accumulation, fp32 GroupNorm / Mish / FiLM
// / step update.
//
// Replaces the TPU kernel latent_diffusion_planning_tpu/ops/pallas/
// diffusion_unet1d.py (fused_unet1d_ddim_sample -> _kernel), both its
// VMEM-resident and its streamed-weights mode: one call runs every step of
// the reverse process for a tile of `nb` samples. Per step:
//   sinusoidal t-embedding -> Dense(4d) -> Mish -> Dense(d); concat global
//   cond; Mish. Then the U-Net: FiLM residual blocks (conv k SAME -> GN ->
//   Mish -> FiLM -> conv -> GN -> Mish, + 1x1 projection when Cin != Cout),
//   stride-2 k3 downsample (Flax SAME pads (0, 1)), ConvTranspose k4 s2
//   upsample (x[t] w[j] -> y[2t+2-j]), skip concat, final conv block, 1x1
//   conv to y (eps, x0 or v); x0 = clip(c0 (cx x - c1 y)),
//   x = c2 x0 + c3 x + c4 noise[step] (noise null for DDIM, whose c4 is 0).
//   The JAX kernel is DDIM only; DDPM-100 is what the JAX package's default
//   agent configurations sample with (through its XLA scan).
//
// What bounds it on H100: by its operations the bf16 tensor-core rate, by
// its shape the weight stream. A block holds few GEMM rows (nb x T, at most
// 128, and T halves with every level), and every block reads every conv
// weight once per step from L2 (from HBM when the net outgrows L2): 9.8 GB a
// call at the bench widths. This design hides that stream behind the block's
// own work (measured: switching the copies off saves a tenth); what it has not
// removed is the latency of that work, short dependent chains (ldmatrix ->
// mma -> add) and the fp32 GroupNorm/Mish passes between them, which is why
// a block runs 16 warps: at 8 every phase was latency-bound and the kernel
// took 10.3 ms where it now takes about 7 (bench widths, 1024 samples). The
// design:
//  * Every conv is an implicit GEMM, M = nb*Tout rows, N = Cout, K = taps x
//    Cin, on mma.sync m16n8k16 (wgmma's 64-row tile would idle at the deep
//    levels, where M is 16 or 32 and most of the weights are). Warp w of 16
//    owns columns [8w, 8w+8) of a 128-column group for all rows; a tap is a row
//    offset, applied to the per-lane ldmatrix row address, and a tap outside
//    its sample reads a zero row. Stride-2, transpose and 1x1 convs and the
//    prologue's dense layers run through the same routine. The tensor core
//    truncates when it adds into its accumulator; a few tiles' products are
//    summed from zero there and added to the fp32 sum on the CUDA cores,
//    which round to nearest (that took the median error against the
//    rounding twin after one step from 3e-3 to 2e-7).
//  * Weights arrive pre-tiled (ops/kernels/diffusion_unet1d.py, tile_matrix):
//    8 KB tiles of 32 K-rows x 128 columns in B-fragment order, in exactly
//    the order they are consumed, so the kernel never seeks: a ring of
//    24 KB cp.async stages (stream.cuh), as deep as shared memory allows,
//    runs ahead of the GEMMs across op and step boundaries, and a lane fetches both B fragments of a tile with
//    one conflict-free 16-byte load.
//  * Activations are rounded to bf16 once, when written, into operand
//    buffers beside the fp32 ones GroupNorm and the residual need; skips
//    are kept as bf16 operands only. All of it stays in shared memory for
//    all steps; only the final sample is written back.
//  * The time MLP and the FiLM projections leave the per-step stream (28%
//    of it at the bench widths): FiLM's input is [mish(temb(step)) |
//    mish(gcond(sample))] and the projection is linear, so a prologue kernel
//    in the same call computes the time half once per step and the
//    condition half once per sample into scratch, and the main kernel adds
//    the two.
//
// The net arrives as a program of 12-int records (build_program) over the
// packed buffer, so any down_dims / n_groups / embedding width runs through
// the same kernel.
//
// Wide mode (d.wide): a net that does not downsample keeps every level at
// the full length, so at 16 rows LDP-hier's default planner [256,512,1024]
// needs 16 x 1032 floats for each of the two fp32 buffers, 2 x 16 x 2056
// bf16 for the operand buffers of its 2048-wide concat and 16 x 1552 bf16
// of skips: 362 KB, more than a block's 227 KB. The operand buffers must
// stay in shared memory (ldmatrix reads nothing else), so wide mode keeps
// the fp32 buffers and the skips in a per-block slice of a global scratch
// instead (d.scratch_bytes a block, 182 KB there) and the rest of the
// program is unchanged: the GEMM epilogue, GroupNorm / Mish, the residual,
// SAVE and CONCAT read and write them through generic pointers, and
// __syncthreads orders global writes within the block as it does shared
// ones. The slice is written and read back by one block between two
// barriers, so it stays in L2 (a resident block's slice is 182 KB; 132 of
// them 24 MB); beside the 84 MB of weights the block streams a step it is
// small. The wrapper takes wide mode only where no tile fits shared memory
// whole, so every other net keeps its tiles, and for up to 32 rows a block
// (one kernel instance).
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "stream.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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
constexpr int kTileBytes = 2 * kTileElems;
constexpr int kStageTiles = 3;
constexpr int kChunk = 3;          // tiles a warp takes at a time
constexpr int kStageBytes = kStageTiles * kTileBytes;
constexpr int kMtCap = 8;          // most m16 row tiles a warp accumulates
constexpr int kCondRowsMax = 64;   // most samples per prologue cond block
constexpr float kGnEps = 1e-6f;

enum ConvMode { kSame = 0, kStride2 = 1, kTranspose = 2 };

__device__ __forceinline__ float bf(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ int pad32(int c) { return (c + 31) & ~31; }
__device__ __forceinline__ int padn(int c) {
  return (c + kGroupN - 1) / kGroupN * kGroupN;
}
__device__ __forceinline__ int ldb(int c) { return pad32(c) + 8; }
__device__ __forceinline__ int ld32(int c) { return c + 8; }

// The packed stream, tile by tile, through the ring.
struct Tiles {
  ldp::WeightRing<kStageBytes> ring;
  const char* stage;
  int pos;

  __device__ void start(const bf16* stream, void* smem, int stages, int cycle,
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
    const char* p = stage + pos * kTileBytes;
    pos += n;
    return p;
  }
  // Skip the zero tiles that pad the stream to whole stages.
  __device__ void align() { pos = kStageTiles; }
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

struct Gemm {
  const bf16* A;    // operand rows in shared memory
  int lda;          // its row stride, elements
  int cin_pad;      // channels per tap, padded to 32
  int taps, mode, Tin, Tout;
  int rows;         // nb * Tout
  int N;            // output columns
  const bf16* bias; // padn(N) values, or null
  float* out32;     // fp32 result (shared or global), or null
  int ld32;
  bool accum;       // add to what out32 holds
  bool mish;
  bf16* outb;       // bf16 copy of the result (operand of the next GEMM)
  int ldob;
  int nb_cols;      // columns of outb to write (zeros from N on)
};

// out[r][n] = bias[n] + sum_tap sum_c A[src(r, tap)][c] W[tap][c][n], the
// weights taken tile by tile from the stream. Every thread of the block
// takes part in every tile.
template <int kMtMax>
__device__ void gemm(const Gemm& g, Tiles& tiles, uint32_t zero_addr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int MT = (g.rows + 15) >> 4;
  const int n_groups = (g.N + kGroupN - 1) / kGroupN;
  const int kt_per_tap = g.cin_pad >> 5;
  const uint32_t a_base = ldp::smem_u32(g.A) + (lane >> 4) * 16;
  const int pad = g.taps >> 1;
  for (int ng = 0; ng < n_groups; ++ng) {
    const int col = ng * kGroupN + warp * 8 + 2 * tq;
    float acc[kMtMax][4];
    const float b0 = g.bias != nullptr ? bf(g.bias + col) : 0.f;
    const float b1 = g.bias != nullptr ? bf(g.bias + col + 1) : 0.f;
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
          const int sr = src_row(g.mode, mt * 16 + (lane & 15), g.rows, g.Tin,
                                 g.Tout, tap, pad);
          if (sr >= 0) {
            raddr[mt] = a_base + static_cast<uint32_t>(sr * g.lda) * 2;
            live |= 1u << mt;
          }
        }
      }
      // up to kChunk tiles at a time: all their loads are
      // started before the products that need them, and the products run in
      // two independent chains, so a warp with one row tile (the deep
      // levels) is not a single chain of dependent instructions
      for (int kt = 0; kt < kt_per_tap;) {
        const int n = min(min(tiles.avail(), kChunk), kt_per_tap - kt);
        const char* tile = tiles.take(n) + warp * 512 + lane * 16;
        uint4 bq[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < n)
            bq[j] = *reinterpret_cast<const uint4*>(tile + j * kTileBytes);
        const uint32_t k0 = kt * 64;
#pragma unroll
        for (int mt = 0; mt < kMtMax; ++mt) {
          if (mt < MT) {
            const bool on = (live >> mt) & 1;
            const uint32_t ad = raddr[mt] + (on ? k0 : 0u);
            uint32_t a[kChunk][2][4];
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              if (j < n) {
                ldp::ldmatrix_x4(a[j][0], ad + (on ? 64u * j : 0u));
                ldp::ldmatrix_x4(a[j][1], ad + (on ? 64u * j + 32u : 0u));
              }
            // the tensor core truncates when it adds into its accumulator;
            // sum these tiles' products from zero there and add the partial
            // sums on the CUDA cores, which round to nearest
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              if (j < n) {
                ldp::mma_bf16(p0, a[j][0], bq[j].x, bq[j].y);
                ldp::mma_bf16(p1, a[j][1], bq[j].z, bq[j].w);
              }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][e] += p0[e] + p1[e];
          }
        }
        kt += n;
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMtMax; ++mt) {
      if (mt < MT) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + gq + 8 * h;
          if (r < g.rows) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = col + e;
              float v = acc[mt][2 * h + e];
              if (c < g.N) {
                if (g.accum) v += g.out32[static_cast<size_t>(r) * g.ld32 + c];
                if (g.mish) v = ldp::mishf(v);
                if (g.out32 != nullptr)
                  g.out32[static_cast<size_t>(r) * g.ld32 + c] = v;
              } else {
                v = 0.f;
              }
              if (g.outb != nullptr && c < g.nb_cols)
                g.outb[r * g.ldob + c] = __float2bfloat16(v);
            }
          }
        }
      }
    }
  }
}

struct Film {
  const float* __restrict__ t;  // this step's time half (scale [c], bias [C+c])
  const float* __restrict__ g;  // per-sample condition half, row stride ld
  int ld, b0, B;
};

// GroupNorm(G, eps 1e-6) -> Mish over y (nb*Tl rows x C, stride ldy), then
// FiLM when given, then + res when given. Writes the fp32 result to out32
// (stride ldy; may be y itself) and its bf16 rounding, channels zero-padded
// to 32, to outb, each where given.
__device__ void group_norm_mish(const float* y, int ldy, int C, int Tl, int nb,
                                int G, const bf16* gs, const bf16* gb,
                                float* stats, const Film* film,
                                const float* res, int ldr, float* out32,
                                bf16* outb, int ldob) {
  const int Cg = C / G, n = Tl * Cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int p = warp; p < nb * G; p += n_warps) {
    const int b = p / G, g = p - b * G;
    const float* yb = y + b * Tl * ldy + g * Cg;
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
  __syncthreads();
  const int Cp = pad32(C);
#pragma unroll 4
  for (int i = threadIdx.x; i < nb * Tl * Cp; i += blockDim.x) {
    const int r = i / Cp, c = i - r * Cp;
    float v = 0.f;
    if (c < C) {
      const int b = r / Tl, p = b * G + c / Cg;
      v = (y[r * ldy + c] - stats[2 * p]) * stats[2 * p + 1] * bf(gs + c)
          + bf(gb + c);
      v = ldp::mishf(v);
      if (film != nullptr) {
        const float* fg = film->g
            + static_cast<size_t>(min(film->b0 + b, film->B - 1)) * film->ld;
        v = (__ldg(film->t + c) + __ldg(fg + c)) * v
            + (__ldg(film->t + C + c) + __ldg(fg + C + c));
      }
      if (res != nullptr) v += res[r * ldr + c];
      if (out32 != nullptr) out32[r * ldy + c] = v;
    }
    if (outb != nullptr) outb[r * ldob + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

struct Dims {
  int B, T, D, Dc, dsed, K, G, nb, max32, maxb, skip_total, n_ops, n_steps,
      film_total, film_ld, main_stages, time_tile_base, time_stages,
      cond_tile_base, cond_stages, vec_base, v_time0, v_time1, v_film_t,
      smem_main, smem_pro, stages_main, stages_pro, tile_n, cond_rows,
      wide, scratch_bytes;
};
constexpr int kNDims = 32;

__device__ __forceinline__ Gemm dense(const bf16* A, int K, int rows, int N,
                                      const bf16* bias) {
  Gemm g{};
  g.A = A; g.lda = ldb(K); g.cin_pad = pad32(K); g.taps = 1; g.mode = kSame;
  g.Tin = 1; g.Tout = 1; g.rows = rows; g.N = N; g.bias = bias;
  return g;
}

// What does not depend on the sample, or not on the step. Blocks [0, S):
// step s's time embedding -> time MLP -> Mish -> the time half of every
// FiLM projection (+ bias) into film_t[s]. Blocks from S on: the condition
// half for cond_rows samples each into film_g (64, or 32 or 16 where a
// wide condition's operand tile would not fit the shared memory).
__global__ void __launch_bounds__(kThreads, 1) unet1d_prologue_kernel(
    const float* __restrict__ gcond, const int* __restrict__ ts,
    const bf16* __restrict__ W, float* __restrict__ film_t,
    float* __restrict__ film_g, Dims d) {
  constexpr int kMt = kCondRowsMax / 16;
  extern __shared__ uint4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int hb = max(16 * ldb(4 * d.dsed), d.cond_rows * ldb(d.Dc));
  bf16* Pb = reinterpret_cast<bf16*>(sm + d.stages_pro * kStageBytes);
  bf16* Qb = Pb + hb;
  bf16* zero = Qb + hb;
  if (tid < 16) zero[tid] = __float2bfloat16(0.f);
  const uint32_t zero_addr = ldp::smem_u32(zero);
  const bf16* V = W + d.vec_base;
  Tiles tiles;

  if (static_cast<int>(blockIdx.x) < d.n_steps) {
    const int step = blockIdx.x;
    tiles.start(W + static_cast<size_t>(d.time_tile_base) * kTileElems, sm,
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
      Pb[i] = __float2bfloat16(v);
    }
    __syncthreads();
    Gemm g = dense(Pb, d.dsed, 1, 4 * d.dsed, V + d.v_time0);
    g.mish = true; g.outb = Qb; g.ldob = ldb(4 * d.dsed);
    g.nb_cols = pad32(4 * d.dsed);
    gemm<kMt>(g, tiles, zero_addr);
    __syncthreads();
    g = dense(Qb, 4 * d.dsed, 1, d.dsed, V + d.v_time1);
    g.mish = true; g.outb = Pb; g.ldob = ldb(d.dsed); g.nb_cols = pad32(d.dsed);
    gemm<kMt>(g, tiles, zero_addr);
    __syncthreads();
    g = dense(Pb, d.dsed, 1, d.film_total, V + d.v_film_t);
    g.out32 = film_t + static_cast<size_t>(step) * d.film_ld;
    g.ld32 = d.film_ld;
    gemm<kMt>(g, tiles, zero_addr);
  } else {
    const int s0 = (blockIdx.x - d.n_steps) * d.cond_rows;
    const int rows = min(d.cond_rows, d.B - s0);
    tiles.start(W + static_cast<size_t>(d.cond_tile_base) * kTileElems, sm,
                d.stages_pro, d.cond_stages, d.cond_stages);
    const int ld = ldb(d.Dc), Cp = pad32(d.Dc);
    for (int i = tid; i < d.cond_rows * Cp; i += NT) {
      const int r = i / Cp, c = i - r * Cp;
      float v = 0.f;
      if (r < rows && c < d.Dc)
        v = ldp::mishf(gcond[static_cast<size_t>(s0 + r) * d.Dc + c]);
      Pb[r * ld + c] = __float2bfloat16(v);
    }
    __syncthreads();
    Gemm g = dense(Pb, d.Dc, rows, d.film_total, nullptr);
    g.out32 = film_g + static_cast<size_t>(s0) * d.film_ld;
    g.ld32 = d.film_ld;
    gemm<kMt>(g, tiles, zero_addr);
  }
  tiles.ring.drain();
}

// kWide: the fp32 buffers and the skips in this block's slice of the
// global scratch (a template parameter, so the ordinary instances keep
// their registers; one instance, for up to 32 rows a block, keeps the
// build short)
template <int kMt, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) unet1d_sampler_kernel(
    const float* __restrict__ x_init, const float* __restrict__ coefs,
    const float* __restrict__ noise, const bf16* __restrict__ W,
    const int* __restrict__ prog, const float* __restrict__ film_t,
    const float* __restrict__ film_g, char* scratch,
    float* __restrict__ out, Dims d, float clip) {
  extern __shared__ uint4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int nb = d.nb, T = d.T, D = d.D, K = d.K, G = d.G;
  const int b0 = blockIdx.x * nb;
  const int n_valid = min(nb, d.B - b0);

  // shared: [ring | X32 Y32 | xcur | stats | Xb Yb | skips | zero]; in wide
  // mode X32, Y32 and the skips sit in this block's slice of the scratch
  float* X32;
  float* Y32;
  float* xcur;
  bf16* Xb;
  bf16* Yb;
  bf16* skipb;
  bf16* zero;
  if constexpr (kWide) {
    X32 = reinterpret_cast<float*>(
        scratch + static_cast<size_t>(blockIdx.x) * d.scratch_bytes);
    Y32 = X32 + d.max32;
    skipb = reinterpret_cast<bf16*>(Y32 + d.max32);
    xcur = reinterpret_cast<float*>(sm + d.stages_main * kStageBytes);
    const int n_floats = (nb * T * D + 2 * nb * G + 3) & ~3;
    Xb = reinterpret_cast<bf16*>(xcur + n_floats);
    Yb = Xb + d.maxb;
    zero = Yb + d.maxb;
  } else {
    X32 = reinterpret_cast<float*>(sm + d.stages_main * kStageBytes);
    Y32 = X32 + d.max32;
    xcur = Y32 + d.max32;                       // nb*T x D
    const int n_floats = (2 * d.max32 + nb * T * D + 2 * nb * G + 3) & ~3;
    Xb = reinterpret_cast<bf16*>(X32 + n_floats);
    Yb = Xb + d.maxb;
    skipb = Yb + d.maxb;
    zero = skipb + d.skip_total;
  }
  float* stats = xcur + nb * T * D;             // nb x G x 2
  if (tid < 16) zero[tid] = __float2bfloat16(0.f);
  const uint32_t zero_addr = ldp::smem_u32(zero);
  const bf16* V = W + d.vec_base;

  Tiles tiles;
  tiles.start(W, sm, d.stages_main, d.main_stages, d.main_stages * d.n_steps);

  for (int i = tid; i < nb * T * D; i += NT) {
    const int b = i / (T * D);
    xcur[i] = b < n_valid ? x_init[static_cast<size_t>(b0) * T * D + i] : 0.f;
  }
  __syncthreads();

  for (int step = 0; step < d.n_steps; ++step) {
    {
      const int Cp = pad32(D), lb = ldb(D), lf = ld32(D);
      for (int i = tid; i < nb * T * Cp; i += NT) {
        const int r = i / Cp, c = i - r * Cp;
        const float v = c < D ? xcur[r * D + c] : 0.f;
        if (c < D) X32[r * lf + c] = v;
        Xb[r * lb + c] = __float2bfloat16(v);
      }
    }
    __syncthreads();

    for (int op = 0; op < d.n_ops; ++op) {
      const int* rec = prog + op * kRec;
      const int kind = rec[0];
      if (kind == kFilm) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const bf16* v1 = V + rec[8];
        const bf16* v2 = V + rec[9];
        const int rows = nb * Tl, np = padn(ch);
        Gemm g{};
        g.A = Xb; g.lda = ldb(cin); g.cin_pad = pad32(cin); g.taps = K;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = rows; g.N = ch;
        g.bias = v1; g.out32 = Y32; g.ld32 = ld32(ch);
        gemm<kMt>(g, tiles, zero_addr);
        __syncthreads();
        Film film{film_t + static_cast<size_t>(step) * d.film_ld + rec[6],
                  film_g + rec[6], d.film_ld, b0, d.B};
        group_norm_mish(Y32, ld32(ch), ch, Tl, nb, G, v1 + np, v1 + np + ch,
                        stats, &film, nullptr, 0, nullptr, Yb, ldb(ch));
        g.A = Yb; g.lda = ldb(ch); g.cin_pad = pad32(ch); g.bias = v2;
        gemm<kMt>(g, tiles, zero_addr);
        __syncthreads();
        if (rec[7] >= 0) {
          group_norm_mish(Y32, ld32(ch), ch, Tl, nb, G, v2 + np, v2 + np + ch,
                          stats, nullptr, nullptr, 0, Y32, nullptr, 0);
          Gemm p{};
          p.A = Xb; p.lda = ldb(cin); p.cin_pad = pad32(cin); p.taps = 1;
          p.mode = kSame; p.Tin = Tl; p.Tout = Tl; p.rows = rows; p.N = ch;
          p.bias = V + rec[10]; p.out32 = Y32; p.ld32 = ld32(ch);
          p.accum = true; p.outb = Yb; p.ldob = ldb(ch); p.nb_cols = pad32(ch);
          gemm<kMt>(p, tiles, zero_addr);
          __syncthreads();
        } else {
          group_norm_mish(Y32, ld32(ch), ch, Tl, nb, G, v2 + np, v2 + np + ch,
                          stats, nullptr, X32, ld32(cin), Y32, Yb, ldb(ch));
        }
        float* t32 = X32; X32 = Y32; Y32 = t32;
        bf16* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kSave) {
        const int n = nb * rec[3] * ldb(rec[2]);
        for (int i = tid; i < n; i += NT) skipb[rec[1] + i] = Xb[i];
        __syncthreads();
      } else if (kind == kConcat) {
        const int C1 = rec[2], C2 = rec[3], Cp = pad32(C1 + C2);
        const int l1 = ldb(C1), l2 = ldb(C2), lo = ldb(C1 + C2);
        const bf16* sk = skipb + rec[1];
        for (int i = tid; i < nb * rec[4] * Cp; i += NT) {
          const int r = i / Cp, c = i - r * Cp;
          Yb[r * lo + c] = c < C1 ? Xb[r * l1 + c]
                           : c < C1 + C2 ? sk[r * l2 + c - C1]
                                         : __float2bfloat16(0.f);
        }
        __syncthreads();
        bf16* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kDown || kind == kUp) {
        const int ch = rec[1], Tin = rec[2];
        const int Tout = kind == kDown ? Tin / 2 : 2 * Tin;
        Gemm g{};
        g.A = Xb; g.lda = ldb(ch); g.cin_pad = pad32(ch);
        g.taps = kind == kDown ? 3 : 4;
        g.mode = kind == kDown ? kStride2 : kTranspose;
        g.Tin = Tin; g.Tout = Tout; g.rows = nb * Tout; g.N = ch;
        g.bias = V + rec[4]; g.out32 = Y32; g.ld32 = ld32(ch);
        g.outb = Yb; g.ldob = ldb(ch); g.nb_cols = pad32(ch);
        gemm<kMt>(g, tiles, zero_addr);
        __syncthreads();
        float* t32 = X32; X32 = Y32; Y32 = t32;
        bf16* tb = Xb; Xb = Yb; Yb = tb;
      } else if (kind == kFinalBlock) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const bf16* v1 = V + rec[5];
        const int np = padn(ch);
        Gemm g{};
        g.A = Xb; g.lda = ldb(cin); g.cin_pad = pad32(cin); g.taps = K;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = nb * Tl; g.N = ch;
        g.bias = v1; g.out32 = Y32; g.ld32 = ld32(ch);
        gemm<kMt>(g, tiles, zero_addr);
        __syncthreads();
        group_norm_mish(Y32, ld32(ch), ch, Tl, nb, G, v1 + np, v1 + np + ch,
                        stats, nullptr, nullptr, 0, nullptr, Yb, ldb(ch));
        bf16* tb = Xb; Xb = Yb; Yb = tb;
      } else {  // kFinalConv: eps into Y32
        const int cin = rec[1], Dout = rec[2], Tl = rec[3];
        Gemm g{};
        g.A = Xb; g.lda = ldb(cin); g.cin_pad = pad32(cin); g.taps = 1;
        g.mode = kSame; g.Tin = Tl; g.Tout = Tl; g.rows = nb * Tl; g.N = Dout;
        g.bias = V + rec[5]; g.out32 = Y32; g.ld32 = ld32(Dout);
        gemm<kMt>(g, tiles, zero_addr);
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
      const float x0 = fminf(
          fmaxf(k0 * fmaf(-k1, Y32[r * lf + c], __fmul_rn(kx, x)), -clip),
          clip);
      float xn = k2 * x0 + k3 * x;
      if (nz != nullptr && i < n_valid * T * D) xn += k4 * __ldg(nz + i);
      xcur[i] = xn;
    }
    __syncthreads();
  }
  tiles.ring.drain();

  for (int i = tid; i < n_valid * T * D; i += NT)
    out[static_cast<size_t>(b0) * T * D + i] = xcur[i];
}

template <int kMt, bool kWide>
int launch_main(const float* x_init, const float* coefs, const float* noise,
                const bf16* W, const int* prog, const float* film_t,
                const float* film_g, char* scratch, float* out, const Dims& d,
                float clip, cudaStream_t st) {
  auto kernel = unet1d_sampler_kernel<kMt, kWide>;
  cudaError_t err = ldp::allow_smem(kernel, d.smem_main);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (d.B + d.nb - 1) / d.nb;
  kernel<<<grid, kThreads, d.smem_main, st>>>(x_init, coefs, noise, W, prog,
                                              film_t, film_g, scratch, out, d,
                                              clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t. `dims` is kNDims host ints in the order of Dims
// (the Python wrapper computes them from the same layout). noise is
// (n_steps x B x T x D) fp32, or null for DDIM. film_t (n_steps x
// film_ld), film_g (B rounded up to cond_rows rows x film_ld) and, in wide
// mode, `scratch` (grid x scratch_bytes; null otherwise) are scratch.
extern "C" int ldp_unet1d_sampler(const float* gcond, const float* x_init,
                                  const int* ts, const float* coefs,
                                  const float* noise, const void* w,
                                  const int* prog, float* film_t,
                                  float* film_g, void* scratch, float* out,
                                  const int* dims, int n_dims, float clip,
                                  void* stream) {
  if (n_dims != kNDims) return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  int* fields = reinterpret_cast<int*>(&d);
  for (int i = 0; i < kNDims; ++i) fields[i] = dims[i];
  if (d.nb < 1 || d.nb * d.T > 16 * kMtCap || d.tile_n != kGroupN ||
      d.stages_main < 2 || d.stages_main > 8 || d.stages_pro < 2 ||
      d.stages_pro > 8 || d.cond_rows < 16 || d.cond_rows > kCondRowsMax ||
      d.cond_rows % 16 ||
      (d.wide && (scratch == nullptr || d.scratch_bytes % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto sc = static_cast<char*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  auto W = static_cast<const bf16*>(w);
  cudaError_t err = ldp::allow_smem(unet1d_prologue_kernel, d.smem_pro);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pro_grid = d.n_steps + (d.B + d.cond_rows - 1) / d.cond_rows;
  unet1d_prologue_kernel<<<pro_grid, kThreads, d.smem_pro, st>>>(
      gcond, ts, W, film_t, film_g, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // accumulators sized to the rows the tile holds: 2, 4 or 8 m16 tiles
  const int mt = (d.nb * d.T + 15) / 16;
  if (d.wide)
    return mt <= 2 ? launch_main<2, true>(x_init, coefs, noise, W, prog,
                                          film_t, film_g, sc, out, d, clip, st)
                   : static_cast<int>(cudaErrorInvalidValue);
  if (mt <= 2)
    return launch_main<2, false>(x_init, coefs, noise, W, prog, film_t,
                                 film_g, sc, out, d, clip, st);
  if (mt <= 4)
    return launch_main<4, false>(x_init, coefs, noise, W, prog, film_t,
                                 film_g, sc, out, d, clip, st);
  return launch_main<8, false>(x_init, coefs, noise, W, prog, film_t, film_g,
                               sc, out, d, clip, st);
}
