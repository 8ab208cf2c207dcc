// Fused reverse-diffusion sampler for the MLP IDM (MLPDiffusion): fp32
// results, the three large products of a residual block on the tensor cores
// as error-compensated (3x) TF32.
//
// Replaces the TPU kernel latent_diffusion_planning_tpu/ops/pallas/
// diffusion_mlp.py (fused_mlp_diffusion_sample -> _sampler_kernel): the
// whole DDPM/DDIM reverse process in one call. Per step and row:
//   Fourier features [cos, sin](2*pi*t*W) (learnable) or [cos, sin](t*f)
//   (fixed sinusoidal frequencies) -> cond MLP (any depth and widths;
//   relu, swish, mish or gelu (tanh form) between its layers) ->
//   Dense([x, s, cond]) -> n_blocks x [LayerNorm(1e-6) (or none) ->
//   Dense(4h) -> ReLU -> Dense(h) + skip] -> ReLU -> Dense(A) = y (eps, x0
//   or v), then x0 = clip(c0 (cx x - c1 y)), x = c2 x0 + c3 x + c4
//   noise[step]. Every MLPDiffusion the JAX package builds runs here: the
//   JAX kernel took only the swish, LayerNorm, learnable-time recipe and
//   left the rest to its XLA scan.
//
// The function is fp32 in the JAX package, so the products cannot simply
// drop to TF32 (three decimal digits). Each operand is split a = hi + lo,
// hi = tf32(a), lo = tf32(a - hi), and hi*hi + hi*lo + lo*hi is summed in
// fp32 by mma.sync m16n8k8: about 2^-21 relative error a product. The
// tensor core truncates when it adds into its accumulator, which over a
// K = 256 chain costs more than the split saves (1.9e-4 against the fp32
// twin, measured), so each stage's 16 K-rows are summed from zero on the
// tensor core and that partial sum is added to the running fp32 sum on the
// CUDA cores, which round to nearest: 3e-6 against the twin, inside the
// tolerances it is held to (1e-4 DDIM-10, 1e-3 DDPM-50).
//
// What bounds it on H100: three TF32 mma passes over 2*N*K*M FLOPs (783
// GFLOP of tensor-core work for DDIM-10 at 8192 rows, bench widths) and,
// about as long, the weight stream: every 64-row block reads all 6.4 MB of
// fp32 weights from L2 once per step. The design:
//  * A block owns 64 rows for all steps (32 where a wide condition's 64-row
//    [x|s] tile leaves no room for the weight ring: an IDM over two
//    270-wide observations, S = 540, needs 32; the host picks, see
//    ops/kernels/diffusion_mlp.py). The residual h (64 x H) never
//    leaves registers: it is the accumulator of the H-wide products, in mma
//    C-fragment layout, warp w holding columns [w H/8, (w+1) H/8) of all 64
//    rows. LayerNorm reduces it across warps through a few hundred bytes of
//    shared memory. Only the A operands (x|s, the LayerNorm output, one
//    H-column chunk of the 4H layer, so the 4H activation is never held
//    whole) are in shared memory, at a row stride of 4 mod 32 floats so
//    that fragment loads hit 32 distinct banks.
//  * Weights arrive pre-tiled (ops/kernels/diffusion_mlp.py): stages of 16
//    K-rows x H columns in B-fragment order, in the order they are consumed,
//    through a ring of cp.async stages (stream.cuh) that runs ahead across
//    chunk, block and step boundaries. They are stored unsplit and split
//    into hi/lo in the kernel (three instructions an element, amortised over
//    four row tiles): pre-split weights would double the stream. ROWS stays
//    64: the residual and one chunk's accumulator are 128 registers a thread
//    (255 in all, no spill), and 128 rows would need twice that.
//  * The time conditioning is the same for every row of a step: a prologue
//    kernel of the same call computes, per step, the cond MLP and its share
//    of the trunk's input layer (+ bias) on the CUDA cores into scratch; the
//    7-wide output layer, LayerNorm and the update stay on the CUDA cores.
//  * Any hidden width h up to 1536: the kernel runs Hp = h padded to whole
//    64-column tiles (to 128 past 256, to 256 past 512, to 1536 past 1024),
//    the padding zero in
//    every weight and vector, so the padded columns of the residual stay 0;
//    LayerNorm's mean and variance are taken over the h real columns. Past
//    256 a block holds 32 rows (the residual in registers doubles) and the
//    4h layer runs in eight passes of Hp / 2 columns instead of four of Hp,
//    so one pass's accumulator stays 32 registers; past 512 a block holds 16
//    rows and the 4h layer runs in Hp / 64 passes of 256 columns, and the
//    products walk the column tiles one at a time (gemm3's lean order), so
//    a tile's split weights are 8 registers, not 8 NT. Past 1024 (Hp 1536:
//    a stage of 16 K-rows would be 96 KB, and two of them beside the
//    LayerNorm output no longer fit) a ring stage holds 8 K-rows: one k8
//    half of a 16-row tile of the Hp-wide matrices (their products summed
//    from zero a half at a time), or half the 16-row tiles of a 4H pass's
//    w0 columns; the stream is the same. LayerNorm or none is a template
//    parameter.
//  * A [x|s] row too wide for the rows a block holds (kChunk): the block
//    keeps x (rows x A) and a window of one 16-column chunk of [x|s]; the
//    trunk input layer fills the window chunk by chunk, s read from global
//    memory, each chunk's product taking the ring's next stage as before, so
//    the sums are the same in the same order as with the row held whole.
//
// Packed buffer (fp32): [ stream | vectors ]. Stream, per step: the trunk
// input layer's [x|s] rows (K padded to 16), then per block and per pass c
// of the 4H layer: w0[:, c], w1[c, :]. Vectors:
//   ff(half)  cond layers [w(in x out) b(out)]...  twc(C x Hp) tb0(Hp)
//   n_blocks x [ln_s(Hp) ln_b(Hp) b0(passes x Hc) b1(Hp)]  ow(Hp x A) ob(A)
#include <cstdint>

#include "common.cuh"
#include "stream.cuh"

namespace {

constexpr float kLnEps = 1e-6f;
constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kStageK = 16;     // K-rows per ring stage (of Hp columns)
constexpr int kMaxCond = 16;    // most layers of the cond MLP

enum Act : int { kRelu = 0, kSwish = 1, kMish = 2, kGelu = 3 };

struct Dims {
  int N, S, A, T, half, H, Hp, n_blocks, kxs, stages, stream_stages,
      vec_base, smem_main, smem_pro, rows, ln, n_cond, act, learnable, maxw,
      blk_base, ow_off, chunk, cond_w[kMaxCond];
};
constexpr int kNDims = 23 + kMaxCond;

__device__ __forceinline__ float act_fn(int act, float x) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.f);
    case kSwish: return ldp::swishf(x);
    case kMish: return ldp::mishf(x);
    default: {  // flax.linen.gelu: the tanh approximation
      const float k = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
    }
  }
}

// Per step: what the time contributes to the trunk's input layer,
// cbias[step][n] = tb0[n] + sum_k cond(t)[k] twc[k][n] (Hp columns), the
// cond MLP's layers walked from the vectors.
__global__ void __launch_bounds__(kThreads) mlp_time_kernel(
    const int* __restrict__ ts, const float* __restrict__ w,
    float* __restrict__ cbias, Dims d) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);   // two rows of maxw
  float* nxt = buf + d.maxw;
  const float* v = w + d.vec_base;
  const int tid = threadIdx.x, NT = blockDim.x, step = blockIdx.x;
  const float t = static_cast<float>(ts[step]);
  for (int i = tid; i < d.half; i += NT) {
    const float f = d.learnable ? (2.f * ldp::kPi * t) * v[i] : t * v[i];
    buf[i] = cosf(f);
    buf[d.half + i] = sinf(f);
  }
  __syncthreads();
  const float* p = v + d.half;
  int in = 2 * d.half;
  for (int l = 0; l < d.n_cond; ++l) {
    const int out = d.cond_w[l];
    const float* cw = p;
    const float* cb = p + in * out;
    for (int n = tid; n < out; n += NT) {
      float a = cb[n];
      for (int k = 0; k < in; ++k) a = fmaf(buf[k], cw[k * out + n], a);
      nxt[n] = l + 1 < d.n_cond ? act_fn(d.act, a) : a;
    }
    __syncthreads();
    float* tmp = buf; buf = nxt; nxt = tmp;
    p = cb + out;
    in = out;
  }
  const float* twc = p;
  const float* tb0 = twc + in * d.Hp;
  for (int n = tid; n < d.Hp; n += NT) {
    float a = tb0[n];
    for (int k = 0; k < in; ++k) a = fmaf(buf[k], twc[k * d.Hp + n], a);
    cbias[static_cast<size_t>(step) * d.Hp + n] = a;
  }
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = ldp::to_tf32(x);
  lo = ldp::to_tf32(x - __uint_as_float(hi));
}

// acc[mt][nt] += A (16 kMt rows x K, shared, stride lda) * W (K x 64 NT,
// the next K / (16 kSub) stages of the stream; a stage holds kSub tiles of
// 16 K-rows), as hi*hi + hi*lo + lo*hi in TF32. Warp w computes columns
// [8 NT w, 8 NT (w + 1)). kHalf: stages of 8 K-rows, so a stage holds one
// k8 half of a tile (kSub 1) or kSub / 2 tiles.
// Past 8 column tiles (Hp > 512) the lean order: row tile by row tile, the
// A fragments of both k8 steps split once, then column tile by column tile
// its weights split and its six products chained; each element's products
// and sums are the same, in the same order, as in the order above.
template <int NT, int kMt, int kSub, bool kHalf = false, typename Ring>
__device__ __forceinline__ void gemm3(float (&acc)[kMt][NT][4], const float* A,
                                      int lda, int K, Ring& ring, int warp,
                                      int lane) {
  const int g = lane >> 2, tq = lane & 3;
  if constexpr (kHalf && kSub == 1) {
    // a stage is one k8 half of a tile: its products summed from zero on
    // the tensor core and added on the CUDA cores
    for (int kb = 0; kb < K; kb += 8) {
      const float* st = reinterpret_cast<const float*>(ring.enter());
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        uint32_t ah[4], al[4];
        const float* ap = A + (mt * 16 + g) * lda + kb + tq;
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * lda], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * lda + 4], ah[3], al[3]);
#pragma unroll 2
        for (int nt = 0; nt < NT; ++nt) {
          const float2 wv = *reinterpret_cast<const float2*>(
              st + (((warp * NT + nt) * 32 + lane) << 1));
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(wv.x, bh0, bl0);
          split_tf32(wv.y, bh1, bl1);
          float part[4];
          ldp::mma_tf32_zero(part, al, bh0, bh1);
          ldp::mma_tf32(part, ah, bl0, bl1);
          ldp::mma_tf32(part, ah, bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
        }
      }
    }
    return;
  }
  // tiles a stage (8 K-rows a stage: half of them)
  constexpr int kSubS = kHalf && kSub > 1 ? kSub / 2 : kSub;
  static_assert(!kHalf || kSub == 1 || kSub % 2 == 0,
                "a stage of 8 K-rows holds whole tiles");
  for (int k0 = 0; k0 < K; k0 += kStageK * kSubS) {
    const float* stage = reinterpret_cast<const float*>(ring.enter());
#pragma unroll
    for (int sub = 0; sub < kSubS; ++sub) {
      const float* st = stage + sub * kStageK * 64 * NT;
      const int kb = k0 + sub * kStageK;
      if constexpr (NT > 8) {
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8) {
            const float* ap = A + (mt * 16 + g) * lda + kb + k8 * 8 + tq;
            split_tf32(ap[0], ah[k8][0], al[k8][0]);
            split_tf32(ap[8 * lda], ah[k8][1], al[k8][1]);
            split_tf32(ap[4], ah[k8][2], al[k8][2]);
            split_tf32(ap[8 * lda + 4], ah[k8][3], al[k8][3]);
          }
#pragma unroll 2
          for (int nt = 0; nt < NT; ++nt) {
            float part[4];
#pragma unroll
            for (int k8 = 0; k8 < 2; ++k8) {
              const float2 wv = *reinterpret_cast<const float2*>(
                  st + ((((k8 * kWarps + warp) * NT + nt) * 32 + lane) << 1));
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(wv.x, bh0, bl0);
              split_tf32(wv.y, bh1, bl1);
              if (k8 == 0)
                ldp::mma_tf32_zero(part, al[k8], bh0, bh1);
              else
                ldp::mma_tf32(part, al[k8], bh0, bh1);
              ldp::mma_tf32(part, ah[k8], bl0, bl1);
              ldp::mma_tf32(part, ah[k8], bh0, bh1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
          }
        }
      } else {
        uint32_t bh[2][NT][2], bl[2][NT][2];
#pragma unroll
        for (int k8 = 0; k8 < 2; ++k8)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 wv = *reinterpret_cast<const float2*>(
                st + ((((k8 * kWarps + warp) * NT + nt) * 32 + lane) << 1));
            split_tf32(wv.x, bh[k8][nt][0], bl[k8][nt][0]);
            split_tf32(wv.y, bh[k8][nt][1], bl[k8][nt][1]);
          }
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          // the tensor core truncates when it adds into its accumulator: sum
          // a stage's products from zero there and add the
          // partial sum on the CUDA cores, which round to nearest
          float part[NT][4];
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8) {
            const float* ap = A + (mt * 16 + g) * lda + kb + k8 * 8 + tq;
            uint32_t ah[4], al[4];
            split_tf32(ap[0], ah[0], al[0]);
            split_tf32(ap[8 * lda], ah[1], al[1]);
            split_tf32(ap[4], ah[2], al[2]);
            split_tf32(ap[8 * lda + 4], ah[3], al[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (k8 == 0)
                ldp::mma_tf32_zero(part[nt], al, bh[k8][nt][0], bh[k8][nt][1]);
              else
                ldp::mma_tf32(part[nt], al, bh[k8][nt][0], bh[k8][nt][1]);
              ldp::mma_tf32(part[nt], ah, bl[k8][nt][0], bl[k8][nt][1]);
              ldp::mma_tf32(part[nt], ah, bh[k8][nt][0], bh[k8][nt][1]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
        }
      }
    }
  }
}

// NT: 64-column tiles of Hp (Hp = 64 NT); kLn: LayerNorm in the blocks;
// kNC: passes over the 4H layer (4 of Hp columns, 8 of Hp / 2, or Hp / 64
// of 256); kChunk: the [x|s] row walked in 16-column chunks.
template <int NT, int kRows, bool kLn, int kNC, bool kChunk>
__global__ void __launch_bounds__(kThreads, 1) mlp_sampler_kernel(
    const float* __restrict__ s, const float* __restrict__ x_init,
    const float* __restrict__ coefs, const float* __restrict__ noise,
    const float* __restrict__ w, const float* __restrict__ cbias,
    float* __restrict__ out, Dims d, float clip) {
  constexpr int kMt = kRows / 16;   // m16 row tiles
  constexpr int H = 64 * NT;        // Hp: the padded width
  constexpr int NTc = NT * 4 / kNC; // column tiles of one 4H pass
  constexpr int Hc = 64 * NTc;
  constexpr int kSub = H / Hc;      // 16-row tiles of w0[:, c] a stage
  constexpr bool kHalf = H > 1024;  // stages of 8 K-rows (see the note)
  constexpr int kStageBytes = (kHalf ? kStageK / 2 : kStageK) * H * 4;
  constexpr int lda = H + 4;
  constexpr int ldc = Hc + 4;       // one pass of the 4H layer
  extern __shared__ float4 smem4[];
  char* smc = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int N = d.N, S = d.S, A = d.A, kxs = d.kxs, Hr = d.H;
  const float inv_h = 1.f / Hr;
  const bool padded = Hr < H;        // LayerNorm masks the padding

  // xs: the [x|s] rows whole (kxs = Kin + 4), or one 16-column chunk of
  // them (kxs = 20), x then in xv
  float* xs = reinterpret_cast<float*>(smc + d.stages * kStageBytes);
  float* ln = xs + kRows * kxs;      // rows x lda: LayerNorm out, relu(h)
  float* act = ln + kRows * lda;     // rows x ldc: one pass of the 4H layer
  float* part = act + kRows * ldc;   // rows x 8 partial row sums
  float* eps = part + kRows * kWarps;  // rows x A: the net's output y
  float* xv = eps + kRows * A;       // kChunk: rows x A, the sample x
  float* xp = kChunk ? xv : xs;      // where x lives, row stride xld
  const int xld = kChunk ? A : kxs;

  const float* v = w + d.vec_base;
  const float* blocks = v + d.blk_base;
  const int blk_size = 7 * H;        // ln_s ln_b b0 (4 Hp) b1
  const float* ow = v + d.ow_off;    // Hp x A, zero rows past Hr
  const float* ob = ow + H * A;
  ldp::WeightRing<kStageBytes> ring;
  ring.start(w, smc, d.stages, d.stream_stages, d.stream_stages * d.T);

  if constexpr (kChunk) {
    for (int i = tid; i < kRows * A; i += kThreads) {
      const int r = i / A, row = row0 + r;
      xv[i] = row < N ? x_init[static_cast<size_t>(row) * A + i - r * A]
                      : 0.f;
    }
  } else {
    for (int i = tid; i < kRows * kxs; i += kThreads) {
      const int r = i / kxs, k = i - r * kxs, row = row0 + r;
      float val = 0.f;
      if (row < N) {
        if (k < A) val = x_init[static_cast<size_t>(row) * A + k];
        else if (k < A + S) val = s[static_cast<size_t>(row) * S + (k - A)];
      }
      xs[i] = val;
    }
  }
  __syncthreads();

  const int col0 = warp * 8 * NT + 2 * tq;   // + 8 nt + e
  const int colc = warp * 8 * NTc + 2 * tq;  // a 4H pass's columns
  const int Kin = (A + S + kStageK - 1) / kStageK * kStageK;  // padded to 16
  float h[kMt][NT][4];

  for (int step = 0; step < d.T; ++step) {
    // ---- trunk input layer: h = [x|s] W + (time share + bias) ----
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float c0 = cbias[step * H + col0 + 8 * nt];
      const float c1 = cbias[step * H + col0 + 8 * nt + 1];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        h[mt][nt][0] = c0; h[mt][nt][1] = c1;
        h[mt][nt][2] = c0; h[mt][nt][3] = c1;
      }
    }
    if constexpr (kChunk) {
      // chunk j of [x|s]: x from xv, s from global memory; a barrier before
      // each fill, so no warp still reads the chunk before
      for (int k0 = 0; k0 < Kin; k0 += kStageK) {
        __syncthreads();
        for (int i = tid; i < kRows * kStageK; i += kThreads) {
          const int r = i / kStageK, k = k0 + i - r * kStageK, row = row0 + r;
          float val = 0.f;
          if (k < A) val = xv[r * A + k];
          else if (k < A + S && row < N)
            val = __ldg(s + static_cast<size_t>(row) * S + (k - A));
          xs[r * kxs + i - r * kStageK] = val;
        }
        __syncthreads();
        gemm3<NT, kMt, 1, kHalf>(h, xs, kxs, kStageK, ring, warp, lane);
      }
    } else {
      gemm3<NT, kMt, 1, kHalf>(h, xs, kxs, Kin, ring, warp, lane);
    }

    // ---- residual blocks ----
    for (int b = 0; b < d.n_blocks; ++b) {
      const float* ln_s = blocks + b * blk_size;
      const float* ln_b = ln_s + H;
      const float* b0 = ln_b + H;
      const float* b1 = b0 + 4 * H;

      float mu[kMt][2], rstd[kMt][2];
      if constexpr (kLn) {
        // LayerNorm over the row's Hr real columns (the padding holds 0),
        // two passes, rows spread over the warps
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              sum += h[mt][nt][2 * hf] + h[mt][nt][2 * hf + 1];
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (tq == 0) part[(mt * 16 + g + 8 * hf) * kWarps + warp] = sum;
          }
        __syncthreads();
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float* p = part + (mt * 16 + g + 8 * hf) * kWarps;
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < kWarps; ++q) sum += p[q];
            mu[mt][hf] = sum * inv_h;
          }
        __syncthreads();
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float sq = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = col0 + 8 * nt;
              float d0 = h[mt][nt][2 * hf] - mu[mt][hf];
              float d1 = h[mt][nt][2 * hf + 1] - mu[mt][hf];
              if (padded) {
                d0 = c < Hr ? d0 : 0.f;
                d1 = c + 1 < Hr ? d1 : 0.f;
              }
              sq = fmaf(d0, d0, sq);
              sq = fmaf(d1, d1, sq);
            }
            sq += __shfl_xor_sync(0xffffffffu, sq, 1);
            sq += __shfl_xor_sync(0xffffffffu, sq, 2);
            if (tq == 0) part[(mt * 16 + g + 8 * hf) * kWarps + warp] = sq;
          }
        __syncthreads();
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float* p = part + (mt * 16 + g + 8 * hf) * kWarps;
            float sq = 0.f;
#pragma unroll
            for (int q = 0; q < kWarps; ++q) sq += p[q];
            rstd[mt][hf] = rsqrtf(sq * inv_h + kLnEps);
          }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = col0 + 8 * nt;
        const float r0 = b1[c], r1 = b1[c + 1];
        float s0 = 0.f, s1 = 0.f, o0 = 0.f, o1 = 0.f;
        if constexpr (kLn) {
          s0 = ln_s[c]; s1 = ln_s[c + 1];
          o0 = ln_b[c]; o1 = ln_b[c + 1];
        }
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float& h0 = h[mt][nt][2 * hf];
            float& h1 = h[mt][nt][2 * hf + 1];
            float2 y;
            if constexpr (kLn) {
              y.x = (h0 - mu[mt][hf]) * rstd[mt][hf] * s0 + o0;
              y.y = (h1 - mu[mt][hf]) * rstd[mt][hf] * s1 + o1;
            } else {
              y.x = h0;
              y.y = h1;
            }
            *reinterpret_cast<float2*>(ln + (mt * 16 + g + 8 * hf) * lda + c)
                = y;
            h0 += r0;   // the second layer's bias joins the residual now
            h1 += r1;
          }
      }
      __syncthreads();

      for (int c4 = 0; c4 < kNC; ++c4) {
        float a1[kMt][NTc][4];
#pragma unroll
        for (int nt = 0; nt < NTc; ++nt) {
          const float c0 = b0[c4 * Hc + colc + 8 * nt];
          const float c1 = b0[c4 * Hc + colc + 8 * nt + 1];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            a1[mt][nt][0] = c0; a1[mt][nt][1] = c1;
            a1[mt][nt][2] = c0; a1[mt][nt][3] = c1;
          }
        }
        gemm3<NTc, kMt, kSub, kHalf>(a1, ln, lda, H, ring, warp, lane);
        // every warp is past its reads of `act` from the pass before: the
        // ring's barriers inside the product above saw to that
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int nt = 0; nt < NTc; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float2 y;
              y.x = fmaxf(a1[mt][nt][2 * hf], 0.f);
              y.y = fmaxf(a1[mt][nt][2 * hf + 1], 0.f);
              *reinterpret_cast<float2*>(
                  act + (mt * 16 + g + 8 * hf) * ldc + colc + 8 * nt) = y;
            }
        __syncthreads();
        gemm3<NT, kMt, 1, kHalf>(h, act, ldc, Hc, ring, warp, lane);
      }
    }

    // ---- output layer and the sampler update (CUDA cores) ----
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2 y;
          y.x = fmaxf(h[mt][nt][2 * hf], 0.f);
          y.y = fmaxf(h[mt][nt][2 * hf + 1], 0.f);
          *reinterpret_cast<float2*>(
              ln + (mt * 16 + g + 8 * hf) * lda + col0 + 8 * nt) = y;
        }
    __syncthreads();
    for (int i = tid; i < kRows * A; i += kThreads) {
      const int r = i / A, a = i - r * A;
      const float* hr = ln + r * lda;
      float e = ob[a];
#pragma unroll 8
      for (int k = 0; k < H; ++k) e = fmaf(hr[k], ow[k * A + a], e);
      eps[i] = e;
    }
    __syncthreads();
    const float k0 = coefs[step * 6 + 0], k1 = coefs[step * 6 + 1];
    const float k2 = coefs[step * 6 + 2], k3 = coefs[step * 6 + 3];
    const float k4 = coefs[step * 6 + 4], kx = coefs[step * 6 + 5];
    for (int i = tid; i < kRows * A; i += kThreads) {
      const int r = i / A, a = i - r * A, row = row0 + r;
      const float x = xp[r * xld + a];
      // x0 = clip(k0 (kx x - k1 y)): kx = 1 for eps, 0 for sample (x0
      // prediction), sqrt(abar) for v; 1 * x is x, so eps runs as before
      const float x0 = fminf(
          fmaxf(k0 * fmaf(-k1, eps[i], __fmul_rn(kx, x)), -clip), clip);
      float xn = k2 * x0 + k3 * x;
      if (noise != nullptr && row < N)
        xn += k4 * noise[(static_cast<size_t>(step) * N + row) * A + a];
      xp[r * xld + a] = xn;
    }
    __syncthreads();
  }
  ring.drain();

  for (int i = tid; i < kRows * A; i += kThreads) {
    const int r = i / A, a = i - r * A, row = row0 + r;
    if (row < N) out[static_cast<size_t>(row) * A + a] = xp[r * xld + a];
  }
}

template <int NT, int kRows, bool kLn, int kNC, bool kChunk>
int launch_rows(const float* s, const float* x_init, const float* coefs,
                const float* noise, const float* w, const float* cbias,
                float* out, const Dims& d, float clip, cudaStream_t stream) {
  auto kernel = mlp_sampler_kernel<NT, kRows, kLn, kNC, kChunk>;
  cudaError_t err = ldp::allow_smem(kernel, d.smem_main);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (d.N + kRows - 1) / kRows;
  kernel<<<grid, kThreads, d.smem_main, stream>>>(s, x_init, coefs, noise, w,
                                                  cbias, out, d, clip);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int kRows, int kNC, bool kChunk>
int launch_ln(const float* s, const float* x_init, const float* coefs,
              const float* noise, const float* w, const float* cbias,
              float* out, const Dims& d, float clip, cudaStream_t stream) {
  return d.ln ? launch_rows<NT, kRows, true, kNC, kChunk>(
                    s, x_init, coefs, noise, w, cbias, out, d, clip, stream)
              : launch_rows<NT, kRows, false, kNC, kChunk>(
                    s, x_init, coefs, noise, w, cbias, out, d, clip, stream);
}

// kTop: the most rows a block holds at this width (64 up to Hp 256, then 32
// and 16); up to Hp 256 also 32 with the row whole. The chunked instance
// runs at kTop rows only.
template <int NT, int kTop, int kNC>
int launch(const float* s, const float* x_init, const float* coefs,
           const float* noise, const float* w, const float* cbias, float* out,
           const Dims& d, float clip, cudaStream_t stream) {
  if (d.chunk)
    return d.rows == kTop
               ? launch_ln<NT, kTop, kNC, true>(s, x_init, coefs, noise, w,
                                                cbias, out, d, clip, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  if (d.rows == kTop)
    return launch_ln<NT, kTop, kNC, false>(s, x_init, coefs, noise, w, cbias,
                                           out, d, clip, stream);
  if constexpr (kTop == 64) {
    if (d.rows == 32)
      return launch_ln<NT, 32, kNC, false>(s, x_init, coefs, noise, w, cbias,
                                           out, d, clip, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `dims` is kNDims host ints in the order of Dims; Hp (the padded hidden
// width) must be 64, 128, 192, 256, 384, 512, 768, 1024 or 1536, rows 64 or
// 32 (32 past 256, 16 past 512; chunked at the most rows); coefs is the (T, 6)
// table of ops/diffusion.py; noise may be null (DDIM); cbias (T x Hp) is
// scratch. Returns a cudaError_t.
extern "C" int ldp_mlp_sampler(const float* s, const float* x_init,
                               const int* ts, const float* coefs,
                               const float* noise, const float* w,
                               float* cbias, float* out, const int* dims,
                               int n_dims, float clip, void* stream) {
  if (n_dims != kNDims) return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  int* fields = reinterpret_cast<int*>(&d);
  for (int i = 0; i < kNDims; ++i) fields[i] = dims[i];
  if (d.Hp % 64 || d.Hp < 64 || (d.Hp > 1024 && d.Hp != 1536) ||
      d.H > d.Hp || d.H < 1 ||
      d.stages < 2 || d.stages > 8 ||
      (d.rows != 64 && d.rows != 32 && d.rows != 16) || d.n_cond < 1 ||
      d.n_cond > kMaxCond || d.chunk < 0 || d.chunk > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ldp::allow_smem(mlp_time_kernel, d.smem_pro);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_time_kernel<<<d.T, kThreads, d.smem_pro, st>>>(ts, w, cbias, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d.Hp / 64) {
    case 1: return launch<1, 64, 4>(s, x_init, coefs, noise, w, cbias, out, d,
                                    clip, st);
    case 2: return launch<2, 64, 4>(s, x_init, coefs, noise, w, cbias, out, d,
                                    clip, st);
    case 3: return launch<3, 64, 4>(s, x_init, coefs, noise, w, cbias, out, d,
                                    clip, st);
    case 4: return launch<4, 64, 4>(s, x_init, coefs, noise, w, cbias, out, d,
                                    clip, st);
    case 6: return launch<6, 32, 8>(s, x_init, coefs, noise, w, cbias, out, d,
                                    clip, st);
    case 8: return launch<8, 32, 8>(s, x_init, coefs, noise, w, cbias, out, d,
                                    clip, st);
    case 12: return launch<12, 16, 12>(s, x_init, coefs, noise, w, cbias, out,
                                       d, clip, st);
    case 16: return launch<16, 16, 16>(s, x_init, coefs, noise, w, cbias, out,
                                       d, clip, st);
    case 24: return launch<24, 16, 24>(s, x_init, coefs, noise, w, cbias, out,
                                       d, clip, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
