// Fused DDIM (eta = 0) reverse process of ConditionalUnet1D: bf16 weights,
// fp32 activations and accumulation.
//
// Replaces the TPU kernel latent_diffusion_planning_tpu/ops/pallas/
// diffusion_unet1d.py (fused_unet1d_ddim_sample -> _kernel), both its
// VMEM-resident and its streamed-weights mode: one launch runs every step of
// the reverse process for a tile of `nb` samples. Per step:
//   sinusoidal t-embedding -> Dense(4d) -> Mish -> Dense(d); concat global
//   cond; Mish. Then the U-Net: FiLM residual blocks (conv k SAME -> GN ->
//   Mish -> FiLM -> conv -> GN -> Mish, + 1x1 projection when Cin != Cout),
//   stride-2 k3 downsample (Flax SAME pads (0, 1)), ConvTranspose k4 s2
//   upsample (x[t] w[j] -> y[2t+2-j]), skip concat, final conv block, 1x1
//   conv to eps; x0 = clip(c0 (x - c1 eps)), x = c2 x0 + c3 x.
//
// What bounds it on H100: the function is bf16 products with fp32
// accumulation (about 21 MFLOP per sample and step at the bench widths), so
// its bound is the bf16 tensor-core rate. This first design runs them as
// fp32 FMAs on the CUDA cores, which is what limits it now, then the L2
// reads of the bf16 weights (10.7 MB per step and block). Every activation and skip of the
// tile stays in shared memory for all steps; only the final sample is
// written back. Convolutions accumulate over taps (the 5-tap concatenation
// is never materialised): a work item is 4 output channels x 4 rows, so
// each 8-byte weight load from L2 feeds 16 FMAs and each activation read,
// a shared-memory broadcast across the warp, feeds 4. Taps outside a
// sample read a zero row, so the inner loop carries no masks. (Staging the
// weights through shared memory was tried and measured slower: the limit
// is instruction issue in this loop, not L2 latency.) GroupNorm statistics
// are two-pass fp32 per sample and group.
//
// The net arrives as a program of 8-int records (built by
// ops/kernels/diffusion_unet1d.py) that index one packed bf16 buffer, so any
// down_dims / n_groups / embedding width runs through the same kernel.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum Op : int {
  kFilm = 0,        // cin, ch, Tl, off_conv1, off_conv2, off_film, off_proj
  kSave = 1,        // skip_off, C, Tl
  kConcat = 2,      // skip_off, C_h, C_skip, Tl
  kDown = 3,        // ch, Tl_in, off
  kUp = 4,          // ch, Tl_in, off
  kFinalBlock = 5,  // cin, ch, Tl, off
  kFinalConv = 6,   // cin, D, Tl, off
};
constexpr int kRec = 8;
constexpr int kRT = 4;      // rows per conv work item
constexpr int kCT = 4;      // output channels per conv work item
constexpr int kNbMax = 8;   // samples per block, upper bound
constexpr float kGnEps = 1e-6f;

enum ConvMode { kSame = 0, kStride2 = 1, kTranspose = 2 };

__device__ __forceinline__ float bf(const bf16* p) {
  return __bfloat162float(*p);
}

// out[r][co] (+)= bias[co] + sum_j sum_ci in[src(r, j)][ci] W[j][ci][co]
// rows are (sample, time) with Tin / Tout time steps per sample. A work
// item is kCT output channels x kRT rows. A tap that falls outside its
// sample reads `zrow` (Cin zeros in shared memory), so the inner loop is
// loads and FMAs only.
template <int MODE>
__device__ void conv_rows(const float* in, int Cin, int Tin, float* out,
                          int Cout, int Tout, int nb, const bf16* W,
                          const bf16* bias, int K, bool accumulate,
                          const float* zrow) {
  const int rows = nb * Tout;
  const int ncg = (Cout + kCT - 1) / kCT;
  const int n_items = ncg * ((rows + kRT - 1) / kRT);
  const int pad = K >> 1;
  // kCT bf16 weights load as one 8-byte word when every group is aligned
  const bool vec = !(Cout % kCT) && !(reinterpret_cast<uintptr_t>(W) & 7);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int co = kCT * (item % ncg);
    const int r0 = (item / ncg) * kRT;
    float acc[kCT][kRT];
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      const float b = co + c < Cout ? bf(bias + co + c) : 0.f;
#pragma unroll
      for (int q = 0; q < kRT; ++q) acc[c][q] = b;
    }
    for (int j = 0; j < K; ++j) {
      const float* rp[kRT];
#pragma unroll
      for (int q = 0; q < kRT; ++q) {
        const int r = r0 + q;
        int sr = -1;
        if (r < rows) {
          const int b = r / Tout, t = r - b * Tout;
          if (MODE == kSame) {
            const int s = t + j - pad;
            if (s >= 0 && s < Tin) sr = b * Tin + s;
          } else if (MODE == kStride2) {
            const int s = 2 * t + j;
            if (s < Tin) sr = b * Tin + s;
          } else {
            const int s = t + j - 2;
            if (s >= 0 && !(s & 1) && (s >> 1) < Tin) sr = b * Tin + (s >> 1);
          }
        }
        rp[q] = sr >= 0 ? in + sr * Cin : zrow;
      }
      const bf16* wj = W + static_cast<size_t>(j) * Cin * Cout + co;
#pragma unroll 4
      for (int ci = 0; ci < Cin; ++ci) {
        float w[kCT];
        if (vec) {
          const uint2 u = *reinterpret_cast<const uint2*>(wj + ci * Cout);
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.y));
          w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
        } else {
#pragma unroll
          for (int c = 0; c < kCT; ++c)
            w[c] = co + c < Cout ? bf(wj + ci * Cout + c) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kRT; ++q) {
          const float v = rp[q][ci];
#pragma unroll
          for (int c = 0; c < kCT; ++c) acc[c][q] = fmaf(v, w[c], acc[c][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = r0 + q;
      if (r >= rows) break;
      float* o = out + r * Cout + co;
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        if (co + c < Cout) o[c] = accumulate ? o[c] + acc[c][q] : acc[c][q];
    }
  }
}

// out[b][n] = bias[n] + sum_k in[b][k] W[k][n] for b < nb, optional Mish.
__device__ void dense_rows(const float* in, int K, const bf16* W,
                           const bf16* bias, float* out, int Nout, int nb,
                           bool mish) {
  for (int n = threadIdx.x; n < Nout; n += blockDim.x) {
    float acc[kNbMax];
    const float b0 = bf(bias + n);
#pragma unroll
    for (int b = 0; b < kNbMax; ++b) acc[b] = b0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wv = bf(W + static_cast<size_t>(k) * Nout + n);
#pragma unroll
      for (int b = 0; b < kNbMax; ++b)
        if (b < nb) acc[b] = fmaf(in[b * K + k], wv, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < kNbMax; ++b)
      if (b < nb) out[b * Nout + n] = mish ? ldp::mishf(acc[b]) : acc[b];
  }
}

// In place on x (nb*Tl rows x C): GroupNorm(G, eps 1e-6) -> Mish, then
// FiLM (scale * y + bias) when film is given (nb x 2C).
__device__ void group_norm_mish(float* x, int C, int Tl, int nb, int G,
                                const bf16* gs, const bf16* gb, float* stats,
                                const float* film) {
  const int Cg = C / G, n = Tl * Cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int p = warp; p < nb * G; p += n_warps) {
    const int b = p / G, g = p - b * G;
    const float* xb = x + b * Tl * C + g * Cg;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s += xb[(i / Cg) * C + i % Cg];
    const float mu = ldp::warp_sum(s) / n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = xb[(i / Cg) * C + i % Cg] - mu;
      sq = fmaf(d, d, sq);
    }
    const float var = ldp::warp_sum(sq) / n;
    if (lane == 0) {
      stats[2 * p] = mu;
      stats[2 * p + 1] = rsqrtf(var + kGnEps);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * Tl * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C, b = r / Tl, p = b * G + c / Cg;
    float y = (x[i] - stats[2 * p]) * stats[2 * p + 1] * bf(gs + c)
              + bf(gb + c);
    y = ldp::mishf(y);
    if (film != nullptr) y = film[b * 2 * C + c] * y + film[b * 2 * C + C + c];
    x[i] = y;
  }
  __syncthreads();
}

struct Dims {
  int B, T, D, Dc, dsed, K, G, nb, maxs, skip_total, film_max, n_ops,
      n_steps, cin_max;
  float clip;
};

__global__ void __launch_bounds__(256, 1) unet1d_sampler_kernel(
    const float* __restrict__ gcond, const float* __restrict__ x_init,
    const int* __restrict__ ts, const float* __restrict__ coefs,
    const bf16* __restrict__ W, const int* __restrict__ prog,
    float* __restrict__ out, Dims d) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, NT = blockDim.x;
  const int nb = d.nb, T = d.T, D = d.D;
  const int b0 = blockIdx.x * nb;
  const int n_valid = min(nb, d.B - b0);
  const int cond_dim = d.dsed + d.Dc;
  const int half = d.dsed / 2;

  float* xcur = sm;                         // nb*T x D
  float* bufs = xcur + nb * T * D;          // 3 x nb*maxs
  float* skip = bufs + 3 * nb * d.maxs;     // skip_total
  float* gc = skip + d.skip_total;          // nb x Dc
  float* emb = gc + nb * d.Dc;              // dsed
  float* hid = emb + d.dsed;                // 4 dsed
  float* temb = hid + 4 * d.dsed;           // dsed
  float* mcond = temb + d.dsed;             // nb x cond_dim
  float* film = mcond + nb * cond_dim;      // nb x film_max
  float* stats = film + nb * d.film_max;    // nb x G x 2
  float* zrow = stats + nb * d.G * 2;       // cin_max zeros

  for (int i = tid; i < nb * T * D; i += NT) {
    const int b = i / (T * D);
    xcur[i] = b < n_valid ? x_init[static_cast<size_t>(b0) * T * D + i] : 0.f;
  }
  for (int i = tid; i < d.cin_max; i += NT) zrow[i] = 0.f;
  for (int i = tid; i < nb * d.Dc; i += NT) {
    const int b = i / d.Dc;
    gc[i] = b < n_valid ? gcond[static_cast<size_t>(b0) * d.Dc + i] : 0.f;
  }
  __syncthreads();

  const bf16* tw0 = W;
  const bf16* tb0 = tw0 + d.dsed * 4 * d.dsed;
  const bf16* tw1 = tb0 + 4 * d.dsed;
  const bf16* tb1 = tw1 + 4 * d.dsed * d.dsed;
  const int K = d.K, G = d.G;

  for (int step = 0; step < d.n_steps; ++step) {
    // ---- diffusion-step encoder and the per-sample condition ----
    const float t = static_cast<float>(ts[step]);
    for (int i = tid; i < half; i += NT) {
      const float f = expf(-logf(10000.f) * i / (half - 1));
      const float ang = t * f;
      emb[i] = sinf(ang);
      emb[half + i] = cosf(ang);
    }
    __syncthreads();
    dense_rows(emb, d.dsed, tw0, tb0, hid, 4 * d.dsed, 1, true);
    __syncthreads();
    dense_rows(hid, 4 * d.dsed, tw1, tb1, temb, d.dsed, 1, false);
    __syncthreads();
    for (int i = tid; i < nb * cond_dim; i += NT) {
      const int b = i / cond_dim, k = i - b * cond_dim;
      mcond[i] = ldp::mishf(k < d.dsed ? temb[k] : gc[b * d.Dc + k - d.dsed]);
    }
    for (int i = tid; i < nb * T * D; i += NT) bufs[i] = xcur[i];
    __syncthreads();

    float* X = bufs;
    float* Y = bufs + nb * d.maxs;
    float* Z = bufs + 2 * nb * d.maxs;
    for (int op = 0; op < d.n_ops; ++op) {
      const int* rec = prog + op * kRec;
      const int kind = rec[0];
      if (kind == kFilm) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const bf16* c1 = W + rec[4];
        const bf16* c2 = W + rec[5];
        const bf16* fw = W + rec[6];
        const size_t k1 = static_cast<size_t>(K) * cin * ch;
        const size_t k2 = static_cast<size_t>(K) * ch * ch;
        dense_rows(mcond, cond_dim, fw,
                   fw + static_cast<size_t>(cond_dim) * 2 * ch, film, 2 * ch,
                   nb, false);
        conv_rows<kSame>(X, cin, Tl, Y, ch, Tl, nb, c1, c1 + k1, K, false,
                         zrow);
        __syncthreads();
        group_norm_mish(Y, ch, Tl, nb, G, c1 + k1 + ch, c1 + k1 + 2 * ch,
                        stats, film);
        conv_rows<kSame>(Y, ch, Tl, Z, ch, Tl, nb, c2, c2 + k2, K, false,
                         zrow);
        __syncthreads();
        group_norm_mish(Z, ch, Tl, nb, G, c2 + k2 + ch, c2 + k2 + 2 * ch,
                        stats, nullptr);
        if (rec[7] >= 0) {
          const bf16* pw = W + rec[7];
          conv_rows<kSame>(X, cin, Tl, Z, ch, Tl, nb, pw,
                           pw + static_cast<size_t>(cin) * ch, 1, true, zrow);
        } else {
          for (int i = tid; i < nb * Tl * ch; i += NT) Z[i] += X[i];
        }
        __syncthreads();
        float* tmp = X; X = Z; Z = tmp;
      } else if (kind == kSave) {
        const int n = nb * rec[3] * rec[2];
        for (int i = tid; i < n; i += NT) skip[rec[1] + i] = X[i];
        __syncthreads();
      } else if (kind == kConcat) {
        const int C1 = rec[2], C2 = rec[3], Cw = C1 + C2;
        const float* sk = skip + rec[1];
        for (int i = tid; i < nb * rec[4] * Cw; i += NT) {
          const int r = i / Cw, c = i - r * Cw;
          Y[i] = c < C1 ? X[r * C1 + c] : sk[r * C2 + c - C1];
        }
        __syncthreads();
        float* tmp = X; X = Y; Y = tmp;
      } else if (kind == kDown || kind == kUp) {
        const int ch = rec[1], Tin = rec[2];
        const bf16* kw = W + rec[3];
        const int kk = kind == kDown ? 3 : 4;
        const bf16* kb = kw + static_cast<size_t>(kk) * ch * ch;
        if (kind == kDown)
          conv_rows<kStride2>(X, ch, Tin, Y, ch, Tin / 2, nb, kw, kb, 3, false,
                              zrow);
        else
          conv_rows<kTranspose>(X, ch, Tin, Y, ch, 2 * Tin, nb, kw, kb, 4,
                                false, zrow);
        __syncthreads();
        float* tmp = X; X = Y; Y = tmp;
      } else if (kind == kFinalBlock) {
        const int cin = rec[1], ch = rec[2], Tl = rec[3];
        const bf16* c1 = W + rec[4];
        const size_t k1 = static_cast<size_t>(K) * cin * ch;
        conv_rows<kSame>(X, cin, Tl, Y, ch, Tl, nb, c1, c1 + k1, K, false,
                         zrow);
        __syncthreads();
        group_norm_mish(Y, ch, Tl, nb, G, c1 + k1 + ch, c1 + k1 + 2 * ch,
                        stats, nullptr);
        float* tmp = X; X = Y; Y = tmp;
      } else {  // kFinalConv
        const int cin = rec[1], Dout = rec[2], Tl = rec[3];
        const bf16* ow = W + rec[4];
        conv_rows<kSame>(X, cin, Tl, Y, Dout, Tl, nb, ow,
                         ow + static_cast<size_t>(cin) * Dout, 1, false, zrow);
        __syncthreads();
        float* tmp = X; X = Y; Y = tmp;
      }
    }

    // X holds eps (nb*T x D)
    const float k0 = coefs[step * 5 + 0], k1 = coefs[step * 5 + 1];
    const float k2 = coefs[step * 5 + 2], k3 = coefs[step * 5 + 3];
    for (int i = tid; i < nb * T * D; i += NT) {
      const float x = xcur[i];
      const float x0 = fminf(fmaxf(k0 * (x - k1 * X[i]), -d.clip), d.clip);
      xcur[i] = k2 * x0 + k3 * x;
    }
    __syncthreads();
  }

  for (int i = tid; i < n_valid * T * D; i += NT)
    out[static_cast<size_t>(b0) * T * D + i] = xcur[i];
}

}  // namespace

// Returns a cudaError_t. nb <= 8 samples per block; smem_bytes as computed
// by the Python wrapper from the same layout.
extern "C" int ldp_unet1d_sampler(const float* gcond, const float* x_init,
                                  const int* ts, const float* coefs,
                                  const void* w, const int* prog, int n_ops,
                                  float* out, int B, int T, int D, int Dc,
                                  int dsed, int K, int G, int nb, int maxs,
                                  int skip_total, int film_max, int n_steps,
                                  int cin_max, float clip, int smem_bytes,
                                  void* stream) {
  if (nb < 1 || nb > kNbMax) return static_cast<int>(cudaErrorInvalidValue);
  Dims d{B, T, D, Dc, dsed, K, G, nb, maxs, skip_total, film_max, n_ops,
         n_steps, cin_max, clip};
  cudaError_t err = ldp::allow_smem(unet1d_sampler_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + nb - 1) / nb;
  unet1d_sampler_kernel<<<grid, 256, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      gcond, x_init, ts, coefs, static_cast<const bf16*>(w), prog, out, d);
  return static_cast<int>(cudaGetLastError());
}
