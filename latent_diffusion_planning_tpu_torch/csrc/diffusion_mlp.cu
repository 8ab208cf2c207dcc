// Fused reverse-diffusion sampler for the MLP IDM (MLPDiffusion), fp32.
//
// Replaces the TPU kernel latent_diffusion_planning_tpu/ops/pallas/
// diffusion_mlp.py (fused_mlp_diffusion_sample -> _sampler_kernel): the
// whole DDPM/DDIM reverse process in one launch. Per step and row:
//   Fourier features [cos, sin](2*pi*t*W) -> cond MLP (Dense, swish, Dense)
//   -> Dense([x, s, cond]) -> n_blocks x [LayerNorm(1e-6) -> Dense(4h) ->
//   ReLU -> Dense(h) + skip] -> ReLU -> Dense(A) = eps, then
//   x0 = clip(c0 (x - c1 eps)), x = c2 x0 + c3 x + c4 noise[step].
//
// What bounds it on H100: fp32 FMAs on the CUDA cores (about 3.2 MFLOP per
// row and step at the bench widths; the weights, 6.6 MB, sit in L2). The
// design keeps every activation of a ROWS-row tile in shared memory for all
// steps, so nothing but the final sample goes back to device memory; each
// weight read from L2 feeds ROWS rows, and the 4h-wide inner layer runs in
// chunks of h columns so the whole 4h activation is never held. One thread
// owns one output column and keeps ROWS accumulators in registers;
// activations are read from shared memory as float4 broadcasts.
//
// Weights arrive packed in one fp32 buffer, Dense kernels as (in, out):
//   ff(half) cw0(2half x C0) cb0 cw1(C0 x C1) cb1 tw0((A+S+C1) x H) tb0
//   n_blocks x [ln_s(H) ln_b(H) w0(H x 4H) b0(4H) w1(4H x H) b1(H)]
//   ow(H x A) ob(A)
#include "common.cuh"

namespace {

constexpr float kLnEps = 1e-6f;

template <int ROWS>
__global__ void __launch_bounds__(256, 1) mlp_sampler_kernel(
    const float* __restrict__ s, const float* __restrict__ x_init,
    const int* __restrict__ ts, const float* __restrict__ coefs,
    const float* __restrict__ noise, const float* __restrict__ w,
    float* __restrict__ out, int N, int S, int A, int T, int half, int C0,
    int C1, int H, int n_blocks, float clip, int kxs) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int NT = blockDim.x;  // == H
  const int row0 = blockIdx.x * ROWS;

  float* xs = sm;                 // ROWS x kxs: [x (A) | s (S) | pad]
  float* h = xs + ROWS * kxs;     // ROWS x H
  float* ln = h + ROWS * H;       // ROWS x H
  float* act = ln + ROWS * H;     // ROWS x H   (one chunk of the 4H layer)
  float* tff = act + ROWS * H;    // 2 half
  float* cv0 = tff + 2 * half;    // C0
  float* cv1 = cv0 + C0;          // C1
  float* cb = cv1 + C1;           // H: cond part of the trunk input + bias
  float* eps = cb + H;            // ROWS x A

  const float* ff = w;
  const float* cw0 = ff + half;
  const float* cb0 = cw0 + 2 * half * C0;
  const float* cw1 = cb0 + C0;
  const float* cb1 = cw1 + C0 * C1;
  const float* tw0 = cb1 + C1;
  const float* tb0 = tw0 + (A + S + C1) * H;
  const float* blocks = tb0 + H;
  const int H4 = 4 * H;
  const int blk_size = 2 * H + H * H4 + H4 + H4 * H + H;
  const float* ow = blocks + n_blocks * blk_size;
  const float* ob = ow + H * A;

  for (int i = tid; i < ROWS * kxs; i += NT) {
    const int r = i / kxs, k = i % kxs, row = row0 + r;
    float v = 0.f;
    if (row < N) {
      if (k < A) v = x_init[row * A + k];
      else if (k < A + S) v = s[row * S + (k - A)];
    }
    xs[i] = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, n_warps = NT >> 5;
  for (int step = 0; step < T; ++step) {
    // ---- time conditioning: identical for every row of the step ----
    const float t = static_cast<float>(ts[step]);
    for (int i = tid; i < half; i += NT) {
      const float f = (2.f * ldp::kPi * t) * ff[i];
      tff[i] = cosf(f);
      tff[half + i] = sinf(f);
    }
    __syncthreads();
    for (int n = tid; n < C0; n += NT) {
      float a = cb0[n];
      for (int k = 0; k < 2 * half; ++k) a = fmaf(tff[k], cw0[k * C0 + n], a);
      cv0[n] = ldp::swishf(a);
    }
    __syncthreads();
    for (int n = tid; n < C1; n += NT) {
      float a = cb1[n];
      for (int k = 0; k < C0; ++k) a = fmaf(cv0[k], cw1[k * C1 + n], a);
      cv1[n] = a;
    }
    __syncthreads();
    for (int n = tid; n < H; n += NT) {
      float a = tb0[n];
      for (int k = 0; k < C1; ++k)
        a = fmaf(cv1[k], tw0[(A + S + k) * H + n], a);
      cb[n] = a;
    }
    __syncthreads();

    // ---- trunk input layer over [x, s] ----
    {
      const int n = tid;
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = cb[n];
      for (int k = 0; k < A + S; ++k) {
        const float wv = tw0[k * H + n];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(xs[r * kxs + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) h[r * H + n] = acc[r];
    }
    __syncthreads();

    // ---- residual blocks ----
    for (int b = 0; b < n_blocks; ++b) {
      const float* ln_s = blocks + b * blk_size;
      const float* ln_b = ln_s + H;
      const float* w0 = ln_b + H;
      const float* b0 = w0 + H * H4;
      const float* w1 = b0 + H4;
      const float* b1 = w1 + H4 * H;

      for (int r = warp; r < ROWS; r += n_warps) {
        const float* hr = h + r * H;
        float sum = 0.f;
        for (int k = lane; k < H; k += 32) sum += hr[k];
        const float mu = ldp::warp_sum(sum) / H;
        float sq = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float d = hr[k] - mu;
          sq = fmaf(d, d, sq);
        }
        const float rstd = rsqrtf(ldp::warp_sum(sq) / H + kLnEps);
        for (int k = lane; k < H; k += 32)
          ln[r * H + k] = (hr[k] - mu) * rstd * ln_s[k] + ln_b[k];
      }
      __syncthreads();

      float acc2[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc2[r] = 0.f;
      for (int c0 = 0; c0 < H4; c0 += H) {
        const int n1 = c0 + tid;
        float acc1[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc1[r] = b0[n1];
        for (int k = 0; k < H; k += 4) {
          const float wa = w0[(k + 0) * H4 + n1], wb = w0[(k + 1) * H4 + n1];
          const float wc = w0[(k + 2) * H4 + n1], wd = w0[(k + 3) * H4 + n1];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(ln + r * H + k);
            acc1[r] = fmaf(v.x, wa, acc1[r]);
            acc1[r] = fmaf(v.y, wb, acc1[r]);
            acc1[r] = fmaf(v.z, wc, acc1[r]);
            acc1[r] = fmaf(v.w, wd, acc1[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) act[r * H + tid] = fmaxf(acc1[r], 0.f);
        __syncthreads();
        for (int k = 0; k < H; k += 4) {
          const float wa = w1[(c0 + k + 0) * H + tid];
          const float wb = w1[(c0 + k + 1) * H + tid];
          const float wc = w1[(c0 + k + 2) * H + tid];
          const float wd = w1[(c0 + k + 3) * H + tid];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(act + r * H + k);
            acc2[r] = fmaf(v.x, wa, acc2[r]);
            acc2[r] = fmaf(v.y, wb, acc2[r]);
            acc2[r] = fmaf(v.z, wc, acc2[r]);
            acc2[r] = fmaf(v.w, wd, acc2[r]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) h[r * H + tid] += acc2[r] + b1[tid];
      __syncthreads();
    }

    // ---- output layer and the sampler update ----
    for (int i = tid; i < ROWS * A; i += NT) {
      const int r = i / A, a = i % A;
      float e = ob[a];
      for (int k = 0; k < H; ++k)
        e = fmaf(fmaxf(h[r * H + k], 0.f), ow[k * A + a], e);
      eps[i] = e;
    }
    __syncthreads();
    const float k0 = coefs[step * 5 + 0], k1 = coefs[step * 5 + 1];
    const float k2 = coefs[step * 5 + 2], k3 = coefs[step * 5 + 3];
    const float k4 = coefs[step * 5 + 4];
    for (int i = tid; i < ROWS * A; i += NT) {
      const int r = i / A, a = i % A, row = row0 + r;
      const float x = xs[r * kxs + a];
      const float x0 = fminf(fmaxf(k0 * (x - k1 * eps[i]), -clip), clip);
      float xn = k2 * x0 + k3 * x;
      if (noise != nullptr && row < N)
        xn += k4 * noise[(static_cast<long long>(step) * N + row) * A + a];
      xs[r * kxs + a] = xn;
    }
    __syncthreads();
  }

  for (int i = tid; i < ROWS * A; i += NT) {
    const int r = i / A, a = i % A, row = row0 + r;
    if (row < N) out[row * A + a] = xs[r * kxs + a];
  }
}

template <int ROWS>
int launch(const float* s, const float* x_init, const int* ts,
           const float* coefs, const float* noise, const float* w, float* out,
           int N, int S, int A, int T, int half, int C0, int C1, int H,
           int n_blocks, float clip, int kxs, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = mlp_sampler_kernel<ROWS>;
  cudaError_t err = ldp::allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (N + ROWS - 1) / ROWS;
  kernel<<<grid, H, smem_bytes, stream>>>(s, x_init, ts, coefs, noise, w, out,
                                          N, S, A, T, half, C0, C1, H,
                                          n_blocks, clip, kxs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: 64 or 32 rows per block; H must be a multiple of 32 in [32, 256];
// noise may be null (DDIM). Returns a cudaError_t.
extern "C" int ldp_mlp_sampler(const float* s, const float* x_init,
                               const int* ts, const float* coefs,
                               const float* noise, const float* w, float* out,
                               int N, int S, int A, int T, int half, int C0,
                               int C1, int H, int n_blocks, float clip,
                               int rows, int kxs, int smem_bytes,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (rows == 64)
    return launch<64>(s, x_init, ts, coefs, noise, w, out, N, S, A, T, half,
                      C0, C1, H, n_blocks, clip, kxs, smem_bytes, st);
  if (rows == 32)
    return launch<32>(s, x_init, ts, coefs, noise, w, out, N, S, A, T, half,
                      C0, C1, H, n_blocks, clip, kxs, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
