// Kernel B with fp16 weights: the JAX kernel's dtype=float16
// (latent_diffusion_planning_tpu/ops/pallas/diffusion_unet1d.py,
// fused_unet1d_ddim_sample -> _kernel with dtype float16), which every
// agent's `fused_dtype: float16` reaches. The bf16 instances' program,
// prologue, ring of 24 KB stages, ldmatrix staging and 8 KB tiles
// (diffusion_unet1d.cu has the design; the code is unet1d.cuh), with fp16
// operands on mma.sync m16n8k16 f16 x f16 and fp32 sums.
//
// It computes the JAX kernel's function, which rounds in places the bf16
// instances do not (unet1d.cuh's note): GroupNorm's mean and variance come
// from x and x * x rounded to fp16 (E[x^2] - E[x]^2, so |x| past 256
// overflows x * x to inf there, and JAX's 0/1 broadcast matmuls turn that
// into NaN in the sample's other groups), FiLM's scale and bias and the
// downsample's output are rounded to fp16 at widths that are not a
// multiple of 128 (where the JAX kernel broadcasts or selects rows with a
// matmul), the final 1x1 conv reads the fp32 activations (the kernel adds
// the products of their fp16 remainder, v - fp16(v), in a second pass over
// the same weights from L2), and the clip keeps a NaN. The JAX kernel's
// overflow spreads further, to the other samples of its batch tile; here a
// sample's output depends on that sample alone (JAX at batch_tile=1).
//
// What bounds it on H100: as the bf16 instances, the weight stream (fp16
// tiles are the same 8 KB) and the latency of short dependent chains; the
// fp16 tensor-core rate is bf16's (989 TFLOP/s dense). At the default
// calls (256 samples) that stream is 128 blocks x 122 MB a step, from HBM:
// the grid mode (unet1d_grid.cuh) reads each tile once a step by the grid.
#include "unet1d_grid.cuh"

// As ldp_unet1d_sampler, with `w` the fp16 packing.
extern "C" int ldp_unet1d_sampler_f16(const float* gcond, const float* x_init,
                                      const int* ts, const float* coefs,
                                      const float* noise, const void* w,
                                      const int* prog, float* film_t,
                                      float* film_g, void* scratch,
                                      float* out, const int* dims, int n_dims,
                                      float clip, void* stream) {
  return unet1d_sample<f16>(gcond, x_init, ts, coefs, noise, w, prog, film_t,
                            film_g, scratch, out, dims, n_dims, clip, stream);
}

// The grid mode (unet1d_grid.cuh): every sample at once in one persistent
// launch of `gdims[0]` blocks, a grid-wide barrier between dependent
// phases. dims as above with nb = B (the program's records and buffer
// sizes for all samples); gdims: blocks, shared memory bytes, the bytes of
// it for the ring and the window, then the byte offsets in `scratch` of
// X32, Y32, Xb, Yb, the skips (fp16, then fp32), the current sample, the
// GroupNorm statistics and the barrier's two words, the GEMMs a step, and
// four numbers a GEMM (GridGemm: rows an item and a pass, ring stages,
// window bytes), in program order.
extern "C" int ldp_unet1d_sampler_f16_grid(
    const float* gcond, const float* x_init, const int* ts,
    const float* coefs, const float* noise, const void* w, const int* prog,
    float* film_t, float* film_g, void* scratch, float* out, const int* dims,
    int n_dims, const long long* gdims, int n_gdims, float clip,
    void* stream) {
  return unet1d_sample_grid(gcond, x_init, ts, coefs, noise, w, prog, film_t,
                            film_g, scratch, out, dims, n_dims, gdims,
                            n_gdims, clip, stream);
}
