// Kernel B with fp32 weights: the JAX kernel's dtype=float32
// (latent_diffusion_planning_tpu/ops/pallas/diffusion_unet1d.py,
// fused_unet1d_ddim_sample -> _kernel with dtype float32), which every
// agent's `fused_dtype: float32` reaches. The same program, ring and
// prologue as the bf16 instances (diffusion_unet1d.cu has the design; the
// code is unet1d.cuh), with fp32 weights streamed in 16 KB tiles (one a ring
// stage), fp32 operand buffers, and every product as error-compensated TF32
// on the tensor cores (hi*hi + hi*lo + lo*hi, m16n8k8, a tile's products
// summed from zero and added on the CUDA cores), which keeps the result
// about fp32-accurate (1e-3 after 100 DDPM steps, 2e-4 after 10 DDIM steps
// against the fp32 twin).
//
// What bounds it on H100: three TF32 passes over the U-Net's products, and
// twice the bf16 instances' weight stream. Operands double, so tiles hold
// fewer samples; in wide mode the operand buffers join the fp32 buffers and
// the skips in the per-block global scratch (plain loads read them, so they
// need not be in shared memory as ldmatrix's are).
#include "unet1d.cuh"

// As ldp_unet1d_sampler, with `w` the fp32 packing.
extern "C" int ldp_unet1d_sampler_f32(const float* gcond, const float* x_init,
                                      const int* ts, const float* coefs,
                                      const float* noise, const void* w,
                                      const int* prog, float* film_t,
                                      float* film_g, void* scratch,
                                      float* out, const int* dims, int n_dims,
                                      float clip, void* stream) {
  return unet1d_sample<float>(gcond, x_init, ts, coefs, noise, w, prog,
                              film_t, film_g, scratch, out, dims, n_dims, clip,
                              stream);
}
