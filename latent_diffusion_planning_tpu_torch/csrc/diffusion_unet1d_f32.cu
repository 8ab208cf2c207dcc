// Kernel B with fp32 weights: the JAX kernel's dtype=float32
// (latent_diffusion_planning_tpu/ops/pallas/diffusion_unet1d.py,
// fused_unet1d_ddim_sample -> _kernel with dtype float32), which every
// agent's `fused_dtype: float32` reaches. The same program and prologue as
// the bf16 instances (diffusion_unet1d.cu has the program; the code is
// unet1d.cuh), with fp32 weights in 16 KB tiles, fp32 operand buffers, and
// every product as error-compensated TF32 on the tensor cores (hi*hi + hi*lo
// + lo*hi, m16n8k8, a tile's products summed from zero and added on the CUDA
// cores), which keeps the result about fp32-accurate (1e-3 after 100 DDPM
// steps, 2e-4 after 10 DDIM steps against the fp32 twin).
//
// What bounds it on H100: by its operations three TF32 passes over the
// U-Net's products; in practice each warp's chains of mma.sync TF32
// products on the few rows a block holds (the math alone is three
// quarters of a call at the default widths). The default widths
// [256,512,1024] hold 244 MB of fp32 weights, five times the 50 MB L2, and a
// block reads all of them every step. The bf16 design, which this instance
// first took over, held one sample a block at these widths (256 blocks, two
// waves on 132 SMs), put a block-wide barrier on every 16 KB stage, and gave
// the deepest level (83% of the tiles) 4 real rows of each 16-row mma tile;
// it took 2.6x its fp32 twin. tools/probe_unet_kernel.py --fp32 split that
// time: the math alone 76%, the stream alone 26%, the barriers 11-13%. The
// design:
//  * Two samples a block at T 16, in one wave of 128 blocks: the wide mode
//    keeps the fp32 buffers and the skips in a per-block slice of the global
//    scratch (the operand buffers stay in shared memory where they fit), so
//    shared memory holds the ring, the operands and the current samples.
//    The wrapper (ops/kernels/diffusion_unet1d.py, choose_tile) picks the
//    tile and mode by waves of blocks on the card's SMs times a block's
//    work, then by bytes streamed.
//  * The stream is each thread's own (SliceTiles, unet1d.cuh): a warp's
//    GEMM reads a fixed 1 KB of each tile and each lane 32 bytes of it, so
//    each thread copies those bytes with cp.async into a ring of up to 8
//    tiles, waits on its own copies and refills the slot it read. No
//    barrier of any kind a stage; alone it streams the default planner's
//    3.1 TB in about 0.3 s on an H100 at 700 W, where the block-wide ring
//    took 0.8 s for 6.25 TB.
//    (Sharing one stream across a thread-block cluster with TMA multicast
//    was measured and dropped: one producer thread a cluster fed the ring at
//    a third of this rate, and two blocks sharing the bytes saved no time.)
//  * The wide instance's GEMM splits each tile's K between the warps w and
//    w + 8, each taking 16 columns, so one split of an A fragment feeds two
//    n8 column blocks; a pair adds its halves through the scratch at each
//    128-column group's end. For at most 8 rows it runs transposed (out^T =
//    W^T A^T: the weight fragments as they are packed are the A operand),
//    so the deepest level's 8 rows fill the mma's 8 columns instead of half
//    of its 16 rows.
//  * The packed tiles give each lane's K slots of a k8 step four
//    consecutive channels (ops/kernels/diffusion_unet1d.py,
//    tile_matrix_f32), so an activation row's fragment for a 16-channel
//    half is one 16-byte load.
//  * Cheaper error compensation: lo = x - hi unrounded (the tensor core
//    drops its low bits), and rows 8-15 of a row tile that lie past the
//    block's rows are neither read nor split.
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
