// Fused reverse process of ConditionalUnet1D on the tensor cores, strided
// DDIM (eta = 0) or ancestral DDPM with per-step noise: bf16 weights and
// bf16 activation operands, fp32 accumulation, fp32 GroupNorm / Mish / FiLM
// / step update. The implementation is unet1d.cuh, templated on the weight
// type; this file builds its bf16 instances, diffusion_unet1d_f32.cu its
// fp32 ones (the JAX kernel's dtype=float32, products as 3xTF32).
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
//    the two. The condition half walks the condition in chunks of 256
//    channels (the stream holds its weights chunk by chunk), so a condition
//    of any width runs 64 samples a prologue block.
//
// The net arrives as a program of 12-int records (build_program) over the
// packed buffer, so any down_dims / n_groups / embedding width runs through
// the same kernel.
//
// Wide mode (d.wide): a net that does not downsample keeps every level at
// the full length, so at 16 rows LDP-hier's default planner [256,512,1024]
// needs 16 x 1032 floats for each of the two fp32 buffers, 2 x 16 x 2056
// bf16 for the operand buffers of its 2048-wide concat and 16 x 1552 bf16
// of skips: 362 KB, more than a block's 227 KB. Wide mode keeps the fp32
// buffers and the skips in a per-block slice of a global scratch
// instead (d.scratch_bytes a block, 182 KB there) and the rest of the
// program is unchanged: the GEMM epilogue, GroupNorm / Mish, the residual,
// SAVE and CONCAT read and write them through generic pointers, and
// __syncthreads orders global writes within the block as it does shared
// ones. The slice is written and read back by one block between two
// barriers, so it stays in L2 (a resident block's slice is 182 KB; 132 of
// them 24 MB); beside the 84 MB of weights the block streams a step it is
// small. The wrapper takes wide mode only where no tile fits shared memory
// whole, so every other net keeps its tiles, for up to 32 rows a block, or
// one sample of up to 256 rows (instances of 2, 4, 8 and 16 row tiles).
// Where even the operand buffers outgrow a block beside the ring (a
// [1024,2048,4096] planner at 32 rows), d.wide is 2: they move to the
// scratch too, and since ldmatrix reads shared memory only, the GEMM reads
// its input through a window of channels that every input row has copied
// into shared memory, between two barriers: the whole input where it fits
// beside a ring of four stages (copied once a GEMM), else as many 32-channel
// runs as fit (copied again when a run of tiles reaches past it).
#include "unet1d.cuh"

// Returns a cudaError_t. `dims` is kNDims host ints in the order of Dims
// (the Python wrapper computes them from the same layout). noise is
// (n_steps x B x T x D) fp32, or null for DDIM. film_t (n_steps x
// film_ld), film_g (B rounded up to 64 rows x film_ld) and, in wide mode,
// `scratch` (grid x scratch_bytes; null otherwise) are scratch.
extern "C" int ldp_unet1d_sampler(const float* gcond, const float* x_init,
                                  const int* ts, const float* coefs,
                                  const float* noise, const void* w,
                                  const int* prog, float* film_t,
                                  float* film_g, void* scratch, float* out,
                                  const int* dims, int n_dims, float clip,
                                  void* stream) {
  return unet1d_sample<bf16>(gcond, x_init, ts, coefs, noise, w, prog, film_t,
                             film_g, scratch, out, dims, n_dims, clip, stream);
}
