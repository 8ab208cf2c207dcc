// Small device helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ldp {

constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// softplus as jax.nn.softplus computes it: max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float mishf(float x) {
  return x * tanhf(softplusf(x));
}

__device__ __forceinline__ float swishf(float x) {
  return x / (1.f + expf(-x));
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace ldp
