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

// mish(x) = x tanh(softplus(x)) = x u / (u + 2) with u = e^x (e^x + 2): one
// exponential and one division, every term positive (no cancellation).
__device__ __forceinline__ float mishf(float x) {
  if (x > 20.f) return x;
  const float w = expf(x);
  const float u = w * (w + 2.f);
  return x * (u / (u + 2.f));
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
