// Tensor-core and asynchronous-copy building blocks shared by the sampler
// kernels: cp.async, ldmatrix and mma.sync wrappers, and WeightRing, a
// multi-stage shared-memory ring that streams a packed weight buffer.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ldp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (0..6) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Four 8x8 bf16 matrices; lane l supplies the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16, row) * b (16x8, col), fp16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) * b (8x8, col), tf32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b (no addend: the accumulator starts from zero).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// fp32 -> tf32, round to nearest (ties away), as a 32-bit pattern.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A ring of `stages` (2..8) stages of STAGE_BYTES in shared memory, fed with 16-byte
// cp.async copies from one contiguous, 16-byte-aligned global stream. The
// stream is `cycle` stages long and is delivered `total` stages in all
// (total > cycle wraps around: the same weights again for the next step).
// Every thread of the block calls start() once and then enter() in lockstep;
// enter() waits for the oldest stage, and, behind the barrier that proves
// the stage before it is no longer read, refills that slot with the stage
// stages - 1 ahead. So the copies run ahead of the consumer across whatever
// the block does between two GEMMs.
template <int STAGE_BYTES>
struct WeightRing {
  const char* src;
  char* buf;
  int stages, cycle, left;     // left: stages still to fill
  int src_stage, fill_slot;    // where the next fill reads and writes
  int slot;                    // the slot the next enter() hands out

  __device__ void fill() {
    if (left > 0) {
      const char* s = src + static_cast<size_t>(src_stage) * STAGE_BYTES;
      const uint32_t d = smem_u32(buf + fill_slot * STAGE_BYTES);
#pragma unroll 4
      for (int i = threadIdx.x * 16; i < STAGE_BYTES; i += blockDim.x * 16)
        cp_async16(d + i, s + i);
      --left;
      if (++src_stage == cycle) src_stage = 0;
    }
    if (++fill_slot == stages) fill_slot = 0;
    cp_async_commit();
  }

  __device__ void start(const void* stream, void* ring, int ring_stages,
                        int cycle_stages, int total_stages) {
    src = static_cast<const char*>(stream);
    buf = static_cast<char*>(ring);
    stages = ring_stages;
    cycle = cycle_stages;
    left = total_stages;
    src_stage = fill_slot = slot = 0;
    for (int n = 0; n < stages - 1; ++n) fill();
  }

  // The next stage, landed and visible to every thread.
  __device__ const char* enter() {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    fill();
    const char* p = buf + slot * STAGE_BYTES;
    if (++slot == stages) slot = 0;
    return p;
  }

  __device__ void drain() { cp_async_wait<0>(); }
};

}  // namespace ldp
