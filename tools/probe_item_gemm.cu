// One GEMM of kernel B's fp16 grid mode, alone: conv2 of the default LDP
// planner's deepest level (1024 channels in and out, 5 taps, 1024 rows:
// 256 plans of 4), split as the grid mode splits it into 128 items of 64
// rows by 128 columns, one a block. Each block copies its item's input rows
// (64 + 4 halo rows of 1024 channels) into shared memory once and streams
// its column group's weight stripe (128 columns x 5120) through a ring of
// cp.async stages, 64 of K a stage, each stage's rows in the 128-byte
// swizzle (row n's 16-byte chunk c at (c ^ (n & 7)) * 16). Two ways to
// multiply, on the same data path:
//  * mma:   mma.sync m16n8k16, 8 warps of 64 rows x 16 columns, A and B
//           fragments by ldmatrix (the grid mode's way);
//  * wgmma: wgmma m64n64k16, 2 warpgroups of 64 rows x 64 columns, A from
//           registers (ldmatrix, as above), B read from the ring by a
//           shared-memory descriptor.
// fp32 accumulators; the output (1024 x 1024 fp32) written once.
//
// Build: nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared
//        -Xcompiler -fPIC -o lib.so probe_item_gemm.cu
// (tools/probe_item_gemm_torch.py builds it and runs both).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64, kCols = 128, kCin = 1024, kTaps = 5;
constexpr int kK = kTaps * kCin;                  // 5120
constexpr int kN = 1024;                          // output channels
constexpr int kChunk = 64;                        // K a stage
constexpr int kChunks = kK / kChunk;              // 80
constexpr int kStages = 4;
constexpr int kLdw = kCin + 8;                    // window row (halves)
constexpr int kWinRows = kRows + kTaps - 1;
constexpr int kWinBytes = kWinRows * kLdw * 2;
constexpr int kStageBytes = kCols * kChunk * 2;   // 16 KB
constexpr int kThreads = 256;
constexpr int kSmem = 1024 + kStages * kStageBytes + kWinBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// chunk j of the stripe (tap j / 16, channels 64 (j % 16) on) into a stage
__device__ __forceinline__ void load_stage(uint32_t stage, const __half* W,
                                           int n0, int j) {
  const int k0 = j * kChunk;
  for (int i = threadIdx.x; i < kCols * 8; i += kThreads) {
    const int n = i >> 3, c = i & 7;
    cp16(stage + n * 128 + ((c ^ (n & 7)) << 4),
         W + static_cast<size_t>(n0 + n) * kK + k0 + c * 8);
  }
}

// A fragments of rows [r0, r0 + 16) + tap at channels c0 .. c0 + 16
__device__ __forceinline__ void load_a(uint32_t win, int r0, int c0,
                                       uint32_t* a) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + (lane & 15), col = c0 + ((lane >> 4) << 3);
  ldsm4(win + (row * kLdw + col) * 2, a);
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8 rows
// (1024 bytes) between one core matrix and the next along N
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma6464(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// kWgmma: the way to multiply. X: (16, 68, 1024) fp16, each row tile's
// input rows with their halo; W: (1024, 5120) fp16, K-major; out: (1024,
// 1024) fp32.
template <bool kWgmma>
__global__ void __launch_bounds__(kThreads, 1)
    item_gemm(const __half* __restrict__ X, const __half* __restrict__ W,
              float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = base, win = base + kStages * kStageBytes;
  const int cg = blockIdx.x % (kN / kCols), rt = blockIdx.x / (kN / kCols);
  const int n0 = cg * kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __half* x = X + static_cast<size_t>(rt) * kWinRows * kCin;
  for (int i = threadIdx.x; i < kWinRows * (kCin / 8); i += kThreads) {
    const int r = i / (kCin / 8), q = i % (kCin / 8);
    cp16(win + (r * kLdw + q * 8) * 2, x + r * kCin + q * 8);
  }
  commit();
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(ring + s * kStageBytes, W, n0, s);
    commit();
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int j = 0; j < kChunks; ++j) {
    wait_pending<kStages - 2>();
    __syncthreads();   // chunk j landed; chunk j - 1's stage is free
    if (j + kStages - 1 < kChunks)
      load_stage(ring + ((j + kStages - 1) % kStages) * kStageBytes, W, n0,
                 j + kStages - 1);
    commit();
    const uint32_t stage = ring + (j % kStages) * kStageBytes;
    const int tap = j / (kCin / kChunk), c0 = (j % (kCin / kChunk)) * kChunk;
    if constexpr (kWgmma) {
      const int g = warp >> 2, wi = warp & 3;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_a(win, wi * 16 + tap, c0 + kk * 16, a[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma6464(acc, a[kk], desc128(stage + g * 64 * 128 + kk * 32));
      wgmma_commit();
      wgmma_wait0();
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4][4], b[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          load_a(win, m * 16 + tap, c0 + kk * 16, a[m]);
        const int n = warp * 16 + ((lane >> 4) << 3) + (lane & 7);
        const int c = kk * 2 + ((lane >> 3) & 1);
        ldsm4(stage + n * 128 + ((c ^ (n & 7)) << 4), b);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma16816(acc + (m * 2 + 0) * 4, a[m], b[0], b[1]);
          mma16816(acc + (m * 2 + 1) * 4, a[m], b[2], b[3]);
        }
      }
    }
  }
  float* o = out + static_cast<size_t>(rt * kRows) * kN + n0;
  const int r = lane >> 2, c = (lane & 3) * 2;
  if constexpr (kWgmma) {
    const int g = warp >> 2, wi = warp & 3;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float* p = o + (wi * 16 + r) * kN + g * 64 + nb * 8 + c;
      p[0] = acc[4 * nb];
      p[1] = acc[4 * nb + 1];
      p[8 * kN] = acc[4 * nb + 2];
      p[8 * kN + 1] = acc[4 * nb + 3];
    }
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const float* d = acc + (m * 2 + nb) * 4;
        float* p = o + (m * 16 + r) * kN + warp * 16 + nb * 8 + c;
        p[0] = d[0];
        p[1] = d[1];
        p[8 * kN] = d[2];
        p[8 * kN + 1] = d[3];
      }
  }
}

template <bool kWgmma>
int launch(const void* X, const void* W, float* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      item_gemm<kWgmma>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  item_gemm<kWgmma><<<(kN / kCols) * (1024 / kRows), kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(X), static_cast<const __half*>(W), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_item_gemm_mma(const void* X, const void* W, float* out,
                                   void* stream) {
  return launch<false>(X, W, out, stream);
}

extern "C" int probe_item_gemm_wgmma(const void* X, const void* W,
                                     float* out, void* stream) {
  return launch<true>(X, W, out, stream);
}
