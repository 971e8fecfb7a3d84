// Probe of the e4m3 tensor cores' sums (not part of the port): C = A @ Bt^T
// over e4m3 bytes with wgmma.mma_async.m64n128k32.f32.e4m3.e4m3, the
// tensor-core sum folded into an f32 register accumulator after every
// `fold_every` k32 instructions (1: after each one). One warpgroup a 64 x
// 128 tile; A (M, K) and Bt (N, K) row-major e4m3 bytes, staged 128 k at a
// time into shared memory in the 128-byte swizzle; C (M, N) f32. M must be
// a multiple of 64, N of 128, K of 128. scripts/probe_e4m3_wgmma.py builds
// and runs it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k32(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      " %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23,\n"
      " %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39,\n"
      " %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55,\n"
      " %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(128)
    probe_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                 float* __restrict__ c, int M, int N, int K, int fold_every) {
  __shared__ __align__(1024) uint8_t sa[64 * 128];
  __shared__ __align__(1024) uint8_t sb[128 * 128];
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * 64;
  const int n0 = blockIdx.x * 128;
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
  int pieces = 0;
  for (int k0 = 0; k0 < K; k0 += 128) {
    // 16-byte chunks to their swizzled places: chunk c of row r at
    // r * 128 + ((c ^ (r % 8)) * 16)
    for (int q = t; q < 64 * 8; q += 128) {
      const int r = q / 8, ch = q % 8;
      *reinterpret_cast<uint4*>(sa + r * 128 + ((ch ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K + k0 +
                                          ch * 16);
    }
    for (int q = t; q < 128 * 8; q += 128) {
      const int r = q / 8, ch = q % 8;
      *reinterpret_cast<uint4*>(sb + r * 128 + ((ch ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(bt + (size_t)(n0 + r) * K + k0 +
                                          ch * 16);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const uint32_t a_base = static_cast<uint32_t>(__cvta_generic_to_shared(sa));
    const uint32_t b_base = static_cast<uint32_t>(__cvta_generic_to_shared(sb));
    for (int j = 0; j < 4; ++j) {
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_m64n128k32(d, smem_desc(a_base + 32 * j),
                       smem_desc(b_base + 32 * j), pieces);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(d);
      if (++pieces == fold_every) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
        pieces = 0;
      }
    }
    __syncthreads();
  }
  if (pieces > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  }
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int g = 0; g < 16; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + warp * 16 + lane / 4 + 8 * h;
      const int col = n0 + 8 * g + 2 * (lane % 4);
      c[(size_t)r * N + col] = acc[4 * g + 2 * h];
      c[(size_t)r * N + col + 1] = acc[4 * g + 2 * h + 1];
    }
}

}  // namespace

extern "C" int probe_e4m3_wgmma(const void* a, const void* bt, void* c,
                                int M, int N, int K, int fold_every,
                                void* stream) {
  if (M % 64 || N % 128 || K % 128 || fold_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<<<dim3(N / 128, M / 64), 128, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
      static_cast<float*>(c), M, N, K, fold_every);
  return static_cast<int>(cudaGetLastError());
}
