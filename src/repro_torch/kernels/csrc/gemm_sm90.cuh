// Hopper building blocks of the tensor-core GEMM+RNG kernels
// (gemm_fp8.cuh: e4m3 operands multiplied as f16; gemm_tc.cuh: bf16
// operands, and f32 ones split into bf16 parts) and of the flash kernels
// (flash_sm90.cuh): shared-memory
// addresses, mbarriers, TMA tile loads and their tensor maps, wgmma matrix
// descriptors and the m64n128k16 products with f32 sums, all in inline PTX
// for sm_90a.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_gemm {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. The polling loop is
// inside the asm, so the compiler sees no divergent branch next to the
// wgmma products in flight (one it must guard serializes them).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// one box of the map at (inner, row[, expert]) into shared memory at `dst`
template <bool GROUPED>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int inner, int row,
                                         int ex) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (GROUPED) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(m), "r"(bar), "r"(inner), "r"(row), "r"(ex)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(m), "r"(bar), "r"(inner), "r"(row)
        : "memory");
  }
}

// shared-memory matrix descriptor of a K-major 16-bit tile in the 128-byte
// swizzle: rows of 128 bytes (64 k), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// shared-memory matrix descriptor of an MN-major 16-bit tile in the
// 128-byte swizzle: k rows of 64 MN elements (128 bytes), 8 k rows 1024
// bytes apart (the stride offset), the next 64 MN elements `mn_stride`
// bytes on (the leading offset) -- CUTLASS's canonical MN-major SW128
// layout ((64, n), (8, k)) : ((1, mn_stride), (64, 1024 bytes))
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr,
                                                 uint32_t mn_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(mn_stride >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// pins the registers at this point of the program, so reads of a wgmma
// result are not moved above the wait that completes it
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA_D64                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7,\n"                                      \
  " %8, %9, %10, %11, %12, %13, %14, %15,\n"                                \
  " %16, %17, %18, %19, %20, %21, %22, %23,\n"                              \
  " %24, %25, %26, %27, %28, %29, %30, %31,\n"                              \
  " %32, %33, %34, %35, %36, %37, %38, %39,\n"                              \
  " %40, %41, %42, %43, %44, %45, %46, %47,\n"                              \
  " %48, %49, %50, %51, %52, %53, %54, %55,\n"                              \
  " %56, %57, %58, %59, %60, %61, %62, %63},\n"
#define REPRO_WGMMA_OUT64(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major), f16
// operands and f32 sums; d is replaced when `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " REPRO_WGMMA_D64
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, MN-major: the
// transpose bit), bf16 operands -- every product exact -- and f32 sums; d
// is replaced when `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n128k16_bf16_bmn(float (&d)[64],
                                                          uint64_t da,
                                                          uint64_t db,
                                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_WGMMA_D64
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : REPRO_WGMMA_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef REPRO_WGMMA_D64
#undef REPRO_WGMMA_OUT64

// ------------------------------------------------------------ the host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null when the driver does not offer it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major operand (E, rows, cols) with rows `ld` elements
// apart (E = 1 and a 2-D map unless GROUPED): boxes of box_cols x box_rows
// (x 1 expert), 128-byte swizzle unless `swizzle` says otherwise, zeros past
// every edge. False when cuTensorMapEncodeTiled refuses it (a row stride
// off 16 bytes, a box wider than the swizzle).
template <bool GROUPED>
bool make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes,
              const void* ptr, int E, int rows, int cols, int ld,
              int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(ld) * elem_bytes;
  const cuuint64_t strides[2] = {row_bytes,
                                 static_cast<cuuint64_t>(rows) * row_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, dtype, GROUPED ? 3 : 2, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace repro_gemm
