// Hopper pieces of the tensor-core flash kernels (the forward's body
// flash_fwd_sm90.cuh, instantiated by flash_fwd_bf16.cu and
// flash_fwd_f32.cu; flash_dq_bf16.cu, flash_dkv_bf16.cu at bf16;
// flash_dq_f32.cu, flash_dkv_f32.cu at f32): the tile layout in shared
// memory and its wgmma descriptors, the m64 bf16 products, the exact split
// of an f32 fragment into bf16 A operands and its product folded into a
// running sum, the f32 tiles split into bf16 triples on both sides of a
// product, and the keep bits of a thread's accumulator elements.
//
// Tiles. Every bf16 operand tile is 64 rows x D bf16 of a row-major (rows,
// D) tensor (q, k, v, dO), loaded by TMA (gemm_sm90.cuh) in the swizzle
// whose span is one row of the tile: R = 2D bytes for D = 16 (32-byte
// swizzle) and D = 32 (64-byte), R = 128 bytes for D >= 64, where a D = 128
// tile is two boxes of 64 columns, the second 64 R bytes after the first.
// The same tile serves as a K-major operand (its rows are M or N, D is k: Q
// K^T, dO V^T, K Q^T, V dO^T) and as an MN-major B (its rows are k, D is
// n, read through the transpose bit: P V, dS K, P_drop^T dO, dS^T Q).
//
// Fragments (the PTX ISA's wgmma layouts). Thread t of the warpgroup (warp
// w = t / 32, lane l, c = l % 4) holds in an m64nN f32 accumulator d the
// rows 16 w + l / 4 (hh = 0) and + 8 (hh = 1) at columns 8 g + 2 c + e
// (e = 0, 1): d[4 g + 2 hh + e]. The A operand of an m64k16 product from
// registers holds, in four 32-bit words of two bf16, rows (16 w + l / 4,
// + 8) x k (2 c, 2 c + 1, + 8): slice j (k = 16 j ..) of a 64 x 64
// accumulator is words (d[8j], d[8j+1]), (d[8j+2], d[8j+3]), (d[8j+4],
// d[8j+5]), (d[8j+6], d[8j+7]) -- a score fragment feeds the next product
// without leaving the registers.
//
// The f32 operands (P in the forward, dS in dq, P_drop and dS in dkv)
// enter as an exact triple: hi = bf16_rn(x), mid = bf16_rn(x - hi), lo =
// bf16_rn(x - hi - mid). Each difference is exact in f32 and the three
// carry all 24 bits of x's significand (x = hi + mid + lo for |x| >=
// 2^-110), so three bf16 products into one f32 accumulator are the JAX
// kernels' f32-operand product up to the order of the f32 sums. Each
// block's second product is a product of its own, folded into the running
// O, dq, dK or dV by f32 adds as the JAX kernels fold their blocks.
// Measured against the plain version at 2 x 32 x 2048 x 128 on the H100,
// the share of O's bf16 roundings that differ: a pair hi + lo (16 bits,
// within 2^-17 of x) chained over all blocks inside the tensor core
// 0.19 %, the triple chained 0.19 % (the tensor core's own accumulation
// over 384 steps), the triple folded block by block 0.05 %, the f32 SIMT
// kernel it replaces 0.03 %. The backward's Delta = rowsum(dO o O)
// carries those into dq and dk. P rounded once to bf16 (2^-9) would be
// another function.
//
// Both sides f32 (the f32 kernels: Q, K, V and dO as well as P, dS and
// P_drop). Each side is split into its exact triple and the product a b
// is the sum of the six part products whose parts reach 2^-16 of it --
// lo.hi, mid.mid, hi.lo, then mid.hi, hi.mid, then hi.hi, the smallest
// first. The three left out (mid.lo, lo.mid, lo.lo) are each within 2^-24
// of |a||b|, so the sum is the f32 product up to about 2^-23 of
// sum |a||b| and the order of the f32 sums. The f32 tiles come by TMA as
// plain rows into a staging tile and are split by the threads into three
// bf16 tiles in the layout above (split_tile): the tiles a CTA keeps for
// its whole walk (Q in the forward, Q and dO in dq, K and V in dkv) once,
// the ones it walks over block by block. Every product then reads bf16
// parts from shared memory (score6: both sides K-major; add_product6: the
// fragment's parts from registers, the tile's MN-major).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "flash_common.cuh"
#include "gemm_sm90.cuh"
#include "philox.cuh"

namespace repro_flash {
namespace tc {

using namespace repro_gemm::sm90;

constexpr int WG = 128;  // one warpgroup a CTA

// bytes of one tile row in the swizzle (the swizzle span) and of a tile
template <int D>
__host__ __device__ constexpr int row_bytes() {
  return D >= 64 ? 128 : 2 * D;
}
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}

template <int D>
constexpr CUtensorMapSwizzle tma_swizzle() {
  return row_bytes<D>() == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes<D>() == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_32B;
}

// a descriptor's layout type (bits 62-63): 1 = 128-, 2 = 64-, 3 = 32-byte
template <int D>
__host__ __device__ constexpr uint64_t desc_layout() {
  return row_bytes<D>() == 128 ? 1ull : row_bytes<D>() == 64 ? 2ull : 3ull;
}

// K-major descriptor of slice j (k = 16 j .. 16 j + 15) of the 64-row tile
// at `tile`: the slice's 32 bytes of each row, 8-row groups 8 R apart
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int j) {
  constexpr int R = row_bytes<D>();
  constexpr int per_row = R / 32;
  const uint32_t addr = tile + (j / per_row) * (64 * R) + (j % per_row) * 32;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * R) >> 4) << 32) |
         (desc_layout<D>() << 62);
}

// MN-major descriptor of rows 16 j .. 16 j + 15 of the tile as B (16 k x D
// n, the transpose bit): 8 k rows 8 R apart (the stride offset), the next
// 64 n one box (64 R bytes) on (the leading offset, read at D = 128)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int j) {
  constexpr int R = row_bytes<D>();
  const uint32_t addr = tile + j * 16 * R;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((64 * R) >> 4) << 16) |
         (static_cast<uint64_t>((8 * R) >> 4) << 32) |
         (desc_layout<D>() << 62);
}

// the 64-row tile starting at `row` of the map into shared memory at `dst`
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row) {
#pragma unroll
  for (int c = 0; c < (D + 63) / 64; ++c)
    tma_load<false>(dst + c * 64 * row_bytes<D>(), map, bar, 64 * c, row, 0);
}

// mbar_wait (gemm_sm90.cuh) that traps -- a launch error, not a hung card
// -- when the phase has not completed after 2^31 clocks (about a second):
// a TMA load that never lands.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 31)) __trap();
  } while (!done);
}

// mbar_wait_or_trap with the polling loop inside the asm, as
// gemm_sm90.cuh's mbar_wait: the compiler sees no divergent branch where
// it runs between wgmma products in flight (one it must guard serializes
// them). Traps after 2^32 clocks without the phase.
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar,
                                               uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t, %%clock64;\n"
      "sub.u64 t, t, t0;\n"
      "setp.gt.u64 p, t, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// named barrier `id` (1-15; __syncthreads is 0) of `threads` threads:
// wait for them, or count this thread's warp in without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_wait2() {
  asm volatile("wgmma.wait_group.sync.aligned 2;" ::: "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends on 16 bytes)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The map of a row-major (rows, D) bf16 tensor in 64-row tiles; false when
// cuTensorMapEncodeTiled refuses it.
template <int D>
bool make_tile_map(CUtensorMap* map, const void* ptr, int rows) {
  return make_map<false>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, 1,
                         rows, D, D, D < 64 ? D : 64, 64, tma_swizzle<D>());
}

// pins registers at this point of the program, so reads of a wgmma result
// are not moved above the wait that completes it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the A operands of RS products (a_frags' triple, or any such
// array) in their registers up to this point of the program: the products
// in flight read them
template <int I, int J, int K>
__device__ __forceinline__ void hold(const uint32_t (&a)[I][J][K]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) asm volatile("" ::"r"(a[i][j][k]));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// (x, y) -> the bf16 pairs hi = (bf16(x), bf16(y)), mid = (bf16(x - hi),
// ...) and lo = (bf16(x - hi - mid), ...), each as one A-operand word
// (first element low); x = hi + mid + lo exactly
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(h), ry = y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const __nv_bfloat162 r = __floats2bfloat162_rn(rx - __low2float(m),
                                                 ry - __high2float(m));
  memcpy(&hi, &h, 4);
  memcpy(&mid, &m, 4);
  memcpy(&lo, &r, 4);
}

// The four k16 slices of a 64 x 64 f32 fragment as A operands: a[i][j] is
// part i (hi, mid, lo) of slice j.
__device__ __forceinline__ void a_frags(const float (&p)[32],
                                        uint32_t (&a)[3][4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      split3(p[8 * j + 2 * t], p[8 * j + 2 * t + 1], a[0][j][t], a[1][j][t],
             a[2][j][t]);
}

// ---------------------------------------------------------------- products

// d (+)= A * B, m64nNk16 with A (64 x 16 bf16) from registers and B (16 x
// N bf16) MN-major in shared memory (the transpose bit), f32 sums; d is
// replaced when `accumulate` is 0
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate);

// d (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major):
// bf16 operands, f32 sums; d is replaced when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, shared, K-major) * B (16 x 32, shared, K-major): bf16
// operands, f32 sums; d is replaced when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// columns of one product chunk: a D = 128 product in two halves, so the
// chunk's accumulator (NC / 2 floats a thread) fits beside dK and dV (or
// dq and the score fragments)
template <int D>
__host__ __device__ constexpr int chunk_cols() {
  return D < 64 ? D : 64;
}

// acc (64 x D, the fragment of dq, dK or dV) += A B for A = the three
// parts of a 64 x 64 fragment (a[part][slice]) and B the 64-row tile at
// `b`, read MN-major: each NC-column chunk a fresh product, then one f32
// add -- a block's product folded in as the JAX kernels fold their blocks.
// The chunk's products run slice by slice (hi, mid, lo of slice 0, then
// of slice 1, ...) or, with SMALL_FIRST, part by part from the smallest
// (lo of every slice, then mid, then hi)
template <int D, bool SMALL_FIRST = false>
__device__ __forceinline__ void add_product(float (&acc)[D / 2],
                                            const uint32_t (&a)[3][4][4],
                                            uint32_t b) {
  constexpr int NC = chunk_cols<D>();
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += NC) {
    float part[NC / 2];  // replaced by the first product
    const uint32_t bc = b + (c0 / 64) * 64 * row_bytes<D>();
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < 12; ++n) {
      const int i = SMALL_FIRST ? 2 - n / 4 : n % 3;
      const int j = SMALL_FIRST ? n % 4 : n / 3;
      wgmma_rs<NC>(part, a[i][j], desc_mn<D>(bc, j), n);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(part);
#pragma unroll
    for (int t = 0; t < NC / 2; ++t) acc[c0 / 2 + t] += part[t];
  }
}

// -------------------------------------------- f32 operands on both sides

// bytes of a 64 x D f32 tile
template <int D>
__host__ __device__ constexpr int tile_bytes32() {
  return 64 * D * 4;
}

// the swizzle of a span of R bytes (128, 64 or 32) as TMA writes it: the
// 16-byte chunk bits of a tile offset xor the bits of its 128-byte line
template <int R>
__host__ __device__ constexpr uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (R / 16 - 1)) << 4);
}

// The map of a row-major (rows, D) f32 tensor in 64-row tiles of plain
// rows, one box a tile; false when cuTensorMapEncodeTiled refuses it.
template <int D>
bool make_tile_map32(CUtensorMap* map, const void* ptr, int rows) {
  return make_map<false>(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 1,
                         rows, D, D, D, 64, CU_TENSOR_MAP_SWIZZLE_NONE);
}

__device__ __forceinline__ float ld_shared_f1(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_f1(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_u4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// x, opaque to the compiler: what is made from it is made where it is
// used, not hoisted out of the block loop or shared between calls -- the
// 96 descriptors of a score tile, or split_tile's addresses, each took a
// register for the whole walk and spilled
__device__ __forceinline__ uint64_t pinned(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The 64 x D f32 tile at `src` (plain rows, as make_tile_map32 loads it)
// as the bf16 tiles hi, mid, lo at dst, dst + TILE, dst + 2 TILE, each in
// load_tile's layout, by the first THREADS threads of the CTA: thread t
// takes 8 consecutive values of a row at a time, one 16-byte chunk of each
// part, two rows of chunks in flight (all of them spilled the dkv kernel's
// accumulators). The caller fences the async proxy before a product reads
// them.
template <int D, int THREADS = WG>
__device__ __forceinline__ void split_tile(uint32_t src, uint32_t dst) {
  constexpr int R = row_bytes<D>();
  constexpr int TILE = tile_bytes<D>();
  const int t = static_cast<int>(pinned(threadIdx.x % THREADS));
#pragma unroll 2
  for (int i = 0; i < (8 * D + THREADS - 1) / THREADS; ++i) {
    const int u = t + THREADS * i;
    if ((8 * D) % THREADS != 0 && u >= 8 * D) break;
    const int row = u / (D / 8), c8 = u % (D / 8);
    const uint32_t from = src + (row * D + 8 * c8) * 4;
    const float4 x = ld_shared_f4(from), y = ld_shared_f4(from + 16);
    uint32_t hi[4], mid[4], lo[4];
    split3(x.x, x.y, hi[0], mid[0], lo[0]);
    split3(x.z, x.w, hi[1], mid[1], lo[1]);
    split3(y.x, y.y, hi[2], mid[2], lo[2]);
    split3(y.z, y.w, hi[3], mid[3], lo[3]);
    const int byte = 16 * c8;
    const uint32_t off =
        (byte / R) * 64 * R + swizzle<R>(row * R + byte % R);
    st_shared_u4(dst + off, hi);
    st_shared_u4(dst + TILE + off, mid);
    st_shared_u4(dst + 2 * TILE + off, lo);
  }
}

// `desc` with its start address `bytes` on: the address field (bits 0-13,
// address / 16) does not carry, shared memory lying under 256 KB
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// bytes from a tile to its k16 slice j as desc_k addresses it
template <int D>
__host__ __device__ constexpr uint32_t slice_bytes(int j) {
  return (j / (row_bytes<D>() / 32)) * 64 * row_bytes<D>() +
         (j % (row_bytes<D>() / 32)) * 32;
}

// the six part products (A part, B part) that reach 2^-16, smallest first
__device__ __forceinline__ constexpr int part_a(int n) {
  return n == 0 ? 2 : n == 1 || n == 3 ? 1 : 0;
}
__device__ __forceinline__ constexpr int part_b(int n) {
  return n == 0 || n == 3 || n == 5 ? 0 : n == 1 || n == 4 ? 1 : 2;
}

// d = A B^T, a 64 x 64 score tile over k = D, for A and B the bf16 triples
// (parts TILE bytes apart) of 64-row tiles, both read K-major: the six
// part products, each over every k16 slice, the smallest first; d is
// replaced by the first. The caller fences and commits.
template <int D>
__device__ __forceinline__ void score6(float (&d)[32], uint32_t a,
                                       uint32_t b) {
  constexpr int TILE = tile_bytes<D>();
  const uint64_t da = pinned(desc_k<D>(a, 0)), db = pinned(desc_k<D>(b, 0));
#pragma unroll
  for (int n = 0; n < 6; ++n)
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss_n64(d, desc_at(da, part_a(n) * TILE + slice_bytes<D>(j)),
                   desc_at(db, part_b(n) * TILE + slice_bytes<D>(j)),
                   n > 0 || j > 0);
}

// acc (64 x D) += A B for A the triple of a 64 x 64 f32 fragment
// (a[part][slice], a_frags) and B the bf16 triple of the 64-row tile at `b`
// (parts TILE bytes apart) read MN-major: each NC-column chunk a fresh
// product of the six part products, smallest first (each over the four
// slices), then one f32 add -- add_product with both sides split. A chunk
// narrower than a 64-column box starts (c0 % 64) * 2 bytes into its swizzled
// rows, as a K-major slice starts 32 j bytes into them. `under` runs while
// the first chunk's products are in flight.
struct Nothing {
  __device__ __forceinline__ void operator()() const {}
};
template <int D, int NC = chunk_cols<D>(), class Under = Nothing>
__device__ __forceinline__ void add_product6(float (&acc)[D / 2],
                                             const uint32_t (&a)[3][4][4],
                                             uint32_t b,
                                             Under&& under = Under()) {
  constexpr int TILE = tile_bytes<D>();
  const uint64_t db = pinned(desc_mn<D>(b, 0));
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += NC) {
    float part[NC / 2];  // replaced by the first product
    const uint32_t bc = (c0 / 64) * 64 * row_bytes<D>() + (c0 % 64) * 2;
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < 24; ++n) {
      const int j = n % 4;
      wgmma_rs<NC>(part, a[part_a(n / 4)][j],
                   desc_at(db, bc + part_b(n / 4) * TILE +
                                   j * 16 * row_bytes<D>()),
                   n);
    }
    wgmma_commit();
    if (c0 == 0) under();
    wgmma_wait0();
    fence_acc(part);
#pragma unroll
    for (int t = 0; t < NC / 2; ++t) acc[c0 / 2 + t] += part[t];
  }
}

// ------------------------------------------------------------- keep bits
//
// One Philox call gives the keep bits of 4 consecutive queries 4 q4 ..
// 4 q4 + 3 at one key. A thread's 32 elements of a 64 x 64 tile lie in 8
// calls' worth of bits, but spread over more calls: each call is made once,
// by one lane, and its bits reach the lanes that hold them by shuffles (the
// 8 calls per 32 pairs that flash_bound counts). Premask reads bit q % 32 of
// word (q / 32, k) of the (b, h) plane.

// The forward's score fragment (rows = queries, columns = keys): bit idx =
// 2 g + e of kb[hh] keeps row q_start + 16 w + l / 4 + 8 hh at key k_start
// + 8 g + 2 c + e. The four lanes holding rows 4 q4 .. 4 q4 + 3 at one key
// class c each make 4 of the 16 calls of their rows' group at their 16 keys
// (for both row groups, hh = 0 and 1), then gather the other 12 nibbles.
template <int MODE>
__device__ __forceinline__ void keep_fwd(const Dropout& dp, int b, int h,
                                         int H, int SQ, int SK, int q_start,
                                         int k_start, uint32_t (&kb)[2]) {
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int row = q_start + 16 * w + l / 4;
  kb[0] = kb[1] = 0;
  if (MODE == kPremask) {
    const int32_t* words =
        dp.plane +
        (static_cast<size_t>(b) * H + h) * (SQ / 32) * SK +
        static_cast<size_t>(row / 32) * SK + k_start + 2 * c;
    const int sh = row & 31;  // row + 8 is in the same word
#pragma unroll
    for (int idx = 0; idx < 16; ++idx) {
      const uint32_t wd =
          static_cast<uint32_t>(words[8 * (idx >> 1) + (idx & 1)]) >> sh;
      kb[0] |= (wd & 1u) << idx;
      kb[1] |= ((wd >> 8) & 1u) << idx;
    }
  } else if (MODE == kCounters) {
    const uint32_t bh = repro_philox::global_bh(
        static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(H),
        dp.heads_global, dp.bh_offset);
    const int i = (l >> 2) & 3;  // this row within its group of 4
    uint32_t mine = 0;           // nibble 4 hh + j: key index 4 i + j
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = 4 * i + j;
        const uint32_t key = k_start + 8 * (idx >> 1) + 2 * c + (idx & 1);
        mine |= repro_philox::keep_nibble(
                    key, static_cast<uint32_t>((row >> 2) + 2 * hh), bh,
                    dp.salt, dp.k0, dp.k1, dp.threshold, dp.rounds)
                << (4 * (4 * hh + j));
      }
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const uint32_t v =
          __shfl_sync(0xffffffffu, mine, (l & ~12) | (src << 2));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kb[hh] |= ((v >> (4 * (4 * hh + j) + i)) & 1u) << (4 * src + j);
    }
  } else {
    kb[0] = kb[1] = 0xFFFFu;
  }
}

// dkv's transposed fragment (rows = keys, columns = queries): bit 2 g + e
// of kb[hh] keeps query q_start + 8 g + 2 c + e at key k_start + 16 w +
// l / 4 + 8 hh. Lanes c and c ^ 1 hold the same 4-query groups at the same
// two keys: the even lane makes the 8 calls of the first key, the odd lane
// those of the second, and they swap.
template <int MODE>
__device__ __forceinline__ void keep_dkv(const Dropout& dp, int b, int h,
                                         int H, int SQ, int SK, int q_start,
                                         int k_start, uint32_t (&kb)[2]) {
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int key = k_start + 16 * w + l / 4;
  kb[0] = kb[1] = 0;
  if (MODE == kPremask) {
    const int32_t* words =
        dp.plane +
        (static_cast<size_t>(b) * H + h) * (SQ / 32) * SK +
        static_cast<size_t>(q_start / 32) * SK + key;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t wd =
            static_cast<uint32_t>(words[static_cast<size_t>(half) * SK +
                                        8 * hh]);
#pragma unroll
        for (int g4 = 0; g4 < 4; ++g4)
          kb[hh] |= ((wd >> (8 * g4 + 2 * c)) & 3u) << (2 * (4 * half + g4));
      }
  } else if (MODE == kCounters) {
    const uint32_t bh = repro_philox::global_bh(
        static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(H),
        dp.heads_global, dp.bh_offset);
    const int odd = c & 1;
    uint32_t mine = 0;  // nibble g: queries 4 (q_start / 4 + 2 g + c / 2) ..
#pragma unroll
    for (int g = 0; g < 8; ++g)
      mine |= repro_philox::keep_nibble(
                  static_cast<uint32_t>(key + 8 * odd),
                  static_cast<uint32_t>(q_start / 4 + 2 * g + (c >> 1)), bh,
                  dp.salt, dp.k0, dp.k1, dp.threshold, dp.rounds)
              << (4 * g);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    const uint32_t n0 = odd ? other : mine, n1 = odd ? mine : other;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      kb[0] |= ((n0 >> (4 * g + 2 * odd)) & 3u) << (2 * g);
      kb[1] |= ((n1 >> (4 * g + 2 * odd)) & 3u) << (2 * g);
    }
  } else {
    kb[0] = kb[1] = 0xFFFFu;
  }
}

// keep_dkv's bits of the 32 queries q0 .. q0 + 31 alone (q0 a multiple of
// 32; dkv's m64n32 half): bit 2 g + e of kb[hh] keeps query q0 + 8 g + 2 c
// + e at key k_start + 16 w + l / 4 + 8 hh, g < 4; half of keep_dkv's
// calls
template <int MODE>
__device__ __forceinline__ void keep_dkv_half(const Dropout& dp, int b,
                                              int h, int H, int SQ, int SK,
                                              int q0, int k_start,
                                              uint32_t (&kb)[2]) {
  const int t = threadIdx.x % WG, w = t / 32, l = t % 32, c = l % 4;
  const int key = k_start + 16 * w + l / 4;
  kb[0] = kb[1] = 0;
  if (MODE == kPremask) {
    const int32_t* words =
        dp.plane +
        (static_cast<size_t>(b) * H + h) * (SQ / 32) * SK +
        static_cast<size_t>(q0 / 32) * SK + key;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t wd = static_cast<uint32_t>(words[8 * hh]);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        kb[hh] |= ((wd >> (8 * g + 2 * c)) & 3u) << (2 * g);
    }
  } else if (MODE == kCounters) {
    const uint32_t bh = repro_philox::global_bh(
        static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(H),
        dp.heads_global, dp.bh_offset);
    const int odd = c & 1;
    uint32_t mine = 0;  // nibble g: queries 4 (q0 / 4 + 2 g + c / 2) ..
#pragma unroll
    for (int g = 0; g < 4; ++g)
      mine |= repro_philox::keep_nibble(
                  static_cast<uint32_t>(key + 8 * odd),
                  static_cast<uint32_t>(q0 / 4 + 2 * g + (c >> 1)), bh,
                  dp.salt, dp.k0, dp.k1, dp.threshold, dp.rounds)
              << (4 * g);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    const uint32_t n0 = odd ? other : mine, n1 = odd ? mine : other;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      kb[0] |= ((n0 >> (4 * g + 2 * odd)) & 3u) << (2 * g);
      kb[1] |= ((n1 >> (4 * g + 2 * odd)) & 3u) << (2 * g);
    }
  } else {
    kb[0] = kb[1] = 0xFFu;
  }
}

}  // namespace tc
}  // namespace repro_flash
