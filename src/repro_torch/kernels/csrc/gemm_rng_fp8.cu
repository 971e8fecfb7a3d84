// Per-tile-scaled e4m3 GEMM + dropout RNG: C ~= A @ B from e4m3 operands
// with one f32 scale per operand tile, and the packed keep plane of one
// attention layer emitted by the same kernel, under the product.
//
// Replaces the TPU kernels src/repro/kernels/gemm_rng.py::
// _gemm_rng_fp8_kernel (gemm_rng.py:373, pl.pallas_call at :476) and, with
// the emission off (mask == nullptr), gemm_rng.py::_plain_fp8_kernel
// (:933, pallas_call at :959) -- the Region-3 fp8 host, whose mask the
// standalone Philox kernel makes instead. The emission is a run-time
// switch, as in gemm_rng.cu.
//
// What it computes. A (M, K) and B (K, N) are row-major e4m3fn bytes; a_s
// (M/bm, K/bk) and b_s (K/bk, N/bn) are row-major f32 scales, one per
// (bm, bk) tile of A and (bk, bn) tile of B -- the JAX logical GEMM blocks
// of producer.pick_gemm_blocks, which quant.quantize_tiled scaled by. C
// (M, N) is row-major f32: for each k-block kb of bk columns, a partial
// sum p = sum over the block of a[i,k] * b[k,j] (e4m3 decoded exactly to
// f32, each product exact in f32), then C += p * (a_s[i/bm][kb] *
// b_s[kb][j/bn]) -- JAX's order of rounding, not dequantize-then-multiply.
// The scale tiles are JAX's, not the CTA's: bm and bn may be smaller than
// the 128 x 128 CTA tile or cut across it, so every accumulator row and
// column reads its own scale. bk is a multiple of 8, so k-blocks end on the
// 8-deep k-slices of the tiling. The plane's blocks are those of the JAX
// emission layout, written as gemm_emit.cuh describes: bitwise the f32
// host's (gemm_rng.cu) for the same counters.
//
// What bounds it on an H100. For the bound of the function: e4m3 tensor
// cores (1,979 TFLOP/s dense) make the QKV product of a llama2-7b training
// step at B=2, S=2048 (4096 x 12288 x 4096, 412 GFLOP) 0.21 ms, and its
// plane's Philox (8.4 M words of 8 calls each) about 0.07 ms at the issue
// rate, against 0.30 GB of operands, scales, result and plane (0.09 ms at
// 3.35 TB/s): operations. This first kernel is the SIMT tiling of
// gemm_fp8.cuh (shared with the grouped host, gemm_rng_grouped_fp8.cu),
// launched with one expert: f32 FMAs on decoded e4m3, 173 registers, so
// one 256-thread CTA an SM; it runs at about 19 TFLOP/s
// (22 ms at that shape), so the plane's RNG is about 1 % of its time.
// Using the tensor cores (mma.sync m16n8k32 e4m3 -> f32 from sm_89, or
// wgmma) is what would make the RNG a third of the product, and would
// change the order of rounding inside a k-block; that is later work.
#include <cstdint>

#include "gemm_fp8.cuh"

// C = dequantized A @ B as described above, and, when `mask` is not null,
// the layout's blocks of the packed keep plane. (bm, bk) and (bk, bn) are
// the scale tiles; they must divide (M, K) and (K, N), and bk must be a
// multiple of 8. Launches on `stream`; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for bad sizes or an unimplemented round
// count.
extern "C" int repro_gemm_rng_fp8(
    const void* a, const void* b, const void* a_s, const void* b_s, void* c,
    int M, int N, int K, int bm, int bn, int bk, void* mask, int rows_valid,
    int sk, int sq32, int rb, int ck, int n_cb, int n_valid_blocks,
    uint32_t key_lo, uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
    int heads_local, int heads_global, uint32_t threshold, int rounds,
    void* stream) {
  return repro_gemm::fp8::run<false>(a, b, a_s, b_s, c, 1, M, N, K, bm, bn, bk,
      mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}
