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
// What it computes. A (M, K) is row-major e4m3fn; B reaches the kernel
// K-major, as Bt (N, K) row-major e4m3fn (the wrapper quantizes the
// transposed weight, or transposes the bytes of a (K, N) operand); a_s
// (M/bm, K/bk) and bt_s (N/bn, K/bk) are row-major f32 scales, one per
// (bm, bk) tile of A and (bk, bn) tile of B -- the JAX logical GEMM blocks
// of producer.pick_gemm_blocks, which quant.quantize_tiled scaled by. C
// (M, N) is row-major f32 (repro_gemm_rng_fp8) or, for bf16 model operands
// (quantized from their exact f32 upcast), bf16 rounded once from the f32
// result (repro_gemm_rng_fp8_bf16: JAX writes C in the operand dtype, its
// out_dtype=a.dtype): for each k-block kb of bk columns, the block's
// partial product p, then C += p * (a_s[i/bm][kb] * b_s[kb][j/bn]) -- JAX's
// order of rounding, with p summed in f32 from tensor-core pieces of at
// most 128 k (gemm_fp8.cuh). The plane's blocks are those of the JAX
// emission layout (gemm_emit.cuh): bitwise the f32 host's (gemm_rng.cu)
// for the same counters.
//
// What bounds it on an H100: operations. e4m3 tensor cores (1,979
// TFLOP/s dense) make the gate+up product of a llama2-7b block at B=2,
// S=2048 (4096 x 22016 x 4096, 739 GFLOP) 0.37 ms, and its plane's Philox
// (8.4 M words of 8 calls each) about 0.07 ms at the issue rate, against
// 0.46 GB of operands, scales, result and plane (0.14 ms at 3.35 TB/s).
// The design (gemm_fp8.cuh, shared with the grouped host): a TMA ring of
// e4m3 tiles, converted exactly to f16 in shared memory and multiplied by
// f16 wgmma with f32 sums on two consumer warpgroups (the e4m3 wgmma's
// narrower sums miss the check against the plain version), 128 x 128 CTA
// tiles, the per-k-block rescale in registers, and the plane computed by
// the producer warpgroup's spare warps during the k-loop, so the RNG's
// issue slots sit beside the tensor-core work instead of in front of it.
// Multiplying at the f16 rate (989 TFLOP/s) bounds it at 0.75 ms at
// gate+up. Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 2.14
// ms at gate+up (the SIMT kernel it replaced: 39.0 ms), the plane 8 % of
// that product but 70 % of the out-projection's 0.39 ms, whose product is
// shorter than the three RNG warps an SM need for the plane (PERF.md).
#include <cstdint>

#include "gemm_fp8.cuh"

// C = dequantized A @ Bt^T as described above, and, when `mask` is not
// null, the layout's blocks of the packed keep plane. (bm, bk) and (bn, bk)
// are the scale tiles of A and Bt; they must divide (M, K) and (N, K), and
// bk must be a multiple of 8. Rows of A and Bt lie ldk bytes apart (ldk >=
// K, a multiple of 16), and A and Bt must start on 16 bytes. Launches on
// `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for bad sizes or an unimplemented round count.
extern "C" int repro_gemm_rng_fp8(
    const void* a, const void* bt, const void* a_s, const void* bt_s, void* c,
    int M, int N, int K, int ldk, int bm, int bn, int bk, void* mask,
    int rows_valid,
    int sk, int sq32, int rb, int ck, int n_cb, int n_valid_blocks,
    uint32_t key_lo, uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
    int heads_local, int heads_global, uint32_t threshold, int rounds,
    void* stream) {
  return repro_gemm::fp8::run<false, float>(a, bt, a_s, bt_s, c, 1, M, N, K,
      ldk, bm, bn, bk, mask, rows_valid, sk, sq32, rb, ck, n_cb,
      n_valid_blocks, key_lo, key_hi, salt, bh_offset, heads_local,
      heads_global, threshold, rounds, stream);
}

// The same with C (M, N) bf16, each element rounded once from the f32
// result; C must start on 16 bytes.
extern "C" int repro_gemm_rng_fp8_bf16(
    const void* a, const void* bt, const void* a_s, const void* bt_s, void* c,
    int M, int N, int K, int ldk, int bm, int bn, int bk, void* mask,
    int rows_valid,
    int sk, int sq32, int rb, int ck, int n_cb, int n_valid_blocks,
    uint32_t key_lo, uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
    int heads_local, int heads_global, uint32_t threshold, int rounds,
    void* stream) {
  return repro_gemm::fp8::run<false, __nv_bfloat16>(a, bt, a_s, bt_s, c, 1,
      M, N, K, ldk, bm, bn, bk, mask, rows_valid, sk, sq32, rb, ck, n_cb,
      n_valid_blocks, key_lo, key_hi, salt, bh_offset, heads_local,
      heads_global, threshold, rounds, stream);
}

// Dynamic shared memory of one CTA, in bytes (ptxas reports static only).
extern "C" int repro_gemm_rng_fp8_smem_bytes() {
  return repro_gemm::fp8::SMEM_BYTES;
}
