// Grouped per-tile-scaled e4m3 GEMM + dropout RNG: C[e] ~= A[e] @ B[e] from
// e4m3 operands with one f32 scale per operand tile, for E experts, and
// the packed keep plane of one attention layer emitted by the same kernel,
// under the products.
//
// Replaces the TPU kernel src/repro/kernels/gemm_rng.py::
// _gemm_rng_grouped_fp8_kernel (gemm_rng.py:764, pl.pallas_call at :875).
// JAX has no emission-off fp8 grouped kernel: its Region 3 runs the
// grouped product unquantized on the operands as given
// (gemm_rng_grouped.cu, or gemm_rng_grouped_bf16.cu for bf16 operands, with
// the emission off); this kernel still takes mask == nullptr, as the dense
// fp8 one does.
//
// What it computes. A (E, M, K) is row-major e4m3fn; B reaches the kernel
// K-major, as Bt (E, N, K) row-major e4m3fn, both quantized outside the
// kernel (kernels/quant.py) per (bm, bk) and (bk, bn) tile of each expert,
// the expert folded into the scale-row index as JAX folds it: a_s (E * M /
// bm, K / bk), bt_s (E * N / bn, K / bk). C (E, M, N) is row-major f32
// (repro_gemm_rng_grouped_fp8) or, for bf16 model operands (quantized from
// their exact f32 upcast), bf16 rounded once from the f32 result
// (repro_gemm_rng_grouped_fp8_bf16: JAX's out_dtype=a.dtype), accumulated
// per k-block as p * (a_s[e * gm + i, kk] * b_s[e * gk + kk, j]) -- JAX's
// order of rounding (gemm_fp8.cuh). The plane's rectangles
// are those of the JAX layout on the logical grid E * gm * gn, written as
// gemm_emit.cuh describes: bitwise the f32 hosts'.
//
// What bounds it on an H100. e4m3 tensor cores (1,979 TFLOP/s dense) make
// a moonshot-v1-16b-a3b expert product at B=2, S=2048 (64 x 480 x 2048 x
// 1408, 177 GFLOP) 0.09 ms, and its plane's Philox (4.2 M words of 8 calls
// each) about 0.04 ms at the issue rate, against 0.44 GB of e4m3 operands,
// f32 scales, result and plane (0.13 ms at 3.35 TB/s): bytes, just. The
// design is gemm_fp8.cuh's (shared with the dense e4m3 host: the e4m3
// bytes converted exactly to f16 in shared memory for f16 wgmma with f32
// sums, bound at 989 TFLOP/s to 0.18 ms here) with a 3-D tensor map over
// (K, M, E): the capacity of 480 rows is 3.75 CTA rows, and
// the last CTA row of an expert reads TMA's zeros past row 480, never the
// next expert's rows, and stores nothing there. The scale tiles (bm = 240,
// bk = 512 or 352 at this model's hosts) cut across the 128 x 128 CTA
// tiles; every accumulator row and column reads its own scale. Measured
// by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.64 ms at the gate
// shape (the SIMT kernel it replaced: 10.3 ms), the plane 13 % of the
// product (PERF.md).
#include <cstdint>

#include "gemm_fp8.cuh"

// C[e] ~= dequantized A[e] @ Bt[e]^T for E experts as described above and,
// when `mask` is not null, the layout's blocks of the packed keep plane.
// (bm, bk) and (bn, bk) are the scale tiles of A and Bt; they must divide
// (M, K) and (N, K), and bk must be a multiple of 8. Rows of A and Bt lie
// ldk bytes apart (ldk >= K, a multiple of 16; an expert's rows follow the
// last one's), and A and Bt must start on 16 bytes. Launches on `stream`;
// returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad
// sizes or an unimplemented round count.
extern "C" int repro_gemm_rng_grouped_fp8(
    const void* a, const void* bt, const void* a_s, const void* bt_s, void* c,
    int E, int M, int N, int K, int ldk, int bm, int bn, int bk, void* mask,
    int rows_valid, int sk, int sq32, int rb, int ck, int n_cb,
    int n_valid_blocks, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_local, int heads_global,
    uint32_t threshold, int rounds, void* stream) {
  return repro_gemm::fp8::run<true, float>(a, bt, a_s, bt_s, c, E, M, N, K,
      ldk, bm, bn, bk, mask, rows_valid, sk, sq32, rb, ck, n_cb,
      n_valid_blocks, key_lo, key_hi, salt, bh_offset, heads_local,
      heads_global, threshold, rounds, stream);
}

// The same with C (E, M, N) bf16, each element rounded once from the f32
// result; C must start on 16 bytes.
extern "C" int repro_gemm_rng_grouped_fp8_bf16(
    const void* a, const void* bt, const void* a_s, const void* bt_s, void* c,
    int E, int M, int N, int K, int ldk, int bm, int bn, int bk, void* mask,
    int rows_valid, int sk, int sq32, int rb, int ck, int n_cb,
    int n_valid_blocks, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_local, int heads_global,
    uint32_t threshold, int rounds, void* stream) {
  return repro_gemm::fp8::run<true, __nv_bfloat16>(a, bt, a_s, bt_s, c, E, M,
      N, K, ldk, bm, bn, bk, mask, rows_valid, sk, sq32, rb, ck, n_cb,
      n_valid_blocks, key_lo, key_hi, salt, bh_offset, heads_local,
      heads_global, threshold, rounds, stream);
}
