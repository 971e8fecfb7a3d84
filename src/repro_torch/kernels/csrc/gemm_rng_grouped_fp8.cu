// Grouped per-tile-scaled e4m3 GEMM + dropout RNG: C[e] ~= A[e] @ B[e] from
// e4m3 operands with one f32 scale per operand tile, for E experts, and
// the packed keep plane of one attention layer emitted by the same kernel,
// under the products.
//
// Replaces the TPU kernel src/repro/kernels/gemm_rng.py::
// _gemm_rng_grouped_fp8_kernel (gemm_rng.py:764, pl.pallas_call at :875).
// JAX has no emission-off fp8 grouped kernel: its Region 3 runs the f32
// grouped product (gemm_rng_grouped.cu with the emission off); this kernel
// still takes mask == nullptr, as the dense fp8 one does.
//
// What it computes. A (E, M, K) and B (E, K, N) are row-major e4m3fn
// bytes, quantized outside the kernel (kernels/quant.py) per (bm, bk) and
// (bk, bn) tile of each expert, the expert folded into the scale-row index
// as JAX folds it: a_s (E * M / bm, K / bk), b_s (E * K / bk, N / bn). C
// (E, M, N) is row-major f32, accumulated per k-block as p * (a_s[e * gm +
// i, kk] * b_s[e * gk + kk, j]) -- JAX's order of rounding (gemm_fp8.cuh).
// The plane's rectangles are those of the JAX layout on the logical grid E
// * gm * gn, written as gemm_emit.cuh describes: bitwise the f32 hosts'.
//
// What bounds it on an H100. For the bound of the function: e4m3 tensor
// cores (1,979 TFLOP/s dense) make a moonshot-v1-16b-a3b expert product at
// B=2, S=2048 (64 x 480 x 2048 x 1408, 177 GFLOP) 0.09 ms, and its plane's
// Philox (4.2 M words of 8 calls each) about 0.04 ms at the issue rate,
// against 0.44 GB of e4m3 operands, f32 scales, result and plane (0.13 ms
// at 3.35 TB/s): the two bounds meet. This first kernel is the SIMT
// tiling of gemm_fp8.cuh (shared with the dense e4m3 host) with the expert
// in blockIdx.z: f32 FMAs on decoded e4m3 at about 19 TFLOP/s, near 1 % of
// that bound. The scale tiles (bm = 240, bk = 512 or 352 at this model's
// hosts) cut across the 128 x 128 CTA tiles; every accumulator row and
// column reads its own scale, as in the dense kernel. Tensor cores
// (mma.sync e4m3 or wgmma) are later work.
#include <cstdint>

#include "gemm_fp8.cuh"

// C[e] ~= dequantized A[e] @ B[e] for E experts as described above and,
// when `mask` is not null, the layout's blocks of the packed keep plane.
// (bm, bk) and (bk, bn) are the scale tiles; they must divide (M, K) and
// (K, N), and bk must be a multiple of 8. Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad sizes or
// an unimplemented round count.
extern "C" int repro_gemm_rng_grouped_fp8(
    const void* a, const void* b, const void* a_s, const void* b_s, void* c,
    int E, int M, int N, int K, int bm, int bn, int bk, void* mask,
    int rows_valid, int sk, int sq32, int rb, int ck, int n_cb,
    int n_valid_blocks, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_local, int heads_global,
    uint32_t threshold, int rounds, void* stream) {
  return repro_gemm::fp8::run<true>(a, b, a_s, b_s, c, E, M, N, K, bm, bn, bk,
      mask, rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}
