// Fused GEMM + dropout RNG: C = A @ B in f32, and the packed keep plane of
// one attention layer emitted by the same kernel, under the product.
//
// Replaces the TPU kernels src/repro/kernels/gemm_rng.py::_gemm_rng_kernel
// (gemm_rng.py:143, pl.pallas_call at :241) and, with the emission off
// (mask == nullptr), gemm_rng.py::_plain_gemm_impl.kern (:304,
// pallas_call at :319) -- the paper's Region 3 host, whose mask the
// standalone Philox kernel makes instead. The emission is a run-time
// switch, so both variants run one compiled main loop and their times
// differ by the emission alone.
//
// What it computes. A (M, K) and B (K, N) are row-major f32; C (M, N) is
// row-major f32, each element one f32 sum over k in order of k-tiles. The
// plane's blocks are those of the JAX emission layout, written as
// gemm_emit.cuh describes.
//
// What bounds it on an H100: f32 operations. The QKV product of a
// llama2-7b training step at B=2, S=2048 (4096 x 12288 x 4096) is 412
// GFLOP, about 6.2 ms at the 67 TFLOP/s f32 (non-tensor-core) rate,
// against 0.34 GB of operands and result (0.1 ms at 3.35 TB/s); its plane
// is 8.4 M words of 8 Philox calls each, about 1 % of the GEMM's issue
// slots. The design is the textbook SIMT tiling of gemm_f32.cuh (shared
// with the grouped host, gemm_rng_grouped.cu), launched with one expert.
// The RNG issues beside the FMA stream of the CTAs that own a block;
// nothing else waits for it.
#include <cstdint>

#include "gemm_f32.cuh"

// C = A @ B (f32) and, when `mask` is not null, the layout's blocks of the
// packed keep plane. Launches on `stream`; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for bad sizes or an unimplemented round
// count.
extern "C" int repro_gemm_rng(const void* a, const void* b, void* c, int M,
                              int N, int K, void* mask, int rows_valid,
                              int sk, int sq32, int rb, int ck, int n_cb,
                              int n_valid_blocks, uint32_t key_lo,
                              uint32_t key_hi, uint32_t salt,
                              uint32_t bh_offset, int heads_local,
                              int heads_global, uint32_t threshold,
                              int rounds, void* stream) {
  return repro_gemm::f32::run<false>(a, b, c, 1, M, N, K, mask, rows_valid, sk,
      sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi, salt, bh_offset,
      heads_local, heads_global, threshold, rounds, stream);
}
