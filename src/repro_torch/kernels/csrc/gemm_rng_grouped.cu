// Grouped fused GEMM + dropout RNG: C[e] = A[e] @ B[e] in f32 for E experts
// (a MoE block's expert einsum; E = 1 for the RWKV channel-mix key / value
// GEMM), and the packed keep plane of one attention layer emitted by the
// same kernel, under the products.
//
// Replaces the TPU kernels src/repro/kernels/gemm_rng.py::
// _gemm_rng_grouped_kernel (gemm_rng.py:551, pl.pallas_call at :653) and,
// with the emission off (mask == nullptr), gemm_rng.py::
// _plain_grouped_impl.kern (:711, pallas_call at :726) -- the Region-3
// grouped host, whose mask the standalone Philox kernel makes instead
// (and the GEMM of the fp8 grouped host's Region 3, which JAX runs in
// f32). The emission is a run-time switch, as in gemm_rng.cu.
//
// What it computes. A (E, M, K), B (E, K, N) and C (E, M, N) are row-major
// f32, K and N multiples of 4; each element of C is the dense host's sum
// (gemm_rng.cu): six bf16 part products of the operands' exact triples a
// product, summed on the tensor cores a stage of 32 k at a time and folded
// into C by f32 adds. The plane does not depend on the routing: the
// emission indexes the (b, h, q, k) counter space, and its rectangles are
// those of the JAX emission layout judged on the JAX logical grid E * gm *
// gn (the Python wrapper passes them); every CTA of the whole grid writes
// an equal run of their words (gemm_emit.cuh::emit_share), so the bits are
// bitwise the dense hosts' for the same counters.
//
// What bounds it on an H100: operations. A MoE expert product of
// moonshot-v1-16b-a3b at B=2, S=2048 (64 experts x 480 x 2048 x 1408, the
// gate einsum; capacity 480) is 177 GFLOP, six bf16 products each: 1.07 ms
// at the 989 TFLOP/s dense bf16 tensor-core rate (2.6 ms at the 67 TFLOP/s
// f32 SIMT rate), against 1.16 GB of operands and result (0.35 ms at 3.35
// TB/s); its plane (2 x 16 x 64 x 2048 words, 8 Philox calls each) takes
// about 0.04 ms at the issue rate, beside the products. The design is the
// dense host's (gemm_tc.cuh, F32Ops) with 3-D tensor maps over (K, M, E)
// and (N, K, E): the capacity of 480 rows is 3.75 CTA rows of 128, and an
// expert's last CTA row reads TMA's zeros past row 480, never the next
// expert's rows, and stores nothing there.
#include <cstdint>

#include "gemm_tc.cuh"

// C[e] = A[e] @ B[e] (f32) for E experts as described above and, when
// `mask` is not null, the layout's blocks of the packed keep plane. K and N
// must be multiples of 4 and A, B and C must start on 16 bytes. Launches on
// `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for bad sizes or an unimplemented round count.
extern "C" int repro_gemm_rng_grouped(
    const void* a, const void* b, void* c, int E, int M, int N, int K,
    void* mask, int rows_valid, int sk, int sq32, int rb, int ck, int n_cb,
    int n_valid_blocks, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_local, int heads_global,
    uint32_t threshold, int rounds, void* stream) {
  using repro_gemm::tc::F32Ops;
  return repro_gemm::tc::run<F32Ops, true>(a, b, c, E, M, N, K, mask,
      rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}
