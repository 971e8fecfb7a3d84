// Grouped bf16 GEMM + dropout RNG: C[e] = A[e] @ B[e] on bf16 operands with
// f32 sums, C rounded to bf16, for E experts (a MoE block's expert einsum;
// E = 1 for the RWKV channel-mix key / value GEMM), and the packed keep
// plane of one attention layer emitted by the same kernel, under the
// products.
//
// Replaces the TPU kernels src/repro/kernels/gemm_rng.py::
// _gemm_rng_grouped_kernel (gemm_rng.py:551, pl.pallas_call at :653) and,
// with the emission off (mask == nullptr), gemm_rng.py::
// _plain_grouped_impl.kern (:711, pallas_call at :726) -- the Region-3
// grouped host, and the product of the grouped fp8 host's Region 3 -- at
// bf16 operands: the JAX kernels are generic in the operand dtype
// (dot_general with preferred_element_type=f32 into an f32 scratch, the
// result cast to the operand dtype), and gemm_rng_grouped.cu is their f32
// instance. The emission is a run-time switch, as there.
//
// What it computes. A (E, M, K), B (E, K, N) and C (E, M, N) are row-major
// bf16, each element of C the f32 sum of exact bf16 products rounded once.
// The plane's rectangles are those of the JAX emission layout judged on
// the JAX logical grid E * gm * gn (the Python wrapper passes them; step s
// = (e * gm + i) * gn + j hosts block s), and they are indexed by Philox
// counters only, so neither the routing nor the CTA grid reaches the bits:
// bitwise the f32 grouped host's and the dense hosts' for the same
// counters.
//
// What bounds it on an H100: operations and bytes alike. bf16 tensor cores
// (989 TFLOP/s dense) make a moonshot-v1-16b-a3b expert gate product at
// B=2, S=2048 (64 x 480 x 2048 x 1408, 177 GFLOP) 0.179 ms; its 0.60 GB of
// bf16 operands and result and f32 plane move in 0.179 ms at 3.35 TB/s;
// the plane's Philox is 4.2 M words of 8 calls each. The design is the
// dense bf16 host's persistent body (gemm_bf16.cuh: 2-CTA clusters
// sharing B by TMA multicast, 128 x 256 tiles -- N = 1408 is 5.5 of them,
// still faster than 11 of 128 -- the plane under the products), walked
// expert by expert with 3-D tensor maps over (K, M, E) and (N, K, E): the
// capacity of 480 rows is 3.75 tiles of 128, and an expert's last tile row
// reads TMA's zeros past row 480, never the next expert's rows, and stores
// nothing there. Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.43
// ms at the gate, 0.33 ms with the emission off (was 0.46 / 0.39;
// torch.bmm alone 0.27, then the standalone Philox kernel: 0.36).
#include <cstdint>

#include "gemm_bf16.cuh"

// C[e] = A[e] @ B[e] for E experts as described above and, when `mask` is
// not null, the layout's blocks of the packed keep plane. K and N must be
// multiples of 8 and A, B and C must start on 16 bytes. Launches on
// `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for bad sizes or an unimplemented round count.
extern "C" int repro_gemm_rng_grouped_bf16(
    const void* a, const void* b, void* c, int E, int M, int N, int K,
    void* mask, int rows_valid, int sk, int sq32, int rb, int ck, int n_cb,
    int n_valid_blocks, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_local, int heads_global,
    uint32_t threshold, int rounds, void* stream) {
  return repro_gemm::bf16::run<true>(a, b, c, E, M, N, K, mask,
      rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}
