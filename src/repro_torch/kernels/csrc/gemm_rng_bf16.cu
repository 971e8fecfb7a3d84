// bf16 GEMM + dropout RNG: C = A @ B on bf16 operands with f32 sums, C
// rounded to bf16, and the packed keep plane of one attention layer emitted
// by the same kernel, under the product.
//
// Replaces the TPU kernels src/repro/kernels/gemm_rng.py::_gemm_rng_kernel
// (gemm_rng.py:143, pl.pallas_call at :241) and, with the emission off
// (mask == nullptr), gemm_rng.py::_plain_gemm_impl.kern (:304, pallas_call
// at :319) -- the paper's Region 3 host -- at bf16 operands: the JAX
// kernels are generic in the operand dtype (dot_general with
// preferred_element_type=f32, the result cast to the operand dtype), and
// gemm_rng.cu is their f32 instance. The emission is a run-time switch, as
// there.
//
// What it computes. A (M, K) and B (K, N) are row-major bf16, B the
// model's weight as it is; C (M, N) is row-major bf16, each element the
// f32 sum of exact bf16 products rounded once. The plane's blocks are those
// of the JAX emission layout (gemm_emit.cuh): bitwise the f32 host's for
// the same counters -- the operand dtype never changes a bit.
//
// What bounds it on an H100: operations. bf16 tensor cores (989 TFLOP/s
// dense) make the QKV product of a llama2-7b block at B=2, S=2048 (4096 x
// 12288 x 4096, 412 GFLOP) 0.42 ms, against 0.27 GB of bf16 operands and
// result and the 8.4 M-word plane (0.08 ms at 3.35 TB/s); the plane's
// Philox is 8 calls a word on the integer pipes. The design
// (gemm_bf16.cuh, shared with the grouped bf16 host): a persistent grid of
// 2-CTA clusters, 128 x 256 tiles, B loaded once a cluster by TMA
// multicast, m64n256k16 wgmma with f32 sums, the plane in 32-word units
// made by the producer's spare warps and, one a stage, by the consumer
// warps under the products. Measured on an H100 80GB HBM3 at 700 W
// (PERF.md, chip_smoke.py): 0.79 ms at QKV, 0.59 ms with the emission off
// (was 0.92 / 0.73 before this body; cuBLAS's product alone: 0.52, then
// the standalone Philox kernel: 0.68 together). The product is bound by
// its loads (0.49 ms of it without the products) and, like cuBLAS's, by
// the 700 W limit; the plane costs +35-50 % at QKV and +100 % at the
// out-projection, because the Philox words and the products slow each
// other (scripts/probe_gemm_bf16.py).
#include <cstdint>

#include "gemm_bf16.cuh"

// C = A @ B as described above and, when `mask` is not null, the layout's
// blocks of the packed keep plane. K and N must be multiples of 8 and A, B
// and C must start on 16 bytes. Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad sizes or
// an unimplemented round count.
extern "C" int repro_gemm_rng_bf16(const void* a, const void* b, void* c,
                                   int M, int N, int K, void* mask,
                                   int rows_valid, int sk, int sq32, int rb,
                                   int ck, int n_cb, int n_valid_blocks,
                                   uint32_t key_lo, uint32_t key_hi,
                                   uint32_t salt, uint32_t bh_offset,
                                   int heads_local, int heads_global,
                                   uint32_t threshold, int rounds,
                                   void* stream) {
  return repro_gemm::bf16::run<false>(a, b, c, 1, M, N, K, mask,
      rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}

// Dynamic shared memory of one CTA, in bytes (ptxas reports static only).
extern "C" int repro_gemm_rng_bf16_smem_bytes() {
  return repro_gemm::bf16::Ring<repro_gemm::walk::BN>::SMEM;
}

// The clusters of the persistent grid on the current device (at most;
// fewer when a launch has fewer cluster tiles), or -1 when the runtime
// cannot say.
extern "C" int repro_gemm_rng_bf16_clusters() {
  using namespace repro_gemm::bf16;
  constexpr int BN = repro_gemm::walk::BN;
  int clusters = 0;
  return resident_clusters(gemm_bf16_kernel<BN, 7, false>,
                           Ring<BN>::SMEM, &clusters)
             ? -1
             : clusters;
}
