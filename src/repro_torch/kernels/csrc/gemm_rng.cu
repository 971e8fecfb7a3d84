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
// What it computes. A (M, K) and B (K, N) are row-major f32, B the model's
// weight as it is, K and N multiples of 4; C (M, N) is row-major f32, each
// element the sum over k of the f32 products a b, each product taken as the
// six bf16 part products of the operands' exact triples that reach 2^-16,
// summed in f32 on the tensor cores a stage of 32 k at a time and folded
// stage by stage into C by f32 adds (gemm_tc.cuh) -- the JAX kernel's f32
// product up to about 2^-23 of sum |a||b| and the order of the f32 sums.
// The plane's blocks are those of the JAX emission layout (gemm_emit.cuh).
//
// What bounds it on an H100: operations. The QKV product of a llama2-7b
// training step at B=2, S=2048 (4096 x 12288 x 4096) is 412 GFLOP, six
// bf16 products each: 2.50 ms at the 989 TFLOP/s dense bf16 tensor-core
// rate (6.2 ms at the 67 TFLOP/s f32 SIMT rate, the rate of the SIMT kernel
// this one replaced), against 0.34 GB of operands and result (0.1 ms at
// 3.35 TB/s); its plane is 8.4 M words of 8 Philox calls each, about 0.07
// ms at the issue rate, beside the products. The design is gemm_tc.cuh's
// f32 operand policy (F32Ops), shared with the grouped host
// (gemm_rng_grouped.cu) and, as a body, with the bf16 hosts: a TMA ring of
// f32 stages of 32 k, B's split by two consumer warpgroups into a bf16
// triple in shared memory while the last stage's twelve m64n128k16 wgmma
// products run, A's split by each thread into its own register fragments
// (wgmma's RS form); 128 x 128 CTA tiles, and the plane computed by the
// producer warpgroup's spare warps during the k-loop (emit_share).
#include <cstdint>

#include "gemm_tc.cuh"

// C = A @ B (f32) as described above and, when `mask` is not null, the
// layout's blocks of the packed keep plane. K and N must be multiples of 4
// and A, B and C must start on 16 bytes. Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for bad sizes or
// an unimplemented round count.
extern "C" int repro_gemm_rng(const void* a, const void* b, void* c, int M,
                              int N, int K, void* mask, int rows_valid,
                              int sk, int sq32, int rb, int ck, int n_cb,
                              int n_valid_blocks, uint32_t key_lo,
                              uint32_t key_hi, uint32_t salt,
                              uint32_t bh_offset, int heads_local,
                              int heads_global, uint32_t threshold,
                              int rounds, void* stream) {
  using repro_gemm::tc::F32Ops;
  return repro_gemm::tc::run<F32Ops, false>(a, b, c, 1, M, N, K, mask,
      rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}

// Dynamic shared memory of one CTA, in bytes (ptxas reports static only).
extern "C" int repro_gemm_rng_smem_bytes() {
  return repro_gemm::tc::smem_bytes<repro_gemm::tc::F32Ops>();
}
