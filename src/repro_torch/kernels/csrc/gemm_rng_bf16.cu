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
// 12288 x 4096, 412 GFLOP) 0.42 ms, and its plane's Philox (8.4 M words of
// 8 calls each) about 0.07 ms at the issue rate, against 0.27 GB of bf16
// operands and result and the plane (0.08 ms at 3.35 TB/s). The design
// (gemm_tc.cuh's bf16 operand policy, shared with the grouped bf16 host
// and, as a body, with the f32 hosts, on gemm_sm90.cuh's TMA, mbarriers
// and wgmma): a TMA ring of bf16 tiles read by m64n128k16
// wgmma with f32 sums on two consumer warpgroups, B read MN-major, 128 x
// 128 CTA tiles, and the plane computed by the producer warpgroup's spare
// warps during the k-loop (emit_share), as the e4m3 kernel does. Measured
// by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.93 ms at QKV, 0.75 ms
// with the emission off (cuBLAS's bf16 product alone: 0.53 ms); the plane
// costs +4 % of the gate+up product but +120 % of the out-projection's,
// whose product is too short for three RNG warps an SM to make 8.4 M
// words (PERF.md).
#include <cstdint>

#include "gemm_tc.cuh"

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
  using repro_gemm::tc::Bf16Ops;
  return repro_gemm::tc::run<Bf16Ops, false>(a, b, c, 1, M, N, K, mask,
      rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks, key_lo, key_hi,
      salt, bh_offset, heads_local, heads_global, threshold, rounds, stream);
}

// Dynamic shared memory of one CTA, in bytes (ptxas reports static only).
extern "C" int repro_gemm_rng_bf16_smem_bytes() {
  return repro_gemm::tc::smem_bytes<repro_gemm::tc::Bf16Ops>();
}
