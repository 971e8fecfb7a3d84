// Flash-attention forward at f32 q/k/v on Hopper's tensor cores: out
// (B, H, SQ, D) and the row log-sum-exp (B, H, SQ) in f32, with the
// paper's dropout modes -- the F32Ops instance of flash_fwd_sm90.cuh's
// body (the bf16 instance is flash_fwd_bf16.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300) at f32
// q/k/v, reached through flash_attention_mosaic (:388-433).
//
// What it computes: the JAX kernel's f32 instance. Both products have f32
// operands on both sides -- S = Q K^T and P V -- and each is the sum of
// the six bf16 part products of the operands' exact triples that reach
// 2^-16 (flash_sm90.cuh: score6, add_product6), smallest first, with f32
// sums: the f32 product up to about 2^-23 of sum |a||b| and the order of
// the sums. A product that split one operand and rounded the other once
// to bf16 would be about 2^-9 off: another function.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the
// products of the valid half are 68.7 GFLOP; six bf16 products apiece are
// 0.42 ms at 989 TFLOP/s (1.03 ms at the f32 SIMT rate of 67 TFLOP/s, the
// rate of the SIMT kernel this one replaced); the exponentials and the
// replayed keep bits are SIMT work the tensor cores cannot take (0.07 ms
// at the issue rate), and so are the splits (about 12 instructions a pair
// of values, Q once and K and V each k-block); the operands, O and lse
// move 0.27 GB (0.08 ms at 3.35 TB/s).
//
// The design (flash_fwd_sm90.cuh, F32Ops): the f32 dq kernel's
// (flash_dq_f32.cu) on the forward's body, with two warpgroups a CTA (128
// query rows of one head and batch, q-blocks launched longest first)
// sharing the K and V triples, so each split serves 128 rows. The f32
// tiles come by TMA into a staging tile and the CTA's 256 threads split
// them into bf16 triples in the layout the products read: Q once, then
// each k-block's V while the S products run and the next k-block's K
// while P V's first column chunk runs. P is an exact register triple
// (a_frags); each 64-column chunk of P V is a product of its own folded
// into O by f32 adds. Shared memory: two Q triples, the K and V triples
// and one f32 staging tile, 230,408 bytes at D = 128 -- one CTA an SM.
// Measured on the H100 (PERF.md row 4): without the splits (a wrong
// output, for timing) the one-warpgroup version ran 0.43 ms faster in
// none mode (1.32 ms); two warpgroups took it to 1.04 ms, replay from
// 1.76 to 1.30 ms.
#include <cstdint>

#include "flash_fwd_sm90.cuh"

// out, lse <- flash attention of f32 q (B,H,SQ,D), k/v (B,KV,SK,D), all
// contiguous and on 16 bytes; out and lse f32; SQ and SK multiples of 64;
// D in {16, 32, 64, 128}; mode 0 = none, 1 = premask (plane), 2 = counters
// (key words). Launches on `stream`; returns the CUDA error code (0 on
// success), cudaErrorInvalidValue for what it does not take or a tensor
// map that cuTensorMapEncodeTiled refuses (repro_flash::fwd::run).
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  return repro_flash::fwd::run<repro_flash::fwd::F32Ops>(
      q, k, v, out, lse, B, H, KV, SQ, SK, D, scale, causal, local_window,
      mode, plane, threshold, inv_keep, key_lo, key_hi, salt, bh_offset,
      heads_global, rounds, stream);
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_fwd_smem_bytes(int D) {
  return repro_flash::fwd::smem_bytes<repro_flash::fwd::F32Ops>(D);
}
