// Flash-attention forward at bf16 q/k/v on Hopper's tensor cores: out
// (B, H, SQ, D) in bf16 and the row log-sum-exp (B, H, SQ) in f32, with the
// paper's dropout modes -- the Bf16Ops instance of flash_fwd_sm90.cuh's
// body (the f32 instance is flash_fwd_f32.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (flash_attention.py:58, pl.pallas_call at :300) at bf16
// q/k/v, reached through flash_attention_mosaic (:388-433).
//
// What it computes: exactly the JAX kernel's bf16 instance, which upcasts
// the bf16 tiles to f32 (:108-110), multiplies in f32, multiplies the f32
// probabilities P by V (:155-157) and rounds O once (:289). Scores S = (q .
// k) * scale come from bf16 wgmma products -- every product of two bf16
// values is exact in f32 -- with f32 sums. P enters P V as the exact
// triple hi + mid + lo (flash_sm90.cuh): three bf16 products into the
// same f32 accumulator are f32 P times V up to the order of the sums.
//
// What bounds it on an H100: at B=2, H=32, S=2048, D=128, causal, the
// products of the valid half are 69 GFLOP (0.07 ms at 989 TFLOP/s bf16),
// the exponentials and the replayed keep bits are SIMT work the tensor
// cores cannot take (the same 0.07 ms at the issue rate), the operands
// 0.1 GB. The triple doubles the tensor-core work (the PV half three
// times); chip_smoke.py's bound does not count it.
//
// The design (flash_fwd_sm90.cuh): one warpgroup a CTA, K and V through a
// two-stage TMA ring, S an m64n64 wgmma with both operands K-major in
// shared memory, the keep bits made while it runs, the softmax on its
// accumulator, P's parts register A operands of m64nDk16 products against
// V read MN-major, each k-block's P V folded into O by one f32 multiply-add
// an element (a product chained over all k-blocks inside the tensor core
// carries its f32 accumulation over 384 steps: flash_sm90.cuh has what that
// did). Shared memory: Q and two stages of K and V, 80 KB at D = 128 --
// two CTAs an SM.
#include <cstdint>

#include "flash_fwd_sm90.cuh"

// out, lse <- flash attention of bf16 q/k/v; out bf16, lse f32. The
// arguments and return of repro_flash_fwd (flash_fwd_f32.cu):
// repro_flash::fwd::run.
extern "C" int repro_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int KV, int SQ, int SK, int D, float scale, int causal,
    int local_window, int mode, const void* plane, uint32_t threshold,
    float inv_keep, uint32_t key_lo, uint32_t key_hi, uint32_t salt,
    uint32_t bh_offset, int heads_global, int rounds, void* stream) {
  return repro_flash::fwd::run<repro_flash::fwd::Bf16Ops>(
      q, k, v, out, lse, B, H, KV, SQ, SK, D, scale, causal, local_window,
      mode, plane, threshold, inv_keep, key_lo, key_hi, salt, bh_offset,
      heads_global, rounds, stream);
}

// dynamic shared memory a CTA of the D instance takes (0 for another D)
extern "C" int repro_flash_fwd_bf16_smem_bytes(int D) {
  return repro_flash::fwd::smem_bytes<repro_flash::fwd::Bf16Ops>(D);
}
