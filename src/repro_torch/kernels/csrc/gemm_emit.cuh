// The dropout-plane emission of the fused GEMM+RNG kernels (gemm_rng.cu and
// gemm_rng_grouped.cu, f32 operands; gemm_rng_bf16.cu and
// gemm_rng_grouped_bf16.cu, bf16 operands; gemm_rng_fp8.cu and
// gemm_rng_grouped_fp8.cu, e4m3 operands): all write exactly the rectangles
// of the JAX emission layout, so a plane does not depend on the dtype or
// the shape of the GEMM that hosts it.
//
// The plane is the flattened (rows_valid = B*H*SQ/32, SK) int32 layout, cut
// into the rb x ck rectangles of gemm_rng.py::mask_emission_layout (judged
// on the JAX logical GEMM grid by the Python wrapper): block s covers rows
// [s / n_cb * rb, + rb) clipped to rows_valid and cols [s % n_cb * ck,
// + ck). Bits are position-based (philox.cuh::packed_word), so they do not
// depend on which CTA writes them. Only valid blocks are written: the
// TPU's dummy overflow band is BlockSpec plumbing with no bits.
//
// The f32 and e4m3 kernels emit during their k-loop, on the producer
// warpgroup's three spare warps (emit_share; the persistent bf16 kernels
// take the same Emit in units of their own, gemm_walk.cuh): the words of
// the rectangles, taken in block order and row-major inside a block, are
// cut into one run of equal length per CTA of the whole grid (blockIdx.x;
// the grouped hosts' experts are part of it), so every CTA carries an
// equal share of the plane beside its product. Where JAX emits a block at
// its grid step's "kk == 0", the CUDA kernels spread the same words over
// the grid; a layout has to tile the plane for that (layout_tiles_plane),
// as every JAX layout does.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace repro_gemm {

struct Emit {
  int32_t* mask;  // nullptr: plain GEMM (Region 3)
  int rows_valid, sk, sq32, rb, ck, n_cb, n_valid_blocks;
  uint32_t k0, k1, salt, bh_offset, heads_local, heads_global, threshold;
};

// CTA `cta` of `n_ctas`: its run of the layout's words, written by
// `n_threads` threads (thread `tid`). The valid rectangles are the full row
// bands (rb rows) and the last, clipped band, each cut into n_cb column
// blocks of ck words; together they tile the (rows_valid, sk) plane.
template <int ROUNDS>
__device__ void emit_share(const Emit& e, int cta, int n_ctas, int tid,
                           int n_threads) {
  const uint32_t n_rb = e.n_valid_blocks / e.n_cb;
  const uint32_t last_rows = e.rows_valid - (n_rb - 1) * e.rb;
  const uint32_t block_words = e.rb * e.ck;
  const uint32_t last_words = last_rows * e.ck;
  const uint32_t full_words = (n_rb - 1) * e.n_cb * block_words;
  const uint32_t total = full_words + e.n_cb * last_words;
  const uint32_t per = (total + n_ctas - 1) / n_ctas;
  const uint32_t g0 = static_cast<uint32_t>(cta) * per;
  const uint32_t g1 = min(total, g0 + per);
  for (uint32_t g = g0 + tid; g < g1; g += n_threads) {
    uint32_t s, off;
    if (g < full_words) {
      s = g / block_words;
      off = g % block_words;
    } else {
      s = (n_rb - 1) * e.n_cb + (g - full_words) / last_words;
      off = (g - full_words) % last_words;
    }
    const uint32_t r = (s / e.n_cb) * e.rb + off / e.ck;
    const uint32_t c = (s % e.n_cb) * e.ck + off % e.ck;
    e.mask[static_cast<size_t>(r) * e.sk + c] =
        static_cast<int32_t>(repro_philox::packed_word<ROUNDS>(
            r, c, static_cast<uint32_t>(e.sq32), e.heads_local,
            e.heads_global, e.bh_offset, e.salt, e.k0, e.k1, e.threshold));
  }
}

// True when the layout's valid rectangles tile the plane exactly (whole
// row bands of n_cb blocks, the last band the only clipped one) and the
// plane's words fit 32-bit indices: what emit_share assumes.
inline bool layout_tiles_plane(const Emit& e) {
  if (e.n_valid_blocks <= 0 || e.n_valid_blocks % e.n_cb) return false;
  const long long n_rb = e.n_valid_blocks / e.n_cb;
  return n_rb * e.rb >= e.rows_valid && (n_rb - 1) * e.rb < e.rows_valid &&
         static_cast<long long>(e.n_cb) * e.ck == e.sk &&
         static_cast<long long>(e.rows_valid) * e.sk < (1ll << 31);
}

// The Emit of one launch from the C interface's arguments; false when a
// plane is asked for with sizes the kernel cannot take.
inline bool make_emit(void* mask, int rows_valid, int sk, int sq32, int rb,
                      int ck, int n_cb, int n_valid_blocks, uint32_t key_lo,
                      uint32_t key_hi, uint32_t salt, uint32_t bh_offset,
                      int heads_local, int heads_global, uint32_t threshold,
                      Emit* e) {
  *e = Emit{static_cast<int32_t*>(mask), rows_valid, sk, sq32, rb, ck, n_cb,
            n_valid_blocks, key_lo, key_hi, salt, bh_offset,
            static_cast<uint32_t>(heads_local),
            static_cast<uint32_t>(heads_global), threshold};
  if (mask == nullptr) return true;
  return rows_valid > 0 && sk > 0 && sq32 > 0 && rb > 0 && ck > 0 &&
         n_cb > 0 && n_valid_blocks >= 0 && heads_local > 0 &&
         heads_global > 0;
}

}  // namespace repro_gemm
