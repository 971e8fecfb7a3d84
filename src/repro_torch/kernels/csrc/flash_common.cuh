// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile shape, the thread-to-element map, masking and the dropout keep
// bits of one thread's score elements.
//
// Tiles are BQ x BK = 64 x 64 score elements on 256 threads (a 16 x 16
// grid). Thread (ty, tx) owns query rows 4*ty + i (i < 4) -- four
// consecutive rows, so one Philox call (which covers q = 4*g .. 4*g + 3 at
// one key) gives all four of its keep bits at a key -- and key columns
// tx + 16*j (j < 4), so neighbouring threads read neighbouring shared-memory
// words. Operand tiles sit in shared memory row-major with a pitch of
// D + 1 floats: a column walk over rows (tx + 16*j) * (D + 1) + d hits 16
// different banks, a row walk is contiguous.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace repro_flash {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PP = BK + 1;  // pitch of a 64 x 64 probability tile

// -0.7 * FLT_MAX rounded to f32, the JAX kernels' _NEG_BIG: masked scores
// take it, so exp(score - max) is 0 once a row has seen a valid key.
__device__ __forceinline__ float neg_big() { return __uint_as_float(0xFF333332u); }

enum Mode : int { kNone = 0, kPremask = 1, kCounters = 2 };

// Dropout inputs: the packed plane (premask) or the Philox key words
// (counters: "replay" and "fused" differ only in where the words come
// from, so both are this mode).
struct Dropout {
  const int32_t* plane;  // (B, H, SQ/32, SK) int32 bit patterns
  uint32_t threshold, k0, k1, salt, bh_offset, heads_global;
  int rounds;
  float inv_keep;
};

// Whether the (q-block, k-block) tile holds any valid score: the JAX
// kernels' block skip, applied only when causal (as there).
__device__ __forceinline__ bool tile_runs(int q_start, int k_start,
                                          int q_offset, int causal,
                                          int local_window) {
  if (!causal) return true;
  const int q_lo = q_start + q_offset;
  const int q_hi = q_start + BQ - 1 + q_offset;
  bool run = k_start <= q_hi;
  if (local_window > 0) run = run && (k_start + BK - 1 > q_lo - local_window);
  return run;
}

__device__ __forceinline__ bool score_valid(int q_pos, int k_pos, int causal,
                                            int local_window) {
  bool valid = true;
  if (causal) valid = k_pos <= q_pos;
  if (local_window > 0) valid = valid && (k_pos > q_pos - local_window);
  return valid;
}

// keep[i][j] of rows q_start + 4*ty + i, cols k_start + tx + 16*j, as four
// 4-bit nibbles (bit i of nib[j]).
template <int MODE>
__device__ __forceinline__ void keep_nibbles(const Dropout& dp, int b,
                                             int h, int H, int SQ, int SK,
                                             int q_start, int k_start,
                                             int ty, int tx,
                                             uint32_t nib[4]) {
  const int q0 = q_start + 4 * ty;
  if (MODE == kPremask) {
    const int32_t* row =
        dp.plane + (static_cast<size_t>(b) * H + h) * (SQ / 32) * SK +
        static_cast<size_t>(q0 / 32) * SK;
    const int shift = q0 & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = static_cast<uint32_t>(row[k_start + tx + 16 * j]);
      nib[j] = (w >> shift) & 0xFu;
    }
  } else if (MODE == kCounters) {
    const uint32_t bh = repro_philox::global_bh(
        static_cast<uint32_t>(b * H + h), static_cast<uint32_t>(H),
        dp.heads_global, dp.bh_offset);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      nib[j] = repro_philox::keep_nibble(
          static_cast<uint32_t>(k_start + tx + 16 * j),
          static_cast<uint32_t>(q0 >> 2), bh, dp.salt, dp.k0, dp.k1,
          dp.threshold, dp.rounds);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) nib[j] = 0xFu;
  }
}

// Copy a rows x D tile (row-major, contiguous rows of D floats) into shared
// memory at pitch D + 1.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * D; i += NT)
    dst[(i / D) * (D + 1) + i % D] = src[i];
}

// Sum / max over the 16 lanes (tx) that share a query row.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace repro_flash
