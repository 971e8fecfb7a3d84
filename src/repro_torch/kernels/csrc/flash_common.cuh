// Shared pieces of the flash-attention kernels: the tile shape, masking and
// the dropout inputs of all of them (the Hopper pieces -- tiles, products,
// keep bits -- are in flash_sm90.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_flash {

constexpr int BQ = 64;
constexpr int BK = 64;

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
// kernels' block skip, applied only when causal (as there). A host
// compiler runs it too (flash_wide_map.cuh).
__host__ __device__ __forceinline__ bool tile_runs(int q_start, int k_start,
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

}  // namespace repro_flash
