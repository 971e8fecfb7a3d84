// Philox-4x32 with the repository's position-based counter scheme.
//
// The same rounds as repro_torch/kernels/philox_common.py::philox4x32 (and
// the JAX package's philox_common.philox4x32), so a keep bit made here is
// bitwise equal to one made by any other producer:
//
//     ctr = (x0 = k, x1 = q / 4, x2 = b * H + h, x3 = salt), key = (lo, hi)
//     u32 = philox4x32_r(ctr, key)[q % 4];  keep = u32 >= threshold
//
// Not cuRAND's or PyTorch's Philox: those lay their counters out
// differently and give other bits.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define REPRO_HD __host__ __device__ __forceinline__
#else
#define REPRO_HD inline
#endif

namespace repro_philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // golden-ratio Weyl increment
constexpr uint32_t kW1 = 0xBB67AE85u;

REPRO_HD uint32_t mulhi32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}

struct Words {
  uint32_t w0, w1, w2, w3;
};

template <int ROUNDS>
REPRO_HD Words philox4x32(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                          uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t hi0 = mulhi32(kM0, x0);
    const uint32_t lo0 = kM0 * x0;  // unsigned wrap == low word
    const uint32_t hi1 = mulhi32(kM1, x2);
    const uint32_t lo1 = kM1 * x2;
    const uint32_t y0 = hi1 ^ x1 ^ k0;
    const uint32_t y2 = hi0 ^ x3 ^ k1;
    x0 = y0;
    x1 = lo1;
    x2 = y2;
    x3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return Words{x0, x1, x2, x3};
}

// Shard-local flattened (b, h) index -> global counter index; the identity
// plus an offset when the producer covers whole rows of heads.
REPRO_HD uint32_t global_bh(uint32_t local_bh, uint32_t heads_local,
                            uint32_t heads_global, uint32_t bh_offset) {
  if (heads_local == heads_global) return local_bh + bh_offset;
  return bh_offset + (local_bh / heads_local) * heads_global +
         local_bh % heads_local;
}

// The same chain with the round count a run-time argument, for kernels
// whose main work is not the RNG (flash attention), where one binary per
// round count is not worth its build time.
REPRO_HD Words philox4x32_n(uint32_t x0, uint32_t x1, uint32_t x2,
                            uint32_t x3, uint32_t k0, uint32_t k1,
                            int rounds) {
  for (int r = 0; r < rounds; ++r) {
    const uint32_t hi0 = mulhi32(kM0, x0);
    const uint32_t lo0 = kM0 * x0;
    const uint32_t hi1 = mulhi32(kM1, x2);
    const uint32_t lo1 = kM1 * x2;
    const uint32_t y0 = hi1 ^ x1 ^ k0;
    const uint32_t y2 = hi0 ^ x3 ^ k1;
    x0 = y0;
    x1 = lo1;
    x2 = y2;
    x3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return Words{x0, x1, x2, x3};
}

REPRO_HD uint32_t keep_nibble_of(const Words& u, uint32_t threshold) {
  return static_cast<uint32_t>(u.w0 >= threshold) |
         (static_cast<uint32_t>(u.w1 >= threshold) << 1) |
         (static_cast<uint32_t>(u.w2 >= threshold) << 2) |
         (static_cast<uint32_t>(u.w3 >= threshold) << 3);
}

// Keep bits of the four query rows 4*q4 .. 4*q4+3 at key column k of the
// (global) head row bh: bit w is row 4*q4 + w.
REPRO_HD uint32_t keep_nibble(uint32_t k, uint32_t q4, uint32_t bh,
                              uint32_t salt, uint32_t k0, uint32_t k1,
                              uint32_t threshold, int rounds) {
  return keep_nibble_of(philox4x32_n(k, q4, bh, salt, k0, k1, rounds),
                        threshold);
}

// One keep bit at (q, k) of head row bh.
REPRO_HD bool keep_bit(uint32_t q, uint32_t k, uint32_t bh, uint32_t salt,
                       uint32_t k0, uint32_t k1, uint32_t threshold,
                       int rounds) {
  return (keep_nibble(k, q >> 2, bh, salt, k0, k1, threshold, rounds) >>
          (q & 3u)) & 1u;
}

// One packed word of the flattened mask layout (BH * SQ32, SK): row r
// holds packed row r % sq32 of local head row r / sq32 (remapped to the
// global counter index by global_bh); bit q % 32 of the word is query
// row (r % sq32) * 32 + q % 32.
template <int ROUNDS>
REPRO_HD uint32_t packed_word(uint32_t r, uint32_t k, uint32_t sq32,
                              uint32_t heads_local, uint32_t heads_global,
                              uint32_t bh_offset, uint32_t salt,
                              uint32_t k0, uint32_t k1,
                              uint32_t threshold) {
  const uint32_t bh =
      global_bh(r / sq32, heads_local, heads_global, bh_offset);
  const uint32_t q32 = r % sq32;
  uint32_t word = 0;
#pragma unroll
  for (uint32_t t = 0; t < 8; ++t) {
    const Words u = philox4x32<ROUNDS>(k, q32 * 8u + t, bh, salt, k0, k1);
    word |= keep_nibble_of(u, threshold) << (4u * t);
  }
  return word;
}

}  // namespace repro_philox
