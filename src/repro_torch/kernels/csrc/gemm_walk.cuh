// The walks of the persistent bf16 GEMM+RNG kernel (gemm_bf16.cuh): which
// output tiles a CTA takes, in what order, with which tile N, and which
// words of the dropout plane one emission unit writes. Plain functions of
// integers (REPRO_HD), so a host compiler runs them too:
// tests/test_torch_gemm_bf16_tc.py compiles this header with g++ and holds
// the walks to exact coverage of every tile and every plane word.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace repro_gemm {
namespace walk {

constexpr int BM = 128;      // CTA rows: two consumer warpgroups of 64
// CTA columns: one m64n256k16 a consumer warpgroup a k16 slice, B read
// once a warpgroup; faster than 128 at every host shape, moonshot's N =
// 1408 (5.5 tiles) too (scripts/probe_gemm_bf16.py, PERF.md)
constexpr int BN = 256;
constexpr int CLUSTER = 2;   // CTAs of a cluster: neighbouring tile rows
constexpr int GROUP_M = 8;   // cluster tile rows of a band (L2 reuse of B)
constexpr int UNIT = 32;     // plane words of one emission unit: a warp's

struct Tile {
  int ex, mt, nt;  // expert, tile row, tile column
};

// Tile t of the E * tiles_m * tiles_n tiles of a launch: expert by
// expert, then bands of GROUP_M tile rows walked column by column, so the
// CTAs working at one time share their bands of A and B in L2.
REPRO_HD Tile tile_at(int t, int tiles_m, int tiles_n) {
  const int per_expert = tiles_m * tiles_n;
  const int ex = t / per_expert;
  const int r = t - ex * per_expert;
  const int band = r / (GROUP_M * tiles_n);
  const int first_m = band * GROUP_M;
  const int rows =
      tiles_m - first_m < GROUP_M ? tiles_m - first_m : GROUP_M;
  const int in_band = r - band * GROUP_M * tiles_n;
  return Tile{ex, first_m + in_band % rows, in_band / rows};
}

// Cluster tiles: CLUSTER neighbouring tile rows of one tile column, one a
// CTA of the cluster, which share the column's B tiles (each CTA loads
// 1 / CLUSTER of them for all). There are E * cluster_rows(tiles_m) *
// tiles_n; cluster c of a persistent grid of G clusters takes cluster
// tiles c, c + G, c + 2 G, ...
REPRO_HD int cluster_rows(int tiles_m) {
  return (tiles_m + CLUSTER - 1) / CLUSTER;
}

// The tile of the CTA of rank `rank` in cluster tile t. Where tiles_m is
// not a multiple of CLUSTER, the last cluster row's upper ranks get a tile
// row past tiles_m: they load B for their neighbours, multiply TMA's zeros
// and store nothing.
REPRO_HD Tile cta_tile(int t, int rank, int tiles_m, int tiles_n) {
  Tile at = tile_at(t, cluster_rows(tiles_m), tiles_n);
  at.mt = at.mt * CLUSTER + rank;
  return at;
}

// The plane is the flattened (rows, sk) int32 layout, row r packed row
// r % sq32 of local head row r / sq32. It is emitted in units of UNIT
// words of one row (a warp's lanes on neighbouring columns; the last unit
// of a row is short when sk % UNIT != 0): unit u is row u / units_per_row,
// columns UNIT (u % units_per_row) .. + UNIT - 1 clipped to sk.
REPRO_HD uint32_t units_per_row(uint32_t sk) {
  return (sk + UNIT - 1) / UNIT;
}

// CTA `cta` of `n_ctas`: its run [first, end) of the plane's units, one
// of equal length a CTA (the last ones shorter or empty).
struct Share {
  uint32_t first, end;
};
REPRO_HD Share share_of(uint32_t units, int cta, int n_ctas) {
  const uint32_t per = (units + n_ctas - 1) / n_ctas;
  const uint32_t first = static_cast<uint32_t>(cta) * per;
  const uint32_t end = first + per < units ? first + per : units;
  return Share{first < end ? first : end, end};
}

// Where unit u lies: its row's packed row q and local head row lbh (the
// divisions happen once a unit, the same for all its lanes), and its
// first column.
struct Unit {
  uint32_t row, q, lbh, c0;
};
REPRO_HD Unit unit_at(uint32_t u, uint32_t sk, uint32_t sq32) {
  const uint32_t per_row = units_per_row(sk);
  const uint32_t row = u / per_row;
  return Unit{row, row % sq32, row / sq32, (u - row * per_row) * UNIT};
}

// The packed word at column k of a row whose packed row is q32 and whose
// global head row is bh: philox.cuh::packed_word with the row already
// taken apart.
template <int ROUNDS>
REPRO_HD uint32_t word_at(uint32_t k, uint32_t q32, uint32_t bh,
                          uint32_t salt, uint32_t k0, uint32_t k1,
                          uint32_t threshold) {
  uint32_t word = 0;
#pragma unroll
  for (uint32_t t = 0; t < 8; ++t) {
    const repro_philox::Words u =
        repro_philox::philox4x32<ROUNDS>(k, q32 * 8u + t, bh, salt, k0, k1);
    word |= repro_philox::keep_nibble_of(u, threshold) << (4u * t);
  }
  return word;
}

}  // namespace walk
}  // namespace repro_gemm
