// The step maps of the flash kernels at head_dim 256 that split their work
// between warpgroups: the f32 forward, dq and dkv (flash_fwd_f32.cu,
// flash_dq_f32.cu, flash_dkv_f32.cu, on flash_f32_wide.cuh) -- which
// 32-column slice of a walked tile each warpgroup takes at each step,
// which rows and columns of the score tile and of the output it owns, where
// each exchanged element lands, and where dq's K and V triples lie in
// device memory -- and the bf16 ones (flash_fwd_bf16.cu, flash_dq_bf16.cu,
// flash_dkv_bf16.cu): the query rows of the forward's and dq's consumer
// warpgroups, dq's k-blocks and its ring of K and V tiles, and dkv's
// queries, output columns and exchange. Plain integer functions, so a host
// compiler runs them too: tests/test_torch_flash_wide_split.py,
// tests/test_torch_flash_d256_rule2.py and
// tests/test_torch_flash_bwd_bf16_d256.py compile this header with g++ and
// hold the maps to exact coverage.
//
// Fragments. Thread t of a warpgroup (warp w = t / 32, lane l, c = l % 4)
// holds element i of an m64nN f32 accumulator at row 16 w + l / 4 + 8 hh
// and column 8 g + 2 c + e, for i = 4 g + 2 hh + e (flash_sm90.cuh). The
// same thread of either warpgroup holds the same positions of a tile of
// the same width: an exchange through shared memory pairs thread t with
// thread t.
#pragma once

#include <cstddef>
#include <cstdint>

#include "flash_common.cuh"

#if defined(__CUDACC__)
#define WIDE_HD __host__ __device__ __forceinline__
#else
#define WIDE_HD inline
#endif

namespace repro_flash {
namespace wide_map {

constexpr int D = 256;
constexpr int SW = 32;                // columns of a slice
constexpr int SLICES = D / SW;        // slices of a row: 8
constexpr int HALF_SLICES = SLICES / 2;
constexpr int WG_THREADS = 128;

// ------------------------------------------------------------ the forward
// Split by D. Each warpgroup reduces S = Q K^T over its own 128 columns of
// D (a partial 64 x 64 sum), the two partial sums cross through shared
// memory and each warpgroup adds them (x + y == y + x in f32, so both hold
// the same scores); each then runs the online softmax in full and P V over
// its own 128 columns of V, its half of O. A k-block is FWD_STEPS steps a
// warpgroup, one slice each: K's slices of the half (0-3), then V's.
constexpr int FWD_STEPS = 2 * HALF_SLICES;

WIDE_HD bool fwd_reads_v(int r) { return r >= HALF_SLICES; }

// the slice of D (0-7) that warpgroup wg splits at step r of a k-block:
// for K the k range of its partial scores, for V its output columns
WIDE_HD int fwd_slice(int wg, int r) {
  return HALF_SLICES * wg + r % HALF_SLICES;
}

// the float of the exchange at which thread t of warpgroup wg leaves
// element i (0-31) of its partial scores: float4s of 4 consecutive
// elements, a warpgroup's 128 threads side by side; the other warpgroup's
// thread t reads them there (and both wait for each other before the next
// k-block's are written)
WIDE_HD int fwd_xchg(int wg, int t, int i) {
  return (wg * 8 + i / 4) * 4 * WG_THREADS + 4 * t + i % 4;
}
constexpr int FWD_XCHG_FLOATS = 2 * 32 * WG_THREADS;

// the keep-bit words (the forward's and dq's): warpgroup wg makes those of
// rows hh = wg (the row group 16 w + l / 4 + 8 wg of each thread), thread t
// leaves its word at fwd_keep_xchg and takes the other row group's from the
// other warpgroup
WIDE_HD int fwd_keep_rows(int wg) { return wg; }
WIDE_HD int fwd_keep_xchg(int wg, int t) { return wg * WG_THREADS + t; }
constexpr int FWD_KEEP_WORDS = 2 * WG_THREADS;

// ----------------------------------------------------------------- dK, dV
// Split by queries. Each warpgroup computes the columns of the transposed
// score tiles (rows keys, columns queries) of its 32 queries over the full
// D: S^T = K Q^T and dP^T = V dO^T as m64n32 products, B the slices' rows
// dkv_query0(wg) ..; its keep bits and exponentials of those columns only.
// P_drop^T and then dS^T cross through shared memory, so each warpgroup
// holds the whole 64 x 64 fragment as the A operand of its output half:
// dV and dK over the columns of the slices dkv_owner gives it. The CTA
// walks its q-blocks twice, in steps of two slices side by side (64
// columns; the CTA's 256 threads split them). The walk that makes dV: Q's
// slices for S^T (steps 0-3), then dO's for dV (4-7). The walk that makes
// dK: Q's slices for S^T (0-3), dO's for dP^T (4-7), Q's again for dK
// (8-11). In the output phases both slices of a step lie in one
// warpgroup's half (one m64n64 product), and the halves take turns.
constexpr int DKV_PHASE = SLICES / 2;  // steps of a phase

// steps of a q-block in the walk that makes dK (else dV)
WIDE_HD constexpr int dkv_steps(bool dk) { return (dk ? 3 : 2) * DKV_PHASE; }

// 0: S^T over Q; 1: dV or dP^T over dO; 2: dK over Q
WIDE_HD int dkv_phase(int r) { return r / DKV_PHASE; }
WIDE_HD bool dkv_reads_do(int r) { return dkv_phase(r) == 1; }

// the first of step r's two slices (the second is the next)
WIDE_HD int dkv_slice(int r) {
  const int m = r % DKV_PHASE;
  return dkv_phase(r) == 0 ? 2 * m : (m % 2) * HALF_SLICES + 2 * (m / 2);
}

// the warpgroup whose output half holds slice s's columns, and the
// 64-column block within it of the step's two slices from s
WIDE_HD int dkv_owner(int s) { return s / HALF_SLICES; }
WIDE_HD int dkv_block(int s) { return (s % HALF_SLICES) / 2; }

// the first of warpgroup wg's 32 queries (the columns of its score tiles)
WIDE_HD int dkv_query0(int wg) { return SW * wg; }

// Element i (0-15) of warpgroup wg's m64n32 half is element
// dkv_full(wg, i) of the m64n64 fragment of all 64 queries: its column
// 8 g + 2 c + e is query dkv_query0(wg) + that.
WIDE_HD int dkv_full(int wg, int i) { return 16 * wg + i; }

// The float of the exchange of element i (0-15) of thread t's half. One
// region for both warpgroups: the first writes its half; the second's
// thread t reads the first's thread t there and then writes its own half
// into the same floats; the first reads that.
WIDE_HD int dkv_xchg(int t, int i) {
  return (i / 4) * 4 * WG_THREADS + 4 * t + i % 4;
}
constexpr int DKV_XCHG_FLOATS = 16 * WG_THREADS;

// --------------------------------------------------------------------- dq
// Split by D, as the forward. A k-block is DQ_STEPS steps a warpgroup, one
// slice of its own half of D each: K's four (its partial S = Q K^T over
// its 128 columns of D, Q's same columns as A), V's four (its partial dP =
// dO V^T), then K's four again (dq += dS K over its 128 output columns).
// The partial S and dP cross through shared memory (dq_xchg; S with the
// keep words, each warpgroup having made one row group's, fwd_keep_xchg)
// and both warpgroups add them, so both hold the same S and dP and each
// makes the whole dS, the A operand of its half of dq.
constexpr int DQ_STEPS = 3 * HALF_SLICES;

// 0: S over K; 1: dP over V; 2: dq over K
WIDE_HD int dq_phase(int r) { return r / HALF_SLICES; }
WIDE_HD bool dq_reads_v(int r) { return dq_phase(r) == 1; }

// the slice of D (0-7) that warpgroup wg takes at step r of a k-block: the
// k range of its partial scores (the same columns of Q or dO), or its
// output columns
WIDE_HD int dq_slice(int wg, int r) {
  return HALF_SLICES * wg + r % HALF_SLICES;
}

// The exchange of a partial score tile, in two rounds of 16 floats a
// thread (one region of 16 x 128 floats): element i (0-31) of thread t
// goes in round i / 16 to float dq_xchg(t, i). The first warpgroup writes
// the round's floats, the second's thread t reads the first's thread t
// there, adds, and writes its own into the same floats; the first reads
// those and adds.
WIDE_HD int dq_xchg(int t, int i) {
  return ((i % 16) / 4) * 4 * WG_THREADS + 4 * t + i % 4;
}
constexpr int DQ_XCHG_FLOATS = 16 * WG_THREADS;

// dq's K and V triples in device memory (its workspace), written once a
// call by flash_dq_kernel_triples. A 64 x 32 slice of one part of a
// k-block is one SLICE_PART-byte run in the 64-byte swizzle of a 64-row
// bf16 tile of 32 columns -- the bytes at which the threads of the other
// split kernels store a slice (flash_f32_wide.cuh, store_slice) -- so one
// bulk copy (TMA) lands it in a slice buffer as it is. The runs lie
// (tensor, k-block, slice, part) in row-major order: K's k-blocks, then
// V's, each k-block's 8 slices, each slice's hi, mid, lo.
constexpr int SLICE_PART = 64 * SW * 2;

// a byte offset of a 64-byte-swizzled tile (tc::swizzle<64>): the 16-byte
// chunk bits of a row xor the row's bits 1-2
WIDE_HD uint32_t swizzle64(uint32_t off) {
  return off ^ (((off >> 7) & 3u) << 4);
}

// the first byte of part p of slice s of global k-block kb (rows 64 kb ..
// of the (B * KV * SK, D) tensor) of V (else K), of `blocks` k-blocks a
// tensor
WIDE_HD size_t dq_ws_part(bool v, int blocks, int kb, int s, int p) {
  return ((static_cast<size_t>(v ? blocks : 0) + kb) * SLICES * 3 +
          3 * s + p) *
         SLICE_PART;
}

// the byte of element (row, col) of that k-block's rows (row < 64, col <
// D) in part p
WIDE_HD size_t dq_ws_byte(bool v, int blocks, int kb, int row, int col,
                          int p) {
  return dq_ws_part(v, blocks, kb, col / SW, p) +
         swizzle64(static_cast<uint32_t>(row * SW * 2 + (col % SW) * 2));
}

// ------------------------------------------------- the bf16 forward's rows
// A CTA takes 128 query rows, 64 each for its two consumer warpgroups;
// where SQ % 128 == 64 the last CTA's second warpgroup has none.
WIDE_HD int fwd_bf16_ctas(int sq) { return (sq / BQ + 1) / 2; }
WIDE_HD int fwd_bf16_q_start(int qi, int cw) { return 2 * BQ * qi + BQ * cw; }
WIDE_HD bool fwd_bf16_has_rows(int qi, int cw, int sq) {
  return fwd_bf16_q_start(qi, cw) < sq;
}

// ------------------------------------------------------ the bf16 dq's walk
// dq takes the forward's rows (fwd_bf16_ctas, fwd_bf16_q_start,
// fwd_bf16_has_rows: 128 a CTA, 64 a consumer warpgroup) and walks the
// k-blocks that hold a valid score for a row of the CTA (dq_bf16_k_run; a
// consumer's k-block without one adds exact zeros). Its producer brings
// each k-block's V, then its K, into a ring of DQ_BF16_SLOTS tile slots:
// tile dq_bf16_tile(j, k) of the walk lands in slot dq_bf16_slot(tile) in
// the phase dq_bf16_parity(tile) of the slot's full barrier, and the slot
// takes tile + DQ_BF16_SLOTS once the consumers have released tile (the
// same phase of its empty barrier). A consumer's k-block j waits for K and
// V (S = Q K^T and dP = dO V^T, one turn), releases V once dP is done,
// then issues dq += dS K (the next turn) and releases K once that is done:
// V first in the walk, since K stays longer.
constexpr int DQ_BF16_SLOTS = 3;
WIDE_HD int dq_bf16_tile(int j, bool k) { return 2 * j + (k ? 1 : 0); }
WIDE_HD int dq_bf16_slot(int tile) { return tile % DQ_BF16_SLOTS; }
WIDE_HD int dq_bf16_parity(int tile) {
  return (tile / DQ_BF16_SLOTS) & 1;
}

// ----------------------------------------------------- the bf16 dK and dV
// 64 keys a CTA, two consumer warpgroups. The score products are split by
// queries as the f32 dkv's (dkv_query0: consumer cw computes the m64n32
// columns of S^T and dP^T of its 32 queries over the full D, with their
// keep bits and exponentials); consumer cw leaves its P_drop^T half in
// region dkv_bf16_region(0, cw) of the exchange and its dS^T half in
// region dkv_bf16_region(1, cw), element i of thread t at float
// dkv_xchg(t, i) of the region, and takes the other's halves from there,
// so each holds the whole 64 x 64 fragment (dkv_full) as the A operand of
// dV and dK over its own output columns dkv_bf16_col0(cw) .. + 127.
constexpr int DKV_BF16_XCHG_FLOATS = 4 * DKV_XCHG_FLOATS;
WIDE_HD int dkv_bf16_region(int q, int cw) { return 2 * q + cw; }
WIDE_HD int dkv_bf16_col0(int cw) { return (D / 2) * cw; }

// Whether every score of the (q-block, k-block) tile is valid (score_valid
// of flash_common.cuh), so its elements need no mask
WIDE_HD bool tile_full(int q_start, int k_start, int q_offset, int causal,
                       int local_window) {
  const int q_lo = q_start + q_offset, q_hi = q_start + BQ - 1 + q_offset;
  return (!causal || k_start + BK - 1 <= q_lo) &&
         (local_window <= 0 || k_start > q_hi - local_window);
}

// The q-blocks that hold a valid score of the k-block at k_start: one
// contiguous run (the JAX kernels' block skip is causal with a window)
struct Run {
  int first, n;
};
WIDE_HD Run q_run(int k_start, int sq, int q_offset, int causal,
                  int local_window) {
  Run run{0, 0};
  for (int qi = 0; qi < sq / BQ; ++qi)
    if (tile_runs(qi * BQ, k_start, q_offset, causal, local_window)) {
      if (run.n == 0) run.first = qi;
      ++run.n;
    }
  return run;
}

// The k-blocks that hold a valid score for a row of the bf16 dq's CTA qi
// (its consumers' rows, fwd_bf16_q_start): one contiguous run
WIDE_HD Run dq_bf16_k_run(int qi, int sq, int sk, int causal,
                          int local_window) {
  Run run{0, 0};
  for (int ki = 0; ki < sk / BK; ++ki) {
    bool any = false;
    for (int cw = 0; cw < 2; ++cw)
      any = any || (fwd_bf16_has_rows(qi, cw, sq) &&
                    tile_runs(fwd_bf16_q_start(qi, cw), ki * BK, sk - sq,
                              causal, local_window));
    if (any) {
      if (run.n == 0) run.first = ki;
      ++run.n;
    }
  }
  return run;
}

}  // namespace wide_map
}  // namespace repro_flash
