// The walk of the standalone Philox kernel (philox_mask.cu): which words
// of the packed plane each thread of its persistent grid makes. Plain
// functions of integers (REPRO_HD), so a host compiler runs them too:
// tests/test_torch_philox_walk.py compiles this header with g++ and holds
// the walk to writing every word of the plane exactly once.
//
// The plane is the flattened (B * H * SQ32, SK) layout: row r is packed
// row r % SQ32 of local head row r / SQ32 = b * H + h. A thread takes
// WORDS consecutive words of one row at a time, a group; a row has
// groups_per_row(SK) of them (the last one short when SK % WORDS != 0),
// and the groups are numbered row by row. Thread i of a grid of S threads
// takes groups i, i + S, i + 2 S, ... . Its cursor holds the current
// group as (column group, packed row, head, batch row) and the flat index
// of its first word, and steps by S with adds and carries: the divisions
// happen once a thread, when its cursor and the step are set up.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace repro_philox {
namespace walk {

constexpr int kThreads = 256;  // a CTA
constexpr int WORDS = 4;       // consecutive words of a row a thread makes

REPRO_HD uint32_t groups_per_row(uint32_t sk) {
  return (sk + WORDS - 1) / WORDS;
}

// The plane and its shard window (global_bh's heads_global, bh_offset).
struct Plane {
  uint32_t batch, heads_local, sq32, sk;
  uint32_t heads_global, bh_offset;
  uint32_t gpr;     // groups_per_row(sk)
  int32_t row_fix;  // sk - gpr * WORDS: the flat index's step to the next
                    // row's first group from one past this row's last
};

REPRO_HD Plane plane_of(uint32_t batch, uint32_t heads_local, uint32_t sq32,
                        uint32_t sk, uint32_t heads_global,
                        uint32_t bh_offset) {
  const uint32_t gpr = groups_per_row(sk);
  return Plane{batch, heads_local, sq32, sk, heads_global, bh_offset, gpr,
               static_cast<int32_t>(sk) -
                   static_cast<int32_t>(gpr * WORDS)};
}

// A group as (column group, packed row, local head, batch row) and the
// flat index of its first word; also a step of S groups in the same form.
struct Cursor {
  uint32_t grp, q32, h, b;
  uint64_t word;
};

// Group g (g < 2^31) taken apart: the divisions of the walk.
REPRO_HD Cursor cursor_at(uint32_t g, const Plane& p) {
  const uint32_t row = g / p.gpr;
  const uint32_t head = row / p.sq32;
  Cursor c;
  c.grp = g - row * p.gpr;
  c.q32 = row - head * p.sq32;
  c.b = head / p.heads_local;
  c.h = head - c.b * p.heads_local;
  c.word = static_cast<uint64_t>(row) * p.sk +
           static_cast<uint64_t>(c.grp) * WORDS;
  return c;
}

// The cursor S groups on, given s = cursor_at(S): each field adds its
// part of the step and carries into the next, so none leaves its range.
REPRO_HD void advance(Cursor& c, const Cursor& s, const Plane& p) {
  c.word += s.word;
  c.grp += s.grp;
  uint32_t carry = 0;
  if (c.grp >= p.gpr) {
    c.grp -= p.gpr;
    c.word += static_cast<uint64_t>(static_cast<int64_t>(p.row_fix));
    carry = 1;
  }
  c.q32 += s.q32 + carry;
  carry = c.q32 >= p.sq32 ? 1u : 0u;
  if (carry) c.q32 -= p.sq32;
  c.h += s.h + carry;
  carry = c.h >= p.heads_local ? 1u : 0u;
  if (carry) c.h -= p.heads_local;
  c.b += s.b + carry;
}

// The global counter index of the cursor's head row: global_bh without
// its division.
REPRO_HD uint32_t bh_of(const Cursor& c, const Plane& p) {
  return p.bh_offset + c.b * p.heads_global + c.h;
}

// The persistent grid: as many CTAs as can run at once (per_sm on each of
// `sms` SMs), fewer when the plane has fewer groups than their threads;
// and the step of its threads' cursors, cursor_at(ctas * kThreads).
struct Launch {
  uint32_t ctas;
  Cursor step;
};
REPRO_HD Launch launch_of(const Plane& p, int sms, int per_sm) {
  const uint64_t groups = static_cast<uint64_t>(p.batch) * p.heads_local *
                          static_cast<uint64_t>(p.sq32) * p.gpr;
  const uint64_t need = (groups + kThreads - 1) / kThreads;
  const uint64_t most = static_cast<uint64_t>(sms) * per_sm;
  const uint32_t ctas = static_cast<uint32_t>(need < most ? need : most);
  return Launch{ctas, cursor_at(ctas * kThreads, p)};
}

}  // namespace walk
}  // namespace repro_philox
