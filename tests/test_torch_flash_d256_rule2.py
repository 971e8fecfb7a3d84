"""The f32 flash dq's and the bf16 flash forward's maps at head_dim 256, on
the CPU.

``csrc/flash_dq_f32.cu``'s D = 256 kernels and ``csrc/flash_fwd_bf16.cu``'s
run only on the card. Where dq's split pass writes K's and V's bf16 triples
in device memory, which slice each of dq's two warpgroups takes at each
step, where each element of its exchanged partial scores lands, and which
query rows each of the bf16 forward's consumer warpgroups owns are plain
integer functions of ``csrc/flash_wide_map.cuh``. These tests compile that
header with g++ (skipped where there is no g++) and hold it, against numpy,
to:

- the workspace: every element of every part of K and V at its own byte,
  each slice's part one run that a bulk copy (TMA) lands in a slice buffer
  with every element at the byte the other split kernels' threads store it
  at (``store_slice``: 64-byte rows in the 64-byte swizzle), and the three
  bf16 parts of each f32 value, read back from there, summing to it
  exactly; the wrapper allocating it at the map's size (1.5x the bytes of
  K and V) for the f32 dq at head_dim 256 alone;
- dq's steps feeding each product every (row, D-column) of Q, dO, K and V
  exactly once: each warpgroup its own half of D, S over Q and K, dP over
  dO and V, dS K over K into its own output columns;
- dq's exchange leaving both warpgroups with the same S and dP, the sum of
  their partials, at every element;
- the bf16 forward's row ownership covering every query row exactly once
  for SQ % 128 in {0, 64}.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_d256_rule2.py
"""
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention_bwd as tb

STUB = r"""
#pragma once
#include <cstring>
#define __host__
#define __device__
#define __forceinline__ inline
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
"""

PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include "flash_wide_map.cuh"
using namespace repro_flash;
using namespace repro_flash::wide_map;

int main(int argc, char** argv) {
  if (!std::strcmp(argv[1], "ws")) {  // ws BLOCKS: every element's bytes
    const int blocks = atoi(argv[2]);
    std::printf("%d %zu\n", SLICE_PART,
                dq_ws_part(true, blocks, blocks - 1, SLICES - 1, 2) +
                    SLICE_PART);
    for (int v = 0; v < 2; ++v)
      for (int kb = 0; kb < blocks; ++kb)
        for (int row = 0; row < BK; ++row)
          for (int col = 0; col < D; ++col) {
            std::printf("%d %d %d %d", v, kb, row, col);
            for (int p = 0; p < 3; ++p)
              std::printf(" %zu %zu", dq_ws_byte(v, blocks, kb, row, col, p),
                          dq_ws_part(v, blocks, kb, col / SW, p));
            std::printf("\n");
          }
  } else if (!std::strcmp(argv[1], "wsbytes")) {  // wsbytes ROWS: the end
    const int blocks = int(atoll(argv[2]) / BK);  // of V's last run
    std::printf("%zu\n",
                dq_ws_part(true, blocks, blocks - 1, SLICES - 1, 2) +
                    SLICE_PART);
  } else if (!std::strcmp(argv[1], "dq")) {
    std::printf("%d %d %d\n", DQ_STEPS, DQ_XCHG_FLOATS, HALF_SLICES);
    for (int wg = 0; wg < 2; ++wg)
      for (int r = 0; r < DQ_STEPS; ++r)
        std::printf("%d %d %d %d %d\n", wg, r, dq_phase(r),
                    int(dq_reads_v(r)), dq_slice(wg, r));
    for (int t = 0; t < WG_THREADS; ++t) {
      for (int i = 0; i < 32; ++i)
        std::printf(" %d %d", i / 16, dq_xchg(t, i));
      std::printf("\n");
    }
  } else {  // rows SQ: the bf16 forward's CTAs and their row groups
    const int sq = atoi(argv[2]);
    std::printf("%d\n", fwd_bf16_ctas(sq));
    for (int qi = 0; qi < fwd_bf16_ctas(sq); ++qi)
      for (int cw = 0; cw < 2; ++cw)
        std::printf("%d %d %d %d\n", qi, cw, fwd_bf16_q_start(qi, cw),
                    int(fwd_bf16_has_rows(qi, cw, sq)));
  }
  return 0;
}
"""

D, SW, BK = 256, 32, 64


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """The host program over csrc/flash_wide_map.cuh, built with g++:
    args -> its output lines."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the maps are compiled from the CUDA headers")
    out = tmp_path_factory.mktemp("flash_d256_map")
    (out / "cuda_runtime.h").write_text(STUB)
    src = out / "maps.cc"
    src.write_text(PROGRAM)
    exe = out / "maps"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{out}", f"-I{build.CSRC}",
                    "-o", str(exe), str(src)], check=True)

    def run(*args):
        res = subprocess.run([str(exe), *map(str, args)], check=True,
                             capture_output=True, text=True)
        return [[int(x) for x in line.split()]
                for line in res.stdout.splitlines()]
    return run


def store_slice_byte(row, col):
    """The byte at which the split kernels' threads store element (row, col
    < 32) of a slice part (flash_f32_wide.cuh, store_slice: unit u = 4 row
    + col / 8 at swizzle<64>(64 row + 16 (col / 8)), its element e = col %
    8 two bytes a value on)."""
    off = row * 64 + 16 * (col // 8)
    return (off ^ (((off >> 7) & 3) << 4)) + 2 * (col % 8)


def bf16_rn(x):
    """f32 -> the nearest bf16 (ties to even), as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def split3(x):
    """split3 of flash_sm90.cuh: hi, mid, lo, each a bf16 value as f32."""
    x = np.asarray(x, np.float32)
    hi = bf16_rn(x)
    r = (x - hi).astype(np.float32)
    mid = bf16_rn(r)
    lo = bf16_rn((r - mid).astype(np.float32))
    return hi, mid, lo


def test_split3_parts_sum_back_exactly():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(20000).astype(np.float32),
                        (rng.standard_normal(2000) * 1e30).astype(np.float32),
                        (rng.standard_normal(2000) * 1e-30).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, -3.0e38, 2.0 ** -100])])
    hi, mid, lo = split3(x)
    for part in (hi, mid, lo):
        assert np.array_equal(bf16_rn(part), part)  # each a bf16 value
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo
    assert np.array_equal(total, x.astype(np.float64))


def test_dq_workspace_lands_each_slice_as_store_slice(maps):
    blocks = 2
    lines = maps("ws", blocks)
    part_bytes, total = lines[0]
    assert part_bytes == 64 * SW * 2
    assert total == 2 * 3 * blocks * BK * D * 2
    rows = np.array(lines[1:], dtype=np.int64)
    v, kb, row, col = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    byte = rows[:, 4:10:2]
    run = rows[:, 5:10:2]
    # every (tensor, element, part) at its own two bytes, all bytes covered
    flat = byte.ravel()
    assert np.all(flat % 2 == 0)
    assert len(np.unique(flat)) == flat.size == total // 2
    assert flat.min() == 0 and flat.max() == total - 2
    # a slice's part is one run of part_bytes; within it each element at
    # the byte store_slice puts it in a slice buffer's part
    for p in range(3):
        within = byte[:, p] - run[:, p]
        assert np.all((within >= 0) & (within < part_bytes))
        want = np.array([store_slice_byte(r, c % SW)
                         for r, c in zip(row, col)])
        assert np.array_equal(within, want)
    # the three parts of a slice lie side by side: one slice triple
    assert np.all(run[:, 1] - run[:, 0] == part_bytes)
    assert np.all(run[:, 2] - run[:, 1] == part_bytes)
    # runs in (tensor, k-block, slice) order: the walk's loads
    key = (v * blocks + kb) * (D // SW) + col // SW
    assert np.array_equal(run[:, 0], key * 3 * part_bytes)

    # the split pass's writes read back through a slice buffer: every f32
    # value of K and V, exactly
    rng = np.random.default_rng(1)
    kv = rng.standard_normal((2, blocks * BK, D)).astype(np.float32)
    ws = np.zeros(total // 2, np.uint16)
    x = kv[v, kb * BK + row, col]
    for p, part in enumerate(split3(x)):
        ws[byte[:, p] // 2] = (part.view(np.uint32) >> 16).astype(np.uint16)
    got = np.zeros_like(kv, dtype=np.float64)
    for t in range(2):
        for b in range(blocks):
            for s in range(D // SW):
                sel = (v == t) & (kb == b) & (col // SW == s)
                start = run[sel, 0][0]
                buf = ws[start // 2:(start + 3 * part_bytes) // 2]
                for r in range(BK):
                    for c in range(SW):
                        at = store_slice_byte(r, c) // 2
                        parts = [buf[p * part_bytes // 2 + at]
                                 for p in range(3)]
                        vals = [np.uint32(int(w) << 16).view(np.float32)
                                for w in parts]
                        got[t, b * BK + r, SW * s + c] = sum(
                            float(w) for w in vals)
    assert np.array_equal(got, kv.astype(np.float64))


@pytest.mark.parametrize("b,kvh,sk", [(1, 1, 64), (2, 4, 192), (1, 1, 4096)])
def test_dq_workspace_the_wrapper_allocates(maps, b, kvh, sk):
    # the f32 dq at head_dim 256 takes the map's bytes for its rows; the
    # other instances take none
    ws = tb._dq_workspace(tb.KERNEL_DQ, b, kvh, sk, D, "cpu")
    assert ws.dtype == torch.uint8
    assert ws.numel() == maps("wsbytes", b * kvh * sk)[0][0]
    # 1.5x the f32 bytes of K and V
    assert 2 * ws.numel() == 3 * (2 * b * kvh * sk * D * 4)
    assert tb._dq_workspace(tb.KERNEL_DQ, b, kvh, sk, 128, "cpu") is None
    assert tb._dq_workspace(tb.KERNEL_DQ_BF16, b, kvh, sk, D, "cpu") is None
    assert tb._dq_workspace(tb.KERNEL_DKV, b, kvh, sk, D, "cpu") is None


def _dq(maps):
    out = maps("dq")
    steps, xchg_floats, half = out[0]
    table = np.array(out[1:1 + 2 * steps])
    xchg = np.array(out[1 + 2 * steps:]).reshape(128, 32, 2)
    return steps, xchg_floats, half, table, xchg


def test_dq_steps_feed_every_product_once(maps):
    steps, _, half, table, _ = _dq(maps)
    assert steps == 12 and half == 4
    # phase 0: S = Q K^T, k over D; 1: dP = dO V^T; 2: dq += dS K, n over D
    for phase, reads_v in ((0, 0), (1, 1), (2, 0)):
        seen = np.zeros(D, int)
        for wg in range(2):
            rows = table[(table[:, 0] == wg) & (table[:, 2] == phase)]
            assert len(rows) == half
            assert np.all(rows[:, 3] == reads_v)
            for s in rows[:, 4]:
                # the warpgroup's own half of D: its partial scores' k
                # range (the same columns of Q or dO and of K or V), and
                # its output columns of dq
                assert s // half == wg
                seen[SW * s:SW * (s + 1)] += 1
        # every column of the A tile (Q, dO) and of the walked tile (K, V)
        # in one product, every row of both with it (a slice has all 64)
        assert np.all(seen == 1)
    # the steps of a phase are consecutive: phase r // 4
    assert np.array_equal(table[:steps, 2], np.arange(steps) // half)


def test_dq_exchange_leaves_both_the_same_sum(maps):
    _, xchg_floats, _, _, xchg = _dq(maps)
    assert xchg_floats == 16 * 128
    rounds, where = xchg[..., 0], xchg[..., 1]
    # a round (elements i // 16, the kernel's loops) is 16 floats a thread,
    # each float of the region once
    for r in range(2):
        sel = where[rounds == r]
        assert sel.size == xchg_floats
        assert len(np.unique(sel)) == xchg_floats
        assert sel.min() == 0 and sel.max() == xchg_floats - 1
    # the protocol: warpgroup 0 writes, 1 reads, adds and writes its own
    # over it, 0 reads and adds
    rng = np.random.default_rng(2)
    part = rng.standard_normal((2, 128, 32)).astype(np.float32)
    mine = part.copy()
    region = np.full(xchg_floats, np.nan, np.float32)
    for r in range(2):
        idx = [(t, i) for t in range(128) for i in range(32)
               if rounds[t, i] == r]
        for t, i in idx:
            region[where[t, i]] = part[0, t, i]
        for t, i in idx:
            y = region[where[t, i]]
            region[where[t, i]] = part[1, t, i]
            mine[1, t, i] = np.float32(part[1, t, i] + y)
        for t, i in idx:
            mine[0, t, i] = np.float32(part[0, t, i] + region[where[t, i]])
    assert np.array_equal(mine[0].view(np.uint32), mine[1].view(np.uint32))
    assert np.array_equal(mine[0], part[0] + part[1])


@pytest.mark.parametrize("sq", [64, 128, 192, 256, 320, 4096, 4160])
def test_fwd_bf16_rows_cover_each_query_once(maps, sq):
    out = maps("rows", sq)
    ctas = out[0][0]
    assert ctas == (sq // 64 + 1) // 2
    seen = np.zeros(sq // 64, int)
    for qi, cw, q_start, has_rows in out[1:]:
        assert q_start == 128 * qi + 64 * cw
        assert has_rows == (q_start < sq)
        if has_rows:
            seen[q_start // 64] += 1
    assert np.all(seen == 1)
    # only the last CTA's second row group can be empty, when SQ % 128 == 64
    empty = [(qi, cw) for qi, cw, _, has in out[1:] if not has]
    assert empty == ([(ctas - 1, 1)] if sq % 128 == 64 else [])
