"""The bf16 flash dq's and dkv's maps at head_dim 256, on the CPU.

``csrc/flash_dq_bf16.cu``'s and ``csrc/flash_dkv_bf16.cu``'s D = 256
kernels run only on the card. Which query rows each of dq's consumer
warpgroups owns, which k-blocks its CTA walks and in which slot and phase
of its ring each K and V tile lands, which queries and output columns each
of dkv's consumers owns, which q-blocks its CTA walks and where each
exchanged element lands are plain integer functions of
``csrc/flash_wide_map.cuh``. These tests compile that header with g++
(skipped where there is no g++) and hold it, against numpy, to:

- dq: every query row owned by one consumer, for SQ % 128 in {0, 64};
  every (q-block, k-block) tile that holds a valid score walked by its
  CTA exactly once, and the walk no longer than the tiles need;
- dq's ring: each K and V tile of the walk in one slot, its full
  barrier's phase the slot's fill count, the producer never refilling a
  slot the consumers still read, and no wait of the producer or the
  consumers left without the release or the load it waits for;
- dkv: its two consumers' score columns covering each query of a q-block
  once, their output columns each column of D once, the q-blocks walked
  exactly those that hold a valid score, every element of the exchange at
  its own float, and both consumers assembling the same whole fragment,
  element for element where the m64n64 layout puts it.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_bwd_bf16_d256.py
"""
import shutil
import subprocess

import numpy as np
import pytest

from repro_torch.kernels import build

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
  if (!std::strcmp(argv[1], "dq")) {  // dq SQ SK CAUSAL WINDOW
    const int sq = atoi(argv[2]), sk = atoi(argv[3]);
    const int causal = atoi(argv[4]), window = atoi(argv[5]);
    std::printf("%d\n", fwd_bf16_ctas(sq));
    for (int qi = 0; qi < fwd_bf16_ctas(sq); ++qi) {
      const Run run = dq_bf16_k_run(qi, sq, sk, causal, window);
      std::printf("%d %d %d", qi, run.first, run.n);
      for (int cw = 0; cw < 2; ++cw)
        std::printf(" %d %d", fwd_bf16_q_start(qi, cw),
                    int(fwd_bf16_has_rows(qi, cw, sq)));
      std::printf("\n");
    }
    for (int qb = 0; qb < sq / BQ; ++qb)  // tile_runs, the JAX block skip
      for (int kb = 0; kb < sk / BK; ++kb)
        std::printf("%d", int(tile_runs(qb * BQ, kb * BK, sk - sq, causal,
                                        window)));
    std::printf("\n");
  } else if (!std::strcmp(argv[1], "ring")) {  // ring N: the walk's tiles
    const int n = atoi(argv[2]);
    std::printf("%d\n", DQ_BF16_SLOTS);
    for (int j = 0; j < n; ++j)
      for (int k = 0; k < 2; ++k) {
        const int tile = dq_bf16_tile(j, k);
        std::printf("%d %d %d %d %d\n", j, k, tile, dq_bf16_slot(tile),
                    dq_bf16_parity(tile));
      }
  } else if (!std::strcmp(argv[1], "dkv")) {  // dkv: ownership, exchange
    std::printf("%d %d\n", DKV_XCHG_FLOATS, DKV_BF16_XCHG_FLOATS);
    for (int cw = 0; cw < 2; ++cw)
      std::printf("%d %d %d %d\n", cw, dkv_query0(cw), dkv_bf16_col0(cw),
                  dkv_bf16_region(0, cw) * 10 + dkv_bf16_region(1, cw));
    for (int wg = 0; wg < 2; ++wg)
      for (int i = 0; i < 16; ++i) std::printf("%d ", dkv_full(wg, i));
    std::printf("\n");
    for (int t = 0; t < WG_THREADS; ++t) {
      for (int i = 0; i < 16; ++i) std::printf("%d ", dkv_xchg(t, i));
      std::printf("\n");
    }
  } else {  // qrun SQ SK CAUSAL WINDOW: each k-block's q-blocks
    const int sq = atoi(argv[2]), sk = atoi(argv[3]);
    const int causal = atoi(argv[4]), window = atoi(argv[5]);
    for (int kb = 0; kb < sk / BK; ++kb) {
      const Run run = q_run(kb * BK, sq, sk - sq, causal, window);
      std::printf("%d %d\n", run.first, run.n);
    }
  }
  return 0;
}
"""

D, BQ, BK = 256, 64, 64
# (SQ, SK, causal, local window): SQ % 128 in {0, 64}, SK > SQ, the
# recurrentgemma LOCAL layer's window, a window narrower than a block and
# one that leaves keys without a query
SHAPES = [(64, 64, 1, 0), (128, 128, 1, 0), (192, 192, 1, 0),
          (320, 320, 1, 64), (256, 512, 1, 128), (192, 448, 1, 32),
          (4096, 4096, 1, 2048), (4160, 4160, 1, 2048), (320, 320, 0, 0),
          (192, 1024, 1, 256)]


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """The host program over csrc/flash_wide_map.cuh, built with g++:
    args -> its output lines."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the maps are compiled from the CUDA headers")
    out = tmp_path_factory.mktemp("flash_bwd_bf16_d256_map")
    (out / "cuda_runtime.h").write_text(STUB)
    src = out / "maps.cc"
    src.write_text(PROGRAM)
    exe = out / "maps"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{out}", f"-I{build.CSRC}",
                    "-o", str(exe), str(src)], check=True)

    def run(*args):
        res = subprocess.run([str(exe), *map(str, args)], check=True,
                             capture_output=True, text=True)
        return res.stdout.splitlines()
    return run


def _dq(maps, sq, sk, causal, window):
    lines = maps("dq", sq, sk, causal, window)
    ctas = int(lines[0])
    ctas_rows = [[int(x) for x in line.split()] for line in lines[1:-1]]
    runs = np.array([int(ch) for ch in lines[-1]]).reshape(sq // BQ,
                                                            sk // BK)
    return ctas, ctas_rows, runs


@pytest.mark.parametrize("sq,sk,causal,window", SHAPES)
def test_dq_rows_and_walk_cover_each_valid_tile_once(maps, sq, sk, causal,
                                                     window):
    ctas, rows, runs = _dq(maps, sq, sk, causal, window)
    assert ctas == (sq // BQ + 1) // 2 == len(rows)
    owned = np.zeros(sq // BQ, int)
    walked = np.zeros_like(runs)
    for qi, first, n, *groups in rows:
        consumers = [(q_start, has) for q_start, has in zip(groups[::2],
                                                             groups[1::2])]
        need = np.zeros(sk // BK, bool)
        for cw, (q_start, has) in enumerate(consumers):
            assert q_start == 128 * qi + 64 * cw
            assert has == (q_start < sq)
            if not has:
                continue
            owned[q_start // BQ] += 1
            need |= runs[q_start // BQ].astype(bool)
            # every k-block of the CTA's walk feeds S, dP and dS K of this
            # consumer's rows once (a block without a valid score for them
            # adds exact zeros)
            walked[q_start // BQ, first:first + n] += 1
        # the walk is one contiguous run, exactly the k-blocks some row of
        # the CTA needs
        idx = np.flatnonzero(need)
        assert n == len(idx) and (n == 0 or (first == idx[0]
                                             and idx[-1] == first + n - 1))
    # each query row owned once (only the last CTA's second consumer can be
    # empty, when SQ % 128 == 64), each valid tile walked exactly once
    assert np.all(owned == 1)
    assert np.all(walked[runs.astype(bool)] == 1)
    assert np.all(walked <= 1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 34])
def test_dq_ring_never_overwrites_a_tile_in_use(maps, n):
    lines = [[int(x) for x in line.split()] for line in maps("ring", n)]
    slots = lines[0][0]
    assert slots == 3
    table = {(j, k): (tile, slot, parity)
             for j, k, tile, slot, parity in lines[1:]}
    tiles = sorted(t for t, _, _ in table.values())
    assert tiles == list(range(2 * n))  # each tile of the walk once
    of_tile = {tile: (slot, parity) for tile, slot, parity in table.values()}
    # V first: K stays longer (S and dq += dS K)
    for j in range(n):
        assert table[(j, 0)][0] < table[(j, 1)][0]
    # the full barrier's phase of a tile is its slot's fill count mod 2
    fills = {}
    for tile in range(2 * n):
        slot, parity = of_tile[tile]
        assert parity == fills.get(slot, 0) % 2
        fills[slot] = fills.get(slot, 0) + 1

    # the kernel's order: the producer loads tiles in order, tile t once
    # the consumers released tile t - slots (the same phase of its empty
    # barrier); a consumer's k-block j waits for K_j, then V_j (one turn),
    # releases V_j once dP is done and K_j once dq += dS K is done
    consumer = []
    for j in range(n):
        k_tile, v_tile = table[(j, 1)][0], table[(j, 0)][0]
        consumer += [("wait", k_tile), ("wait", v_tile),
                     ("release", v_tile), ("release", k_tile)]
    loaded, released, in_slot = set(), set(), {}
    produced, step = 0, 0
    while step < len(consumer) or produced < 2 * n:
        moved = False
        if produced < 2 * n and (produced < slots
                                 or produced - slots in released):
            slot = of_tile[produced][0]
            # the slot's tile before is released: nothing is overwritten
            assert in_slot.get(slot) in (None, *released)
            in_slot[slot] = produced
            loaded.add(produced)
            produced += 1
            moved = True
        if step < len(consumer):
            what, tile = consumer[step]
            if what == "release" or tile in loaded:
                if what == "wait":
                    assert in_slot[of_tile[tile][0]] == tile
                else:
                    released.add(tile)
                step += 1
                moved = True
        assert moved, "deadlock"
    assert released == set(range(2 * n))


def _dkv(maps):
    lines = maps("dkv")
    xchg_floats, total = map(int, lines[0].split())
    owners = [[int(x) for x in line.split()] for line in lines[1:3]]
    full = np.array([int(x) for x in lines[3].split()]).reshape(2, 16)
    xchg = np.array([[int(x) for x in line.split()] for line in lines[4:]])
    return xchg_floats, total, owners, full, xchg


def test_dkv_consumers_own_each_query_and_column_once(maps):
    _, _, owners, full, _ = _dkv(maps)
    queries, cols = np.zeros(BQ, int), np.zeros(D, int)
    for cw, q0, col0, _ in owners:
        queries[q0:q0 + 32] += 1  # the m64n32 score columns
        cols[col0:col0 + 128] += 1  # its dV, dK columns (m64n128)
    assert np.all(queries == 1) and np.all(cols == 1)
    # element i of consumer wg's half is element full[wg, i] of the m64n64
    # fragment: the same key row and query column for every lane class c
    q0 = {cw: q for cw, q, _, _ in owners}
    for wg in range(2):
        for i in range(16):
            big = full[wg, i]
            for c in range(4):
                assert (i // 2) % 2 == (big // 2) % 2  # the row half hh
                half_col = q0[wg] + 8 * (i // 4) + 2 * c + i % 2
                assert half_col == 8 * (big // 4) + 2 * c + big % 2
    assert sorted(full.ravel()) == list(range(32))


def test_dkv_exchange_is_a_bijection(maps):
    xchg_floats, total, owners, full, xchg = _dkv(maps)
    assert xchg_floats == 16 * 128 and total == 4 * xchg_floats
    regions = []
    for _, _, _, r in owners:
        regions += [r // 10, r % 10]
    assert sorted(regions) == [0, 1, 2, 3]  # P_drop^T and dS^T, each half
    at = np.array([[r * xchg_floats + xchg[t, i] for t in range(128)
                    for i in range(16)] for r in regions]).ravel()
    assert len(np.unique(at)) == at.size == total
    assert at.min() == 0 and at.max() == total - 1
    # float4s: a thread's 4 consecutive elements at 4 consecutive floats
    for t in range(128):
        for k in range(4):
            base = xchg[t, 4 * k]
            assert base % 4 == 0
            assert list(xchg[t, 4 * k:4 * k + 4]) == [base + e
                                                      for e in range(4)]

    # the protocol: both consumers write their halves, then each reads the
    # other's and places both with dkv_full: the same whole fragment
    rng = np.random.default_rng(3)
    whole = rng.standard_normal((2, 128, 32)).astype(np.float32)  # P, dS
    halves = np.empty((2, 2, 128, 16), np.float32)
    for wg in range(2):
        halves[:, wg] = whole[:, :, full[wg]]
    region = np.full(total, np.nan, np.float32)
    for qn in range(2):
        for cw, _, _, r in owners:
            reg = (r // 10, r % 10)[qn]
            for t in range(128):
                region[reg * xchg_floats + xchg[t]] = halves[qn, cw, t]
    for cw, _, _, _ in owners:
        other = 1 - cw
        r_other = owners[other][3]
        for qn in range(2):
            reg = (r_other // 10, r_other % 10)[qn]
            got = np.full((128, 32), np.nan, np.float32)
            for t in range(128):
                got[t, full[cw]] = halves[qn, cw, t]
                got[t, full[other]] = region[reg * xchg_floats + xchg[t]]
            assert np.array_equal(got, whole[qn])


@pytest.mark.parametrize("sq,sk,causal,window", SHAPES)
def test_dkv_walks_exactly_the_valid_q_blocks(maps, sq, sk, causal, window):
    runs = _dq(maps, sq, sk, causal, window)[2]
    lines = [[int(x) for x in line.split()]
             for line in maps("qrun", sq, sk, causal, window)]
    assert len(lines) == sk // BK
    for kb, (first, n) in enumerate(lines):
        walked = np.zeros(sq // BQ, int)
        walked[first:first + n] += 1
        # each valid (q-block, k-block) tile once, no other: S^T, dP^T, dV
        # and dK of the CTA's keys each issued once a walked q-block
        assert np.array_equal(walked, runs[:, kb])
