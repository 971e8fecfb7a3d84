"""The step maps of the split f32 flash kernels at head_dim 256, on the CPU.

``csrc/flash_fwd_f32.cu``'s and ``csrc/flash_dkv_f32.cu``'s D = 256
kernels run only on the card. Which 32-column slice each of their two
warpgroups splits at each step, which rows and columns of the score tile
and of the output each owns, where each exchanged element lands and which
q-blocks dkv walks are plain integer functions of ``csrc/flash_wide_map.cuh``
(with ``tile_runs`` of ``csrc/flash_common.cuh``). These tests compile that
header with g++ (skipped where there is no g++) and hold it, against a
numpy enumeration, to:

- every element of every walked tile (K and V in the forward; Q and dO in
  dkv's two walks) reaching each product that needs it exactly once (S^T
  once a walk), and each output column written by the warpgroup whose
  half it is;
- each exchange a bijection between the two warpgroups' fragments that
  puts every element at its place in the other's tile;
- dkv's walk covering the same valid (q-block, k-block) pairs as
  ``tile_runs``, which are the tiles holding a valid score (every tile
  when not causal: the JAX kernels skip blocks only then), and
  ``tile_full`` (no mask) holding for just the tiles whose scores are all
  valid.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_wide_split.py
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

// row and column of element i of thread t's m64nN fragment (the PTX ISA's
// wgmma layout, which the exchanges rely on)
static int frag_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
static int frag_col(int t, int i) { return 8 * (i / 4) + 2 * (t % 4) + i % 2; }

int main(int argc, char** argv) {
  if (!std::strcmp(argv[1], "frag")) {
    for (int t = 0; t < WG_THREADS; ++t)
      for (int i = 0; i < 32; ++i)
        std::printf("%d %d %d %d\n", t, i, frag_row(t, i), frag_col(t, i));
  } else if (!std::strcmp(argv[1], "fwd")) {
    std::printf("%d %d %d %d\n", FWD_STEPS, FWD_XCHG_FLOATS, FWD_KEEP_WORDS,
                SW);
    for (int wg = 0; wg < 2; ++wg)
      for (int r = 0; r < FWD_STEPS; ++r)
        std::printf("%d %d %d %d\n", wg, r, int(fwd_reads_v(r)),
                    fwd_slice(wg, r));
    for (int wg = 0; wg < 2; ++wg) std::printf("%d\n", fwd_keep_rows(wg));
    for (int wg = 0; wg < 2; ++wg)
      for (int t = 0; t < WG_THREADS; ++t) {
        std::printf("%d", fwd_keep_xchg(wg, t));
        for (int i = 0; i < 32; ++i) std::printf(" %d", fwd_xchg(wg, t, i));
        std::printf("\n");
      }
  } else if (!std::strcmp(argv[1], "dkv")) {
    std::printf("%d %d %d\n", DKV_XCHG_FLOATS, dkv_steps(false),
                dkv_steps(true));
    for (int r = 0; r < dkv_steps(true); ++r) {
      const int s = dkv_slice(r);
      std::printf("%d %d %d %d %d %d\n", r, dkv_phase(r),
                  int(dkv_reads_do(r)), s, dkv_owner(s), dkv_block(s));
    }
    for (int wg = 0; wg < 2; ++wg) {
      std::printf("%d", dkv_query0(wg));
      for (int i = 0; i < 16; ++i) std::printf(" %d", dkv_full(wg, i));
      std::printf("\n");
    }
    for (int t = 0; t < WG_THREADS; ++t) {
      for (int i = 0; i < 16; ++i) std::printf(" %d", dkv_xchg(t, i));
      std::printf("\n");
    }
  } else {  // run SQ SK causal window: q_run of each k-block, tile_runs
    const int sq = atoi(argv[2]), sk = atoi(argv[3]), causal = atoi(argv[4]),
              window = atoi(argv[5]);
    for (int ki = 0; ki < sk / BK; ++ki) {
      const Run run = q_run(ki * BK, sq, sk - sq, causal, window);
      std::printf("%d %d", run.first, run.n);
      for (int qi = 0; qi < sq / BQ; ++qi)
        std::printf(" %d %d", int(tile_runs(qi * BQ, ki * BK, sk - sq, causal,
                                            window)),
                    int(tile_full(qi * BQ, ki * BK, sk - sq, causal,
                                  window)));
      std::printf("\n");
    }
  }
  return 0;
}
"""

D, SW, HALF = 256, 32, 128


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """The host program over csrc/flash_wide_map.cuh, built with g++:
    args -> its output lines."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the maps are compiled from the CUDA headers")
    out = tmp_path_factory.mktemp("flash_wide_map")
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


def _frag(maps):
    """(t, i) -> (row, column) of an m64nN fragment."""
    rows = np.zeros((128, 32), int)
    cols = np.zeros((128, 32), int)
    for t, i, r, c in maps("frag"):
        rows[t, i], cols[t, i] = r, c
    return rows, cols


def test_fragment_layout_covers_the_tile_once(maps):
    rows, cols = _frag(maps)
    t = np.arange(128)[:, None]
    i = np.arange(32)[None, :]
    assert (rows == 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2)).all()
    assert (cols == 8 * (i // 4) + 2 * (t % 4) + i % 2).all()
    # each thread's 32 elements of an m64n64 tile, and all 128 threads',
    # cover it once
    seen = np.zeros((64, 64), int)
    np.add.at(seen, (rows, cols), 1)
    assert (seen == 1).all()


def test_fwd_steps_cover_k_and_v_once(maps):
    lines = maps("fwd")
    steps, xfloats, kwords, sw = lines[0]
    assert sw == SW and steps == 2 * HALF // SW
    # reads[tensor][wg, column of D]: how often a warpgroup's products get
    # that column of the k-block's K (score partials) or V (P V)
    reads = np.zeros((2, 2, D), int)
    for wg, r, is_v, s in lines[1:1 + 2 * steps]:
        assert 0 <= s < D // SW
        reads[is_v, wg, SW * s:SW * (s + 1)] += 1
    # K: the two partial sums together reduce over every column of D once
    assert (reads[0].sum(axis=0) == 1).all()
    # V: each column once, by the warpgroup whose output half holds it
    # (store_half: columns 128 wg ..), and each warpgroup's score partial
    # over its own half of D
    for wg in range(2):
        half = slice(HALF * wg, HALF * (wg + 1))
        assert (reads[1, wg, half] == 1).all()
        assert (reads[1, wg].sum() == HALF)
        assert (reads[0, wg, half] == 1).all()
    # K's steps first, then V's
    is_v = [line[2] for line in lines[1:1 + steps]]
    assert is_v == sorted(is_v)


def test_fwd_exchange_is_a_bijection(maps):
    lines = maps("fwd")
    steps, xfloats, kwords, _ = lines[0]
    keep_rows = [line[0] for line in lines[1 + 2 * steps:3 + 2 * steps]]
    assert sorted(keep_rows) == [0, 1]
    table = np.array(lines[3 + 2 * steps:])
    assert table.shape == (2 * 128, 33)
    keep, floats = table[:, 0], table[:, 1:]
    # every float and keep word of both warpgroups written by exactly one
    # (wg, t, i), float4s on 16 bytes
    assert sorted(floats.ravel()) == list(range(xfloats))
    assert sorted(keep) == list(range(kwords))
    assert (floats[:, 0::4] % 4 == 0).all()
    assert (np.diff(floats.reshape(-1, 8, 4), axis=2) == 1).all()
    # the reader (the other warpgroup's thread t) finds the writer's
    # element i there, at the same fragment position as its own element i
    by = floats.reshape(2, 128, 32)
    rows, cols = _frag(maps)
    for wg in range(2):
        at = {int(by[wg, t, i]): (rows[t, i], cols[t, i])
              for t in range(128) for i in range(32)}
        assert all(at[int(by[wg, t, i])] == (rows[t, i], cols[t, i])
                   for t in range(128) for i in range(32))


def test_dkv_walks_feed_every_product_once(maps):
    """The two walks of a q-block (dV, then dK): the steps of each, the
    first dkv_steps(dk) of the map."""
    lines = maps("dkv")
    xfloats, dv_steps, steps = lines[0]
    dk_steps = steps  # two slices a step
    assert steps == 3 * D // SW // 2 and dv_steps == 2 * D // SW // 2
    table = lines[1:1 + steps]
    q0 = {wg: lines[1 + steps + wg][0] for wg in range(2)}
    assert q0 == {0: 0, 1: 32}
    # need[product][wg]: how often each (row, column) of the walked q-block
    # reaches that warpgroup's product
    need = {p: np.zeros((2, 64, D), int) for p in ("st", "dpt", "dv", "dk")}
    slices = {"q": 0, "do": 0}
    for dv, dk in ((True, False), (False, True)):
        for r, phase, reads_do, s, owner, block in table[:dk_steps if dk
                                                          else dv_steps]:
            # a step's two slices side by side
            cols = slice(SW * s, SW * (s + 2))
            assert reads_do == (phase == 1)
            slices["do" if reads_do else "q"] += 2
            # the output columns of the step's 64-column block: its
            # owner's half holds both slices
            assert HALF * owner + 2 * SW * block == SW * s
            assert s // 4 == (s + 1) // 4
            for wg in range(2):
                mine = slice(q0[wg], q0[wg] + 32)
                if phase == 0:
                    need["st"][wg, mine, cols] += 1
                elif phase == 1:
                    if dk:
                        need["dpt"][wg, mine, cols] += 1
                    if dv and owner == wg:
                        need["dv"][wg, :, cols] += 1
                elif owner == wg:
                    need["dk"][wg, :, cols] += 1
    # Q three times (S^T twice, dK), dO twice (dV, dP^T)
    n = D // SW
    assert slices == {"q": 3 * n, "do": 2 * n}
    for wg in range(2):
        mine = np.zeros(64, bool)
        mine[q0[wg]:q0[wg] + 32] = True
        half = np.zeros(D, bool)
        half[HALF * wg:HALF * (wg + 1)] = True
        # the score products: the warpgroup's 32 queries over all of D
        # (S^T once a walk)
        for p, times in (("st", 2), ("dpt", 1)):
            assert (need[p][wg][mine] == times).all()
            assert (need[p][wg][~mine] == 0).all()
        # the output products: every query over the warpgroup's half
        for p in ("dv", "dk"):
            assert (need[p][wg][:, half] == 1).all()
            assert (need[p][wg][:, ~half] == 0).all()
    # the two output phases alternate their owners step by step
    for phase in (1, 2):
        owners = [line[4] for line in table if line[1] == phase]
        assert owners == [0, 1] * (len(owners) // 2)


def test_dkv_exchange_is_a_bijection(maps):
    lines = maps("dkv")
    xfloats, _, steps = lines[0]
    full = {wg: lines[1 + steps + wg][1:] for wg in range(2)}
    q0 = {wg: lines[1 + steps + wg][0] for wg in range(2)}
    slots = np.array(lines[3 + steps:])
    assert slots.shape == (128, 16)
    # one region: each (t, i) its own float, all of them used
    assert sorted(slots.ravel()) == list(range(xfloats))
    # the halves fill the m64n64 fragment once, each element at its
    # place: row unchanged, column the warpgroup's first query + its n32
    # column
    assert sorted(full[0] + full[1]) == list(range(32))
    rows, cols = _frag(maps)
    for wg in range(2):
        for i in range(16):
            j = full[wg][i]
            assert (rows[:, j] == rows[:, i]).all()
            assert (cols[:, j] == q0[wg] + cols[:, i]).all()


# (SQ, SK, causal, local window): recurrentgemma's LOCAL layer, a longer
# key range than query range (q_offset > 0), windows narrower than a
# tile, no mask
RUNS = [(4096, 4096, 1, 2048), (256, 256, 1, 0), (256, 256, 0, 0),
        (320, 448, 1, 128), (192, 192, 1, 40), (960, 1024, 1, 100),
        (512, 512, 1, 1), (256, 256, 0, 100)]


@pytest.mark.parametrize("sq,sk,causal,window", RUNS)
def test_dkv_walk_covers_the_valid_tiles(maps, sq, sk, causal, window):
    lines = maps("run", sq, sk, causal, window)
    assert len(lines) == sk // 64
    q_pos = np.arange(sq)[:, None] + (sk - sq)
    k = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), bool)
    if causal:
        valid &= k <= q_pos
    if window > 0:
        valid &= k > q_pos - window
    tiles = valid.reshape(sq // 64, 64, sk // 64, 64).any(axis=(1, 3))
    if not causal:  # the JAX kernels skip blocks only when causal
        tiles[:] = True
    # tiles with every score valid: no mask needed
    full = valid.reshape(sq // 64, 64, sk // 64, 64).all(axis=(1, 3))
    for ki, (first, n, *bits) in enumerate(lines):
        assert bits[0::2] == [int(x) for x in tiles[:, ki]]
        assert bits[1::2] == [int(x) for x in full[:, ki]]
        walked = np.zeros(sq // 64, bool)
        walked[first:first + n] = True
        assert (walked == tiles[:, ki]).all()
