"""The walks of the persistent bf16 GEMM+RNG kernels, on the CPU.

``csrc/gemm_rng_bf16.cu`` (dense) and ``csrc/gemm_rng_grouped_bf16.cu``
(grouped) run only on the card, as instances of ``csrc/gemm_bf16.cuh``: a
persistent grid walking the output tiles in clusters of two CTAs on
neighbouring tile rows that share B by TMA multicast, 128 x 256 tiles,
and the dropout plane emitted in 32-word
units that the producer's warps and the consumer warps take from a counter
of each CTA's share. What decides that the kernels cover every tile and
every plane word exactly once is the plain integer code of
``csrc/gemm_walk.cuh`` (``REPRO_HD``), which these tests compile with g++
(skipped where there is no g++) and hold to:

- every (expert, tile row, tile column) taken exactly once by the
  persistent cluster walk, at the smoke's dense, grouped and ragged shapes
  and at the reduced models' host widths, on grids of 66 clusters (an
  H100's 132 SMs) and of 7;
- every word of each emission layout that the train path and the smoke
  plan (the layout's rectangles tile the plane) written exactly once by
  the units of all CTAs' shares, whichever warp takes a unit; and on small
  planes the words themselves, made by the header's Philox on the host,
  bitwise the port's plain version and JAX's reference;

and, with the ``fake_card`` pattern of ``tests/test_torch_gemm_tc.py``,
that bf16 operands still reach the unchanged entry points with their
unchanged argument lists, and nothing selects a design at run time.

    PYTHONPATH=src python -m pytest -q tests/test_torch_gemm_bf16_tc.py
"""
import contextlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.ref import philox_mask_ref
from repro_torch.config import get_arch
from repro_torch.core.producer import pick_gemm_blocks
from repro_torch.kernels import build
from repro_torch.kernels import gemm_rng as tg
from repro_torch.kernels.philox_common import seed_salt_words

BF16 = torch.bfloat16
SMS = 132  # an H100 SXM's SMs: the persistent grid
# the smoke's bf16 host calls (chip_smoke.py FP8_SHAPES, GROUPED_SHAPES,
# BF16_RAGGED): grouped, (E, M, K, N), logical blocks (None: the model
# path's pick_gemm_blocks), plane (B, H, SQ, SK)
DENSE_PLANE = (2, 32, 2048, 2048)
SMOKE = {
    "qkv": (False, (1, 4096, 4096, 12288), None, DENSE_PLANE),
    "out_proj": (False, (1, 4096, 4096, 4096), None, DENSE_PLANE),
    "gate_up": (False, (1, 4096, 4096, 22016), None, DENSE_PLANE),
    "down": (False, (1, 4096, 11008, 4096), None, DENSE_PLANE),
    "moe_gate": (True, (64, 480, 2048, 1408), None, (2, 16, 2048, 2048)),
    "moe_down": (True, (64, 480, 1408, 2048), None, (2, 16, 2048, 2048)),
    "channel_mix": (True, (1, 4096, 4096, 14336), None, DENSE_PLANE),
    "ragged_dense": (False, (1, 2904, 1000, 2776), (264, 2776, 1000),
                     (1, 3, 96, 200)),
    "ragged_grouped": (True, (9, 300, 520, 1144), (150, 1144, 520),
                       (1, 3, 96, 200)),
}

WALK_PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include "gemm_walk.cuh"
using namespace repro_gemm;

// tiles E M N G: the tile's N, the tile rows and columns, the clusters of
// a persistent grid on G SMs and the cluster size, then "cta ex mt nt" for
// every tile each CTA takes (mt past the tile rows: a rank with no rows)
static int tiles(int E, int M, int N, int G) {
  const int bn = walk::BN;
  const int tm = (M + walk::BM - 1) / walk::BM, tn = (N + bn - 1) / bn;
  const int ct = E * walk::cluster_rows(tm) * tn;
  const int most = G / walk::CLUSTER;
  const int clusters = ct < most ? ct : most;
  std::printf("%d %d %d %d %d\n", bn, tm, tn, clusters, walk::CLUSTER);
  for (int c = 0; c < clusters; ++c)
    for (int t = c; t < ct; t += clusters)
      for (int r = 0; r < walk::CLUSTER; ++r) {
        const walk::Tile at = walk::cta_tile(t, r, tm, tn);
        std::printf("%d %d %d %d\n", c * walk::CLUSTER + r, at.ex, at.mt,
                    at.nt);
      }
  return 0;
}

// plane rows sk sq32 G heads_local heads_global bh_offset salt k0 k1
// threshold print: every CTA's share of units as the share's counter
// hands them out -- in order, whichever producer or consumer warp asks --
// each unit's 32 lanes writing as the kernel's emit_unit does; prints the
// least and most writes of a word, then (print = 1) the words
static int plane(char** v) {
  const uint32_t rows = atoi(v[0]), sk = atoi(v[1]), sq32 = atoi(v[2]);
  const int G = atoi(v[3]);
  const uint32_t hl = strtoul(v[4], 0, 10), hg = strtoul(v[5], 0, 10),
                 off = strtoul(v[6], 0, 10), salt = strtoul(v[7], 0, 10),
                 k0 = strtoul(v[8], 0, 10), k1 = strtoul(v[9], 0, 10),
                 thr = strtoul(v[10], 0, 10);
  const int print = atoi(v[11]);
  std::vector<uint32_t> words(size_t(rows) * sk, 0);
  std::vector<unsigned char> writes(size_t(rows) * sk, 0);
  const uint32_t units = rows * walk::units_per_row(sk);
  for (int cta = 0; cta < G; ++cta) {
    const walk::Share sh = walk::share_of(units, cta, G);
    for (uint32_t counter = 0;; ++counter) {
      const uint32_t u = sh.first + counter;
      if (u >= sh.end) break;
      const walk::Unit at = walk::unit_at(u, sk, sq32);
      for (uint32_t lane = 0; lane < 32; ++lane) {
        const uint32_t c = at.c0 + lane;
        if (c >= sk) continue;
        const size_t i = size_t(at.row) * sk + c;
        writes[i] += 1;
        if (print)
          words[i] = walk::word_at<7>(
              c, at.q, repro_philox::global_bh(at.lbh, hl, hg, off), salt,
              k0, k1, thr);
      }
    }
  }
  unsigned lo = 255, hi = 0;
  for (unsigned char w : writes) {
    lo = w < lo ? w : lo;
    hi = w > hi ? w : hi;
  }
  std::printf("%u %u\n", lo, hi);
  if (print)
    for (uint32_t w : words) std::printf("%u\n", w);
  return 0;
}

int main(int argc, char** argv) {
  const std::string mode = argv[1];
  if (mode == "tiles")
    return tiles(atoi(argv[2]), atoi(argv[3]), atoi(argv[4]), atoi(argv[5]));
  return plane(argv + 2);
}
"""


@pytest.fixture(scope="module")
def walker(tmp_path_factory):
    """The host program over csrc/gemm_walk.cuh, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the walks are compiled from the CUDA header")
    out = tmp_path_factory.mktemp("gemm_walk")
    src = out / "walk.cc"
    src.write_text(WALK_PROGRAM)
    exe = out / "walk"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{build.CSRC}", "-o",
                    str(exe), str(src)], check=True)

    def run(*args) -> list:
        res = subprocess.run([str(exe), *map(str, args)], check=True,
                             capture_output=True, text=True)
        return res.stdout.split("\n")[:-1]
    return run


def _reduced_host_shapes():
    """(E, M, K, N) of the bf16 hosts of the reduced models' train path at
    B = 2, S = 256 (512 tokens): QKV, out-projection, gate+up, down, and
    the grouped expert gate / down at capacity 192 and 200 (an expert's
    rows not a multiple of the 128-row tile)."""
    shapes = set()
    tokens = 512
    for arch in ("llama2-7b", "yi-6b", "moonshot-v1-16b-a3b", "arctic-480b",
                 "rwkv6-7b"):
        cfg = get_arch(arch, reduced=True)
        d, hd = cfg.d_model, cfg.head_dim
        qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        for k, n in ((d, qkv), (cfg.n_heads * hd, d), (d, 2 * cfg.d_ff),
                     (cfg.d_ff, d), (d, cfg.d_ff)):
            shapes.add((1, tokens, k, n))
        if cfg.moe is not None:
            ff = cfg.moe.d_ff_expert
            for cap in (192, 200):
                shapes.add((cfg.moe.n_experts, cap, d, 2 * ff))
                shapes.add((cfg.moe.n_experts, cap, ff, d))
    return sorted(shapes)


TILE_SHAPES = ([(name, s[1]) for name, s in SMOKE.items()]
               + [(f"reduced_{'x'.join(map(str, s))}", s)
                  for s in _reduced_host_shapes()])


@pytest.mark.parametrize("sms", [SMS, 14])
@pytest.mark.parametrize("name,shape", TILE_SHAPES,
                         ids=[n for n, _ in TILE_SHAPES])
def test_bf16_persistent_walk_takes_every_tile_once(walker, name, shape,
                                                    sms):
    """Cluster c of a persistent grid of G clusters (two CTAs on
    neighbouring tile rows of one column) takes cluster tiles c, c + G, ...;
    together the CTAs take every (expert, tile row, tile column) of the
    launch exactly once, each CTA one more or one fewer than the others.
    Only the last cluster row of an odd number of tile rows has a rank
    with no rows (it loads B for its neighbour and stores nothing)."""
    e, m, _, n = shape
    lines = walker("tiles", e, m, n, sms)
    bn, tm, tn, clusters, size = map(int, lines[0].split())
    assert (bn, size) == (256, 2)
    assert (tm, tn) == (-(-m // 128), -(-n // bn))
    rows_c = -(-tm // size)
    assert clusters == min(sms // size, e * rows_c * tn)
    taken = np.array([list(map(int, ln.split())) for ln in lines[1:]])
    cta, tiles = taken[:, 0], taken[:, 1:]
    real = tiles[:, 1] < tm
    assert ((tiles >= 0) & (tiles < [e, rows_c * size, tn])).all()
    assert real.sum() == e * tm * tn
    assert len({tuple(t) for t in tiles[real]}) == e * tm * tn
    assert (~real).sum() == e * tn * (rows_c * size - tm)
    per_cta = np.bincount(cta, minlength=clusters * size)
    assert len(per_cta) == clusters * size
    assert per_cta.max() - per_cta.min() <= 1


def _layout(grouped, shape, blocks, plane):
    """The fused call's emission (JAX's layout on its logical grid)."""
    e, m, k, n = shape
    lead = (e,) if grouped else ()
    a = torch.zeros((*lead, m, k), dtype=BF16)
    b = torch.zeros((*lead, k, n), dtype=BF16)
    blocks = blocks or pick_gemm_blocks(m, n, k)
    mb, mh, sq, sk = plane
    _, em = tg._emission(a, b, mb, mh, sq, sk, 0.1, 77, 5, 7, *blocks, 2048,
                         256, 0, 0, grouped=grouped)
    return em


def _reduced_layouts():
    """The reduced models' train-path planes (B = 2, 4 heads, S = 64 / 128
    / 256) on their QKV host's logical grid."""
    out = []
    for s in (64, 128, 256):
        shape = (1, 2 * s, 64, 192)
        out.append((f"reduced_s{s}", False, shape, None, (2, 4, s, s)))
    return out


LAYOUTS = [(name, *case) for name, case in SMOKE.items()] \
    + _reduced_layouts()


def _rectangle_writes(em) -> np.ndarray:
    lay = em.layout
    count = np.zeros((lay.rows_valid, lay.sk), dtype=np.int64)
    for _, r0, r1, c0, c1 in lay.blocks():
        count[r0:r1, c0:c1] += 1
    return count


@pytest.mark.parametrize("grid", [SMS, 7])
@pytest.mark.parametrize("name,grouped,shape,blocks,plane", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
def test_bf16_plane_units_write_every_word_once(walker, name, grouped, shape,
                                                blocks, plane, grid):
    """The layout's rectangles tile the plane once, and the units of every
    CTA's share -- taken by whichever warp -- write each of its words
    exactly once."""
    em = _layout(grouped, shape, blocks, plane)
    assert em is not None and tg.layout_tiles_plane(em.layout)
    assert (_rectangle_writes(em) == 1).all()
    lay = em.layout
    lo, hi = map(int, walker("plane", lay.rows_valid, lay.sk, em.sq32, grid,
                             em.heads_local, em.heads_global, em.bh_offset,
                             em.salt, em.key_lo, em.key_hi, em.threshold,
                             0)[0].split())
    assert (lo, hi) == (1, 1)


@pytest.mark.parametrize("case", [
    ((1, 3, 96, 200), 0, 0),     # the smoke's ragged plane
    ((2, 4, 64, 24), 0, 0),      # rows shorter than a unit
    ((2, 4, 128, 128), 8, 12),   # shard-local: 4 of 8 heads, offset
])
def test_bf16_unit_words_equal_plain_and_jax(walker, case):
    """The words the units make with the header's Philox on the host are
    bitwise the port's plain plane (and, unsharded, JAX's
    ``philox_mask_ref``)."""
    (mb, mh, sq, sk), heads_global, offset = case
    seed, salt, p = 2 ** 33 + 5, 9, 0.1
    k0, k1, salt_w, off = seed_salt_words(seed, salt, offset)
    em = tg._Emission(
        layout=tg.mask_emission_layout(64, mb, mh, sq, sk), sq32=sq // 32,
        heads_local=mh, heads_global=heads_global or mh, key_lo=k0,
        key_hi=k1, salt=salt_w, bh_offset=off,
        threshold=tg.threshold_from_p(p), rounds=7)
    lay = em.layout
    lines = walker("plane", lay.rows_valid, sk, em.sq32, 5, em.heads_local,
                   em.heads_global, em.bh_offset, em.salt, em.key_lo,
                   em.key_hi, em.threshold, 1)
    assert lines[0] == "1 1"   # every word written once
    got = np.array(lines[1:], dtype=np.uint64).astype(np.uint32)
    want = tg._plain_plane(em, "cpu").numpy().view(np.uint32).reshape(-1)
    assert np.array_equal(got, want)
    if not heads_global and not offset:
        ref = np.asarray(philox_mask_ref(mb, mh, sq, sk, p, seed, salt))
        assert np.array_equal(got, ref.reshape(-1))


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors routed as if they lay on the card: the wrappers' device
    check says CUDA, and each entry point records its arguments instead
    of launching (tests/test_torch_gemm_tc.py's pattern)."""
    calls = []

    def kernel_fn(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tg, "_check_device", lambda a, name: True)
    monkeypatch.setattr(tg, "_kernel_fn", kernel_fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    return calls


@pytest.mark.parametrize("grouped", [False, True])
def test_bf16_wrappers_reach_unchanged_entry_points(grouped, fake_card):
    """bf16 operands reach repro_gemm_rng_bf16 / repro_gemm_rng_grouped_bf16
    with the argument lists they always had (operands, sizes, the
    emission's sixteen), emission on and off, N = 1400 included (not a
    multiple of the 256-column tile); the libraries are instances of the
    persistent body, with no switch or environment variable and no
    instance left in the f32 body."""
    name = tg.KERNEL_GROUPED_BF16 if grouped else tg.KERNEL_BF16
    lib, entry, n_ptrs, n_ints = tg._ENTRY[name]
    assert (lib, entry, n_ptrs, n_ints) == (name, f"repro_{name}", 3,
                                            4 if grouped else 3)
    csrc = Path(build.CSRC)
    src = (csrc / f"{lib}.cu").read_text()
    params = ("const void* a, const void* b, void* c, int E, int M, int N, "
              "int K," if grouped else
              "const void* a, const void* b, void* c,")
    assert f'extern "C" int {entry}(' in src
    assert " ".join(src.split(f"{entry}(")[1].split()).startswith(params)
    assert '#include "gemm_bf16.cuh"' in src
    assert f"bf16::run<{'true' if grouped else 'false'}>" in src
    body = (csrc / "gemm_bf16.cuh").read_text()
    assert '#include "gemm_walk.cuh"' in body
    assert "launch_rounds<walk::BN, GROUPED>" in body
    assert "getenv" not in body + src
    assert "Bf16Ops" not in (csrc / "gemm_tc.cuh").read_text()
    fn = tg.gemm_with_rng_grouped if grouped else tg.gemm_with_rng
    lead = (3,) if grouped else ()
    a = torch.zeros((*lead, 200, 64), dtype=BF16)
    b = torch.zeros((*lead, 64, 1400), dtype=BF16)
    kw = dict(mask_batch=1, mask_heads=2, mask_sq=64, mask_sk=64, p=0.1,
              seed=7, salt=3, block_m=100, block_n=280, block_k=64)
    c, mask = fn(a, b, **kw)
    c3, none = fn(a, b, **dict(kw, block_m=200, block_n=1400,
                               mask_heads=32, mask_sq=1024, mask_sk=1024))
    assert none is None and mask is not None
    assert [n for n, _ in fake_card] == [name, name]
    on, off = (args for _, args in fake_card)
    lead_args = ((a.data_ptr(), b.data_ptr(), c.data_ptr(), 3, 200, 1400, 64)
                 if grouped else
                 (a.data_ptr(), b.data_ptr(), c.data_ptr(), 200, 1400, 64))
    assert on[:len(lead_args)] == lead_args
    assert off[len(lead_args) - 3:len(lead_args)] == lead_args[-3:]
    n_args = n_ptrs + n_ints + len(tg._EMIT_ARGTYPES)
    assert len(on) == len(off) == n_args == (24 if grouped else 23)
    em_args = on[len(lead_args):]
    assert em_args[0] == mask.data_ptr() and em_args[-2] == 7
    assert off[len(lead_args)] is None and off[-2] == 7
    assert c.dtype == c3.dtype == BF16
