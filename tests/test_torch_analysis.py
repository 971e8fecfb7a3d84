"""The static mask-safety verifier's counter layer in the port
(``repro_torch.analysis``) against the JAX package's, on the CPU.

Positive half: every shipped config x fixed site x gemm dtype lints clean
at topology 1 and 2 (premask consumption too), proven over the port's
kernel walks; for five configs the port's schedules and emissions are
JAX's (identity, shard windows, and the fused hosts' rectangles), and the
shard-window helpers are JAX's. Negative half: each of JAX's counter
mutations is caught by the rule JAX's lint names for it, and one mutation
for each CUDA walk (a CTA run shifted by one word, a Philox stride off by
one, a replay tile one packed row off) is caught too. The walks' integer
mirrors are held to the CUDA headers' own functions (g++). The counter
layer runs with kernels/build.py patched to raise, and
``compile_schedule(verify=True)`` raises on a corrupted stride. The lint
CLI's exit codes.

    PYTHONPATH=src python -m pytest -q tests/test_torch_analysis.py
"""
import dataclasses
import shutil
import subprocess

import pytest

from repro.analysis import counters as jcounters
from repro.analysis import lint as jlint
from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core.schedule import ShardInfo as JShardInfo
from repro.core.schedule import compile_schedule as j_compile
from repro.kernels import philox_common as jpc
from repro_torch import analysis
from repro_torch.analysis import counters, lint, rules
from repro_torch.config import get_arch, list_archs
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.schedule import compile_schedule
from repro_torch.kernels import build
from repro_torch.kernels import philox_common as pc

SITES = ("xla", "qkv", "prev_gemm", "ffn_up", "ffn_down")
DTYPES = ("f32", "bf16", "fp8")
B, S = lint.DEFAULT_BATCH, lint.DEFAULT_SEQ
TOPOLOGIES = lint.topology_shards(1) + lint.topology_shards(2)


def _plan(site, dtype="f32", replay="auto"):
    return DropoutPlanConfig(mode="overlap", p=0.1, site=site,
                             gemm_dtype=dtype, attn_replay=replay)


def _jshard(shard):
    return JShardInfo(**dataclasses.asdict(shard))


# ---------------------------------------------------------------- positive

@pytest.mark.parametrize("arch", list_archs())
def test_all_shipped_cells_lint_clean(arch):
    """Every fixed site x dtype x topology (1; 2 on a data and on a model
    axis) of the full-size config, under replay and premask consumption:
    clean, with checked emissions where the schedule is active."""
    cfg = get_arch(arch)
    for site in SITES:
        for dtype in DTYPES:
            for replay in ("auto", "off"):
                for shard in TOPOLOGIES:
                    if B % shard.batch_shards or \
                            cfg.n_heads % shard.head_shards:
                        continue
                    sched = compile_schedule(
                        cfg, _plan(site, dtype, replay), B, S,
                        attn_impl="pallas", shard=shard)
                    rep = counters.analyze_schedule(cfg, sched)
                    assert rep.ok, rep.render()
                    if sched.active:
                        assert rep.checked_emissions > 0


def _identity(em):
    return (em.producer_layer, em.target_layer, em.salt, em.site, em.how,
            em.dropped, tuple(dataclasses.astuple(w) for w in em.windows))


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-6b",
                                  "moonshot-v1-16b-a3b",
                                  "recurrentgemma-9b", "rwkv6-7b"])
def test_schedule_emissions_equal_jax(arch):
    """The port plans JAX's schedule (text and summary) for every fixed
    site x dtype x topology x replay knob, and its emissions are JAX's:
    (producer, target, salt, site, how, dropped, shard windows) in order,
    and the fused hosts' and tensor-op draw's rectangles and local plane
    rows."""
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    n_fused = n_active = 0
    for site in SITES:
        for dtype in DTYPES:
            for replay in ("auto", "off"):
                for shard in TOPOLOGIES:
                    kw = dict(mode="overlap", p=0.1, site=site,
                              gemm_dtype=dtype, attn_replay=replay)
                    sched = compile_schedule(
                        cfg, DropoutPlanConfig(**kw), B, S,
                        attn_impl="pallas", shard=shard)
                    jsched = j_compile(jcfg, JPlanConfig(**kw), B, S,
                                       attn_impl="pallas",
                                       shard=_jshard(shard))
                    assert sched.summary() == jsched.summary()
                    assert sched.explain() == jsched.explain()
                    n_active += sched.active
                    ems = counters.schedule_emissions(cfg, sched)
                    jems = jcounters.schedule_emissions(jcfg, jsched)
                    assert [_identity(e) for e in ems] == \
                        [_identity(e) for e in jems]
                    for em, jem in zip(ems, jems):
                        if em.how in ("gemm_rng", "gemm_rng_grouped",
                                      "xla"):
                            assert em.blocks == jem.blocks
                            assert em.rows_valid == jem.rows_valid
                            assert em.infeasible == jem.infeasible
                            n_fused += em.how != "xla"
    # rwkv6-7b has no attention layer: every schedule is inert
    assert n_fused > 0 or n_active == 0


def test_shard_window_helpers_equal_jax():
    for batch in (1, 2, 6, 8):
        for heads in (1, 4, 12, 96):
            for bs in (1, 2, 3, 4):
                for hs in (1, 2, 3, 4):
                    win = pc.shard_plane_windows(batch, heads, bs, hs)
                    assert win == jpc.shard_plane_windows(batch, heads, bs,
                                                          hs)
                    for off, b_loc, h_loc in win:
                        assert pc.shard_bh_intervals(
                            off, b_loc, h_loc, heads) == \
                            jpc.shard_bh_intervals(off, b_loc, h_loc, heads)


def test_replay_region_is_the_consumed_one():
    """At a LOCAL layer (recurrentgemma's window of 2048 at S = 4096) the
    flash kernels skip tiles above the diagonal and outside the window:
    the walks cover less than the plane and lint clean; a tile removed
    inside the consumed region is a gap (MS-C2)."""
    cfg = get_arch("recurrentgemma-9b")
    sched = compile_schedule(cfg, _plan("qkv"), 1, 4096, attn_impl="pallas")
    ems = counters.schedule_emissions(cfg, sched)
    rep = counters.analyze_schedule(cfg, sched)
    assert rep.ok, rep.render()
    local = [em for em in ems if em.how == "replay"
             and any(w.window for w in em.walks)]
    assert local
    em = local[0]
    for w in em.walks:
        area = sum((r1 - r0) * (c1 - c0) for _, r0, r1, c0, c1 in w.tiles)
        assert area < w.sq32 * w.sk
    w = em.walks[0]
    cut = dataclasses.replace(w, tiles=w.tiles[:len(w.tiles) // 2]
                              + w.tiles[len(w.tiles) // 2 + 1:])
    found = counters._check_tile_walk(em, cut)
    assert [f.rule for f in found] == [rules.EMISSION_GAP]


def test_walks_hold_at_other_grid_sizes():
    """The CTA and thread splits are proven for the H100's grids; they
    partition the plane at other grid sizes too (7 clusters, 7 CTAs)."""
    cfg = get_arch("llama2-7b")
    sched = compile_schedule(cfg, _plan("qkv"), B, S, attn_impl="pallas")
    em = next(e for e in counters.schedule_emissions(cfg, sched)
              if e.how == "gemm_rng")
    units = em.rows_valid * -(-em.sk // 32)
    for n in (1, 7, 14, 131):
        w = counters.CtaRuns("gemm_rng_bf16", 32, units,
                             counters.unit_share_runs(units, n))
        assert counters._check_cta_runs(em, w) == []
        words = em.rows_valid * em.sk
        w = counters.CtaRuns("gemm_rng", 1, words,
                             counters.emit_share_runs(words, n))
        assert counters._check_cta_runs(em, w) == []
        sw = counters.philox_walk(em.rows_valid, em.sk, sms=n, per_sm=1)
        assert counters._check_stride_walk(em, sw) == []


def test_proven_walk_is_checked_again_on_another_plane():
    """A walk proven against one emission is not taken as proven against
    an emission whose plane differs (a packed row fewer, a key fewer, a
    rectangle fewer): the checks read the plane as well as the walk, so
    the cached verdict is always the one a fresh check gives."""
    cfg = get_arch("llama2-7b")
    caught = set()
    for plan in [_plan("qkv", dtype) for dtype in DTYPES] + \
            [_plan("ffn_up", replay="off")]:
        sched = compile_schedule(cfg, plan, B, S, attn_impl="pallas")
        for em in counters.schedule_emissions(cfg, sched):
            for w in em.walks:
                assert counters._check_walk(em, w) == []
                for cut in (dict(rows_valid=em.rows_valid - 1),
                            dict(sk=em.sk - 1), dict(blocks=em.blocks[:-1])):
                    other = dataclasses.replace(em, **cut)
                    got = counters._check_walk(other, w)
                    fresh = counters._WALK_CHECKS[type(w)](other, w)
                    assert [f.render() for f in got] == \
                        [f.render() for f in fresh]
                    if got:
                        caught.add(type(w).__name__)
                assert counters._check_walk(em, w) == []
    assert caught == {"CtaRuns", "StrideWalk", "TileWalk"}


# ---------------------------------------------------------------- negative

def _emissions(site=lint.MUTATION_SITE, dtype="f32", replay="auto",
               shard=None):
    cfg = get_arch("yi-6b")
    sched = compile_schedule(cfg, _plan(site, dtype, replay), B, S,
                             attn_impl="pallas", shard=shard)
    return cfg, sched, counters.schedule_emissions(cfg, sched)


@pytest.mark.parametrize("kind", [k for k in jlint.MUTATIONS
                                  if k not in ("stride", "residual-leak")])
def test_jax_mutations_caught_by_jax_rule(kind):
    """Each of JAX's emission mutations is caught by the rule JAX's lint
    names for it."""
    shard = lint.topology_shards(2)[1] if kind == "reshard-window" else None
    cfg, sched, ems = _emissions(shard=shard)
    bad = counters.corrupt_emissions(ems, kind)
    found = counters.check_emissions(cfg, sched, bad)
    assert jlint._MUTATION_RULE[kind] == lint._MUTATION_RULE[kind]
    assert any(f.rule == jlint._MUTATION_RULE[kind] for f in found), \
        [f.render() for f in found]


def test_wrong_emit_stride_caught():
    """An off-by-one carried pipeline: reported as the linkage break
    (MS-C5), and verify_schedule raises it."""
    cfg = get_arch("yi-6b")
    sched = compile_schedule(cfg, _plan("ffn_up"), B, S, attn_impl="pallas")
    bad = counters.corrupt_schedule_stride(sched)
    rep = counters.analyze_schedule(cfg, bad)
    assert any(f.rule == rules.STRIDE_MISMATCH for f in rep.findings)
    with pytest.raises(analysis.MaskSafetyError) as ei:
        analysis.verify_schedule(cfg, bad)
    assert rules.STRIDE_MISMATCH in str(ei.value)


@pytest.mark.parametrize("kind,dtype", [
    ("cta-run-shift", "f32"), ("cta-run-shift", "bf16"),
    ("cta-run-shift", "fp8"), ("philox-stride", "f32"),
    ("replay-tile-row", "f32")])
def test_port_walk_mutations_caught(kind, dtype):
    """A CTA run one word on (the f32 / e4m3 ``emit_share`` and the bf16
    persistent units), the Philox walk's stride one past its threads, a
    replay tile one packed row down: each caught by its rule."""
    replay = "off" if kind == "philox-stride" else "auto"
    cfg, sched, ems = _emissions(dtype=dtype, replay=replay)
    assert counters.check_emissions(cfg, sched, ems) == []
    bad = counters.corrupt_emissions(ems, kind)
    found = counters.check_emissions(cfg, sched, bad)
    assert any(f.rule == lint._MUTATION_RULE[kind] for f in found), \
        [f.render() for f in found]


def test_verify_flag_raises_on_corrupted_stride(monkeypatch):
    """``compile_schedule(verify=True)`` proves its schedule: clean on the
    compiled one, MaskSafetyError (MS-C5) when the compiler hands back a
    corrupted stride."""
    cfg = get_arch("llama2-7b")
    assert compile_schedule(cfg, _plan("ffn_up"), B, S, attn_impl="pallas",
                            verify=True).active
    compile_ = schedule_mod._compile
    monkeypatch.setattr(schedule_mod, "_compile", lambda *a: counters
                        .corrupt_schedule_stride(compile_(*a)))
    with pytest.raises(analysis.MaskSafetyError) as ei:
        compile_schedule(cfg, _plan("ffn_up"), B, S, attn_impl="pallas",
                         verify=True)
    assert rules.STRIDE_MISMATCH in str(ei.value)


def test_counter_layer_builds_and_runs_no_kernel(monkeypatch):
    """The counter layer needs no kernel: with kernels/build.py patched to
    raise it proves fused, grouped, standalone and replay cells."""
    def boom(*a, **k):
        raise AssertionError("the counter layer touched kernels/build.py")

    for name in ("load", "compile_library", "build_all"):
        if hasattr(build, name):
            monkeypatch.setattr(build, name, boom)
    for arch, site, replay in (("yi-6b", "ffn_up", "auto"),
                               ("yi-6b", "ffn_up", "off"),
                               ("moonshot-v1-16b-a3b", "ffn_down", "auto"),
                               ("recurrentgemma-9b", "qkv", "auto")):
        cfg = get_arch(arch)
        sched = compile_schedule(cfg, _plan(site, "bf16", replay), B, S,
                                 attn_impl="pallas")
        rep = counters.analyze_schedule(cfg, sched)
        assert rep.ok and rep.checked_emissions > 0, rep.render()


# ------------------------------------------------------- the CUDA walks

PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include "flash_wide_map.cuh"
#include "gemm_walk.cuh"
#include "philox_walk.cuh"
using namespace repro_flash;

int main(int argc, char** argv) {
  const int a = std::atoi(argv[2]), b = std::atoi(argv[3]),
            c = std::atoi(argv[4]), d = std::atoi(argv[5]);
  if (!std::strcmp(argv[1], "flash")) {  // sq sk window (causal)
    for (int qi = 0; qi < a / BQ; ++qi)
      for (int ki = 0; ki < b / BK; ++ki)
        std::printf("t %d %d %d\n", qi, ki,
                    int(tile_runs(qi * BQ, ki * BK, b - a, 1, c)));
    for (int ki = 0; ki < b / BK; ++ki) {
      const wide_map::Run r = wide_map::q_run(ki * BK, a, b - a, 1, c);
      std::printf("q %d %d %d\n", ki, r.first, r.n);
    }
    for (int qi = 0; qi < (a / BQ + 1) / 2; ++qi) {
      const wide_map::Run r = wide_map::dq_bf16_k_run(qi, a, b, 1, c);
      std::printf("k %d %d %d\n", qi, r.first, r.n);
    }
  } else if (!std::strcmp(argv[1], "units")) {  // rows sk ctas
    const unsigned units = a * repro_gemm::walk::units_per_row(b);
    for (int t = 0; t < c; ++t) {
      const repro_gemm::walk::Share s =
          repro_gemm::walk::share_of(units, t, c);
      std::printf("%d %u %u\n", t, s.first, s.end);
    }
  } else {  // philox: rows sk sms per_sm
    const repro_philox::walk::Plane p =
        repro_philox::walk::plane_of(1, a, 1, b, a, 0);
    std::printf("%u %u\n", p.gpr,
                repro_philox::walk::launch_of(p, c, d).ctas);
  }
  return 0;
}
"""

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


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the walks are compiled from the CUDA headers")
    out = tmp_path_factory.mktemp("walks")
    (out / "cuda_runtime.h").write_text(STUB)
    src = out / "walks.cc"
    src.write_text(PROGRAM)
    exe = out / "walks"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{out}", f"-I{build.CSRC}",
                    "-o", str(exe), str(src)], check=True)

    def run(*args):
        res = subprocess.run([str(exe), *map(str, args)], check=True,
                             capture_output=True, text=True)
        return [line.split() for line in res.stdout.splitlines()]
    return run


@pytest.mark.parametrize("sq,sk,window", [(1024, 1024, 0), (960, 960, 0),
                                          (4096, 4096, 2048),
                                          (1024, 1024, 100),
                                          (512, 1024, 0)])
def test_flash_walk_mirrors_the_headers(walks, sq, sk, window):
    """``counters``' tile_runs, dkv's q-run and the bf16 dq's k-run at D =
    256 are the CUDA headers' (flash_common.cuh, flash_wide_map.cuh)."""
    t = counters.FLASH_TILE
    for kind, *vals in walks("flash", sq, sk, window, 0):
        vals = list(map(int, vals))
        if kind == "t":
            qi, ki, run = vals
            assert counters.tile_runs(qi * t, ki * t, sk - sq, True,
                                      window) == bool(run)
    dkv = counters._key_block_tiles(sq, sk, sk - sq, True, window)
    got = {}
    for kb, r0, *_ in dkv:
        got.setdefault(kb, []).append(r0 * 32 // t)
    for kind, *vals in walks("flash", sq, sk, window, 0):
        vals = list(map(int, vals))
        if kind == "q":
            kb, first, n = vals
            assert got.get(kb, []) == list(range(first, first + n))
    dq = counters._row_block_tiles(2, False, sq, sk, sk - sq, True, window)
    ks = {}
    for qi, r0, r1, c0, _ in dq:
        ks.setdefault(qi, set()).add(c0 // t)
    for kind, *vals in walks("flash", sq, sk, window, 0):
        vals = list(map(int, vals))
        if kind == "k":
            qi, first, n = vals
            assert sorted(ks.get(qi, ())) == list(range(first, first + n))


@pytest.mark.parametrize("rows,sk,ctas", [(8192, 1024, 132), (16, 97, 7),
                                          (96, 2048, 1), (3, 33, 5)])
def test_unit_and_philox_walks_mirror_the_headers(walks, rows, sk, ctas):
    """``unit_share_runs`` is gemm_walk.cuh's share_of, ``philox_walk`` its
    persistent grid (philox_walk.cuh launch_of)."""
    got = [(t, f, e) for t, f, e in counters.unit_share_runs(
        rows * -(-sk // 32), ctas)]
    want = [tuple(map(int, r)) for r in walks("units", rows, sk, ctas, 0)]
    assert got == want
    for sms, per_sm in ((132, 4), (7, 1)):
        gpr, want_ctas = map(int, walks("philox", rows, sk, sms, per_sm)[0])
        w = counters.philox_walk(rows, sk, sms=sms, per_sm=per_sm)
        assert (w.groups_per_row, w.threads) == (gpr, want_ctas * 256)


# -------------------------------------------------------------- the CLI

def test_lint_cli_single_cell_and_topologies(capsys):
    assert lint.main(["--config", "llama2-7b", "--site", "qkv", "--dtype",
                      "bf16", "--topologies", "1,2", "--jaxpr", "off"]) == 0
    out = capsys.readouterr().out
    assert "[ok]" in out and "topo=1x2(model)" in out
    assert "FAIL" not in out


def test_lint_cli_auto_and_layer2_not_ported(capsys):
    """site="auto" cells, once reported as not ported, are planned by the
    perf model and proven like a fixed site's, by the counter layer and
    by Layer 2 (the dataflow walk, once ported too); a mutation on an
    "auto" cell is caught; nothing says "not ported"."""
    assert lint.main(["--config", "yi-6b", "--site", "auto"]) == 0
    out = capsys.readouterr().out
    assert "not ported" not in out and "caught" not in out
    assert "[lint] 4 cells, 0 with findings" in out
    assert "yi-6b[reduced] site=auto" in out
    assert lint.main(["--config", "yi-6b", "--site", "auto", "--mutate",
                      "counter-overlap"]) == 1
    assert "caught by" in capsys.readouterr().out


@pytest.mark.parametrize("kind", lint.MUTATIONS)
def test_lint_cli_mutation_modes(kind, capsys):
    """``lint --mutate <kind>`` exits 1 with the matching rule named."""
    assert lint.main(["--config", "yi-6b", "--dtype", "f32", "--mutate",
                      kind]) == 1
    out = capsys.readouterr().out
    assert lint._MUTATION_RULE[kind] in out and "caught by" in out


def test_lint_cli_usage_error():
    with pytest.raises(SystemExit) as ei:
        lint.main(["--topologies", "0"])
    assert ei.value.code == 2


def test_lint_cell_skips_indivisible_topology():
    shard = schedule_mod.ShardInfo(batch_shards=3, batch_axes=("data",),
                                   policy_installed=True)
    assert lint.lint_cell("llama2-7b", "qkv", "f32", batch=B, seq=S,
                          shard=shard) is None


def test_sharded_schedule_does_not_run():
    """A schedule planned for a mesh this process does not hold (a bare
    ShardInfo) is analysis only: the forward refuses it without the
    policy it was planned for."""
    import torch

    from repro_torch.models import Runtime, forward, model_init
    from repro_torch.core.overlap import DropoutPlan
    cfg = get_arch("llama2-7b", reduced=True)
    sched = compile_schedule(cfg, _plan("qkv"), 2, 64, attn_impl="pallas",
                             shard=lint.topology_shards(2)[0])
    params = model_init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="under its policy"):
        forward(params, cfg, Runtime(plan=DropoutPlan(_plan("qkv")),
                                     attn_impl="pallas", schedule=sched),
                torch.zeros((2, 64), dtype=torch.int64))
