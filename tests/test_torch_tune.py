"""The port's autotuner (``repro_torch.tune``) and kernel cost features
(``repro_torch.roofline.counts``) on the CPU: JAX's ``tests/test_tune.py``
cases mirrored.

Tuned-table persistence, the ``tuned_torch/v1`` schema and the refusal
of the JAX package's ``TUNED.json``, the hooks' defaults, install /
overlay / uninstall, the producer's tuned lookups, the calibrated
ranking and its skipping of sites a tuned column block puts in Region 3; the calibration fit (NNLS, a fit that beats the closed form on
synthetic cells, a calibrated Hardware needs a source); the search space
(the shipped defaults, aligned divisors, legal neighbours, the flash
coordinate's one value, an illegal point scores inf); gate 1 rejecting
``philox_bits=8`` and every gate admitting the default, on the plain
versions; the shipped ``TUNED_torch.json`` consistent with the code that
wrote it; ``python -m repro_torch.tune --smoke``; the FLOP counter's
formulas for the kernel operators.

    PYTHONPATH=src python -m pytest -q tests/test_torch_tune.py
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.perfmodel.hardware import GH100, Hardware
from repro_torch.roofline import counts
from repro_torch.tune import __main__ as tune_main
from repro_torch.tune import calibrate as cal_mod
from repro_torch.tune import search, space
from repro_torch.tune.tables import (
    DEFAULT_PATH,
    Calibration,
    TunedCell,
    TunedTable,
    active_blocks,
    active_hardware,
    active_mask_cols,
    cell_key,
    install,
    installed,
    load_default,
    overlay,
    uninstall,
)

_CAL = Calibration(source="test", mma_flops=1e12, hbm_bw=1e11,
                   nonmma_ops=1e10, rng_interference=1.4,
                   gemm_interference=1.2, step_overhead=1e-6,
                   residual_closed_form=1.0, residual_calibrated=0.2,
                   n_cells=3)
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _no_table_leak():
    """Every test starts and ends with no tuned table installed."""
    uninstall()
    yield
    uninstall()


# -- tables ---------------------------------------------------------------

def test_table_roundtrip(tmp_path):
    t = TunedTable(
        calibration=_CAL,
        gemm_blocks={(256, 192, 64): (64, 192, 64)},
        mask_cols={(128, 128): 64},
        cells={"a|b2s128|f32|1x1": TunedCell(
            key="a|b2s128|f32|1x1", site="prev_gemm",
            default_site="ffn_up", predicted_s=1.0, default_s=2.0,
            proof={"verify": True}, measured_on="a b2 s128 on cpu")},
        residuals=[{"arch": "a", "measured_s": 1.0}])
    p = os.path.join(tmp_path, "t.json")
    t.save(p)
    t2 = TunedTable.load(p)
    assert t2.gemm_blocks == t.gemm_blocks
    assert t2.mask_cols == t.mask_cols
    assert t2.cells["a|b2s128|f32|1x1"].site == "prev_gemm"
    assert t2.calibration == _CAL
    assert t2.residuals == t.residuals
    assert t2.hardware().is_calibrated
    assert t2.hardware().name == "GH100-cal"


def test_table_rejects_unknown_schema_and_jax_s_table(tmp_path):
    p = os.path.join(tmp_path, "bad.json")
    with open(p, "w") as f:
        json.dump({"schema": "tuned_torch/v999"}, f)
    with pytest.raises(ValueError, match="schema"):
        TunedTable.load(p)
    # the JAX package's table: CPU interpret calibration, Pallas grids
    with pytest.raises(ValueError, match="JAX package's tuned table"):
        TunedTable.load(os.path.join(ROOT, "TUNED.json"))
    assert load_default(os.path.join(tmp_path, "none.json")) is None
    assert installed() is None


def test_table_lookups_revalidate_legality():
    """A hand-edited table can only fall back to the defaults, never hand
    a kernel an illegal grid."""
    t = TunedTable(
        gemm_blocks={(256, 192, 64): (60, 192, 64),    # 60 not 8-aligned
                     (128, 128, 64): (256, 128, 64)},  # 256 > m
        mask_cols={(128, 128): 48})                    # 48 !| 128
    assert t.blocks_for(256, 192, 64) is None
    assert t.blocks_for(128, 128, 64) is None
    assert t.mask_cols_for(128, 128) is None


def test_cell_key_buckets_pow2():
    assert cell_key("a", 256, 4096, "f32") == "a|b256s4096|f32|1x1"
    assert cell_key("a", 200, 3000, "f32") == "a|b256s4096|f32|1x1"
    assert cell_key("a", 1, 1, "bf16", "2x16") == "a|b1s1|bf16|2x16"


def test_hooks_default_without_table():
    assert installed() is None
    assert active_blocks(256, 192, 64) is None
    assert active_mask_cols(128, 128) == 2048
    assert active_hardware() is None


def test_calibrations_by_dtype():
    """A host dtype's calibration ranks that dtype's plans; a dtype with
    none takes the one for every dtype, else the closed form."""
    bf16 = dataclasses.replace(_CAL, source="bf16", mma_flops=6e12)
    t = TunedTable(calibrations={"bf16": bf16})
    assert t.hardware("bf16").mma_flops == 6e12
    assert t.hardware("f32") is None and t.calibration is None
    install(TunedTable(calibration=_CAL, calibrations={"bf16": bf16}))
    assert active_hardware("bf16").mma_flops == 6e12
    assert active_hardware("f32").mma_flops == _CAL.mma_flops
    cfg = get_arch("llama2-7b")
    for dtype, cal in (("bf16", bf16), ("f32", _CAL)):
        plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1,
                                             site="auto", gemm_dtype=dtype))
        assert producer.rank_host_sites(cfg, plan, 2, 2048) == \
            producer.rank_host_sites(cfg, plan, 2, 2048, hw=cal.hardware())


def test_install_overlay_uninstall():
    t = TunedTable(calibration=_CAL, mask_cols={(128, 128): 64})
    install(t)
    assert installed() is t
    assert active_mask_cols(128, 128) == 64
    assert active_hardware().is_calibrated
    with overlay(None):
        assert active_mask_cols(128, 128) == 2048
    assert active_mask_cols(128, 128) == 64
    uninstall()
    assert installed() is None


# -- producer plumbing ----------------------------------------------------

def test_producer_resolves_tuned_values():
    """The planner's resolvers consult the active table; the kernels'
    wrappers, the schedule compiler and the verifier all resolve through
    them."""
    m, n, k = 256, 192, 64
    default = producer.pick_gemm_blocks(m, n, k)
    t = TunedTable(gemm_blocks={(m, n, k): (64, 192, 64)},
                   mask_cols={(128, 128): 64})
    with overlay(t):
        assert producer.pick_gemm_blocks(m, n, k) == (64, 192, 64)
        assert producer.mask_cols_cap(128, 128) == 64
        assert producer.mask_cols_cap(64, 64) == 2048   # not in the table
    assert producer.pick_gemm_blocks(m, n, k) == default
    assert producer.mask_cols_cap(128, 128) == 2048


def test_rank_host_sites_uses_calibrated_hw_from_table():
    """A calibrated table switches the ranking to the net-cost objective;
    without one the closed-form GH100 headroom ranks."""
    cfg = get_arch("llama2-7b")
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1,
                                         site="auto"))
    closed = producer.rank_host_sites(cfg, plan, 256, 4096)
    with overlay(TunedTable(calibration=_CAL)):
        cal = producer.rank_host_sites(cfg, plan, 256, 4096)
    assert closed and cal
    assert {s for s, _ in closed} == {s for s, _ in cal}
    # calibrated scores are negated costs (<= 0); headroom scores are not
    assert all(score <= 0.0 for _, score in cal)
    assert closed == producer.rank_host_sites(cfg, plan, 256, 4096,
                                              hw=GH100)


def test_rank_host_sites_skips_sites_in_region_3():
    """A tuned column block that puts a site's GEMM in Region 3 takes the
    site out of the ranking while another site can host the plane, under
    both objectives (llama2-7b at B=2, S=2048: 64 columns leave the
    out-projection and down-projection grids too small), so site="auto"
    resolves to a site whose host runs under replay and premask alike;
    with the shipped column block all four rank."""
    from repro_torch.core.schedule import compile_schedule
    cfg = get_arch("llama2-7b")
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1,
                                         site="auto"))
    assert {s for s, _ in producer.rank_host_sites(cfg, plan, 2, 2048)} \
        == {"qkv", "prev_gemm", "ffn_up", "ffn_down"}
    for table in (TunedTable(mask_cols={(2048, 2048): 64}),
                  TunedTable(calibration=_CAL,
                             mask_cols={(2048, 2048): 64})):
        with overlay(table):
            ranked = producer.rank_host_sites(cfg, plan, 2, 2048)
            assert {s for s, _ in ranked} == {"qkv", "ffn_up"}
            for replay in ("auto", "off"):
                sched = compile_schedule(cfg, dataclasses.replace(
                    plan.cfg, attn_replay=replay), 2, 2048,
                    attn_impl="pallas")
                assert sched.resolved_site == ranked[0][0]
                assert "Region 3" not in sched.explain()


# -- calibration fit ------------------------------------------------------

def test_nnls_nonnegative():
    rng = np.random.default_rng(3)
    A = rng.uniform(0.1, 1.0, (12, 4))
    theta_true = np.array([2.0, 0.0, 1.0, 3.0])
    theta = cal_mod._nnls(A, A @ theta_true)
    assert (theta >= 0).all()
    np.testing.assert_allclose(theta, theta_true, atol=1e-8)


def _synthetic_measurement(m, n, k, t_scale=1.0, e=1):
    mask = (2, 4, 128, 128)
    elems = float(np.prod(mask))
    flops = 2.0 * e * m * n * k
    t_dot = flops / 1e10 * t_scale
    t_rng = elems * 10.0 / 1e8 * t_scale
    return cal_mod.Measurement(
        arch="synth", site="qkv", m=m, n=n, k=k, mask=mask, rounds=7,
        dtype_bytes=4, n_steps=4, rng_steps=2, t_dot=t_dot,
        t_rng=t_rng, t_fused=1.2 * t_dot + 0.5 * t_rng, features={}, e=e)


def test_fit_beats_closed_form_on_synthetic_cells():
    ms = [_synthetic_measurement(256, 192, 64),
          _synthetic_measurement(256, 64, 64),
          _synthetic_measurement(256, 256, 64),
          _synthetic_measurement(512, 128, 128),
          _synthetic_measurement(128, 64, 64, e=4)]
    cal = cal_mod.fit(ms, source="synthetic")
    assert cal.n_cells == 5
    assert cal.residual_calibrated < cal.residual_closed_form
    hw = cal.hardware()
    assert hw.is_calibrated and hw.calibrated_against == "synthetic"
    rows = cal_mod.residual_rows(ms, cal)
    assert len(rows) == 5
    assert all(r["rel_err_calibrated"] < r["rel_err_closed_form"]
               for r in rows)
    # the rows carry their measurements: a refit gives the same table
    again = cal_mod.fit(cal_mod.recorded_measurements(
        json.loads(json.dumps(rows))), source="synthetic")
    assert again == cal


def test_calibrated_hardware_requires_source():
    with pytest.raises(ValueError, match="source"):
        Hardware.calibrated(
            GH100, mma_flops=1e12, hbm_bw=1e11, nonmma_ops=1e10,
            rng_interference=1.4, gemm_interference=1.2,
            step_overhead=0.0, source="")


def test_cell_shapes_are_the_smoke_training_shapes():
    cells = {(a, s): (g, m) for a, s, g, m in cal_mod.cell_shapes()}
    assert cells[("llama2-7b", "qkv")] == ((1, 4096, 12288, 4096),
                                           (2, 32, 2048, 2048))
    assert cells[("llama2-7b", "ffn_up")][0] == (1, 4096, 22016, 4096)
    assert cells[("llama2-7b", "ffn_down")][0] == (1, 4096, 4096, 11008)
    assert cells[("moonshot-v1-16b-a3b", "ffn_up")] == (
        (64, 480, 1408, 2048), (2, 16, 2048, 2048))
    assert len(cells) == 5


# -- search space ---------------------------------------------------------

def test_default_point_matches_shipped_producer_defaults():
    m, n, k = 256, 192, 64
    p = space.default_point(m, n, k, 128, 128)
    assert p.blocks == producer.pick_gemm_blocks(m, n, k)
    assert p.mask_cols == 2048
    assert p.flash == (64, 64)
    assert p.philox_bits == 32


def test_divisor_choices_aligned():
    assert space.divisor_choices(192, 256) == [8, 16, 24, 32, 48, 64,
                                               96, 192]
    assert all(d % 8 == 0 for d in space.divisor_choices(512, 512))


def test_neighbors_exclude_current_and_respect_legality():
    p = space.default_point(256, 192, 64, 128, 128)
    for coord in space.COORDS:
        for q in space.neighbors(p, coord, 256, 192, 64, 128, 128):
            assert q != p
    # the flash kernels tile 64 x 64 whatever they are given
    assert list(space.neighbors(p, "flash", 256, 192, 64, 128, 128)) == []
    bits = list(space.neighbors(p, "philox_bits", 256, 192, 64, 128, 128))
    assert [q.philox_bits for q in bits] == [8]


def test_score_illegal_point_is_inf():
    hw = _CAL.hardware()
    p = dataclasses.replace(space.default_point(256, 192, 64, 128, 128),
                            blocks=(100, 192, 64))
    assert search.score(p, 256, 192, 64, (2, 4, 128, 128), hw) \
        == float("inf")
    d = space.default_point(256, 192, 64, 128, 128)
    assert np.isfinite(search.score(d, 256, 192, 64, (2, 4, 128, 128), hw))


# -- gates (plain versions on the CPU) -------------------------------------

def test_gate_rejects_philox_bits_8_and_accepts_default():
    m, n, k = 128, 64, 64
    mask = (1, 2, 64, 64)
    d = space.default_point(m, n, k, mask[2], mask[3])
    flags, failed = search.prove_kernel_bits(d, m, n, k, mask, device="cpu")
    assert failed is None
    assert flags["mask_bits"] and flags["gemm_bitwise"]
    bad = space.with_coord(d, "philox_bits", 8)
    _, failed_bad = search.prove_kernel_bits(bad, m, n, k, mask,
                                             device="cpu")
    assert failed_bad == "mask_bits"
    # an e4m3 scale tile moved changes C: gate 2
    moved = space.with_coord(d, "bk", 32)
    _, failed_bk = search.prove_kernel_bits(moved, m, n, k, mask,
                                            dtype="fp8", device="cpu")
    assert failed_bk == "gemm_bitwise"
    assert search.prove_schedule("llama2-7b", "qkv", (m, n, k), d, mask,
                                 reduced=True)


def test_tune_cell_admits_a_candidate_and_kills_philox_bits_8():
    cfg = get_arch("llama2-7b", reduced=True)
    site, gemm = search.gemm_cells_for_arch("llama2-7b", 2, 128)[0]
    t = search.tune_cell("llama2-7b", site, gemm,
                         (2, cfg.n_heads, 128, 128), _CAL.hardware(),
                         max_gate_runs=4, device="cpu", reduced=True)
    assert any(g == "mask_bits" and ".pb8" in c for c, g in t.rejected)
    assert t.accepted and t.tuned != t.default
    assert t.score_tuned < t.score_default


# -- the shipped table and the CLI -------------------------------------------

def test_shipped_tuned_table_consistent_with_ranking():
    """The committed TUNED_torch.json agrees with the code that wrote it:
    the fit reproduces each dtype's calibration from the measurements it
    recorded, each cell's sites are what the closed-form and calibrated
    rankings pick, and the verifier passes under it."""
    from repro_torch import analysis
    from repro_torch.config.registry import list_archs
    from repro_torch.core.schedule import compile_schedule
    t = TunedTable.load(os.path.join(ROOT, DEFAULT_PATH))
    assert sorted(t.calibrations) == ["bf16", "f32"]
    ms = cal_mod.recorded_measurements(t.residuals)
    for dtype, cal in t.calibrations.items():
        assert "H100" in cal.source and " W" in cal.source
        assert cal.residual_calibrated < cal.residual_closed_form
        mine = [m for m in ms if m.dtype == dtype]
        assert len(mine) == cal.n_cells == 5
        assert cal_mod.fit(mine, cal.source) == cal
    assert all(m.t_dot > 0 and m.t_rng > 0 and m.t_fused > 0 for m in ms)
    for key, cell in t.cells.items():
        arch, _, dtype, _ = key.split("|")
        picks = tune_main.site_picks(arch, 2, 2048, dtype, GH100,
                                     t.hardware(dtype))
        assert (picks[0], picks[1]) == (cell.default_site, cell.site)
    assert {k.split("|")[0] for k in t.cells} == set(list_archs())
    with overlay(t):
        for arch in ("llama2-7b", "moonshot-v1-16b-a3b"):
            cfg = get_arch(arch)
            sched = compile_schedule(
                cfg, DropoutPlanConfig(mode="overlap", p=0.1, site="auto"),
                2, 2048, attn_impl="pallas")
            analysis.verify_schedule(cfg, sched, cell=f"test:{arch}")
    assert installed() is None


def test_tune_smoke_runs_on_the_cpu(tmp_path, capsys):
    out = os.path.join(tmp_path, "t.json")
    assert tune_main.main(["--smoke", "--dtypes", "f32", "--out", out]) == 0
    t = TunedTable.load(out)
    assert t.cells and installed() is None
    assert all(c.proof.get("verify") for c in t.cells.values())
    log = capsys.readouterr().out
    assert "fixed with no table: bitwise" in log
    assert "mask_bits" in log


# -- cost features ----------------------------------------------------------

def test_feature_vector_counts_the_kernel_operators():
    """The FLOP counter counts the kernel operators through their
    registered formulas (an opaque operator would count 0), their bytes
    and the plane's RNG operations analytically; nothing launches."""
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.kernels import gemm_rng as tg
    from repro_torch.perfmodel.model import rng_ops_per_elem
    a, b = torch.randn(256, 128), torch.randn(128, 192)
    em = tg._layout_emission(1, 1, 2, 128, 128, 0.1, 7, 3, 7, 2048, 256, 0,
                             0)
    before = dict(tg.launch_counts())
    f = counts.feature_vector(lambda x, y: tg._forward(x, y, em), a, b,
                              plane=(1, 2, 128, 128))
    assert f["flops"] == 2 * 256 * 128 * 192
    assert f["bytes"] == (256 * 128 + 128 * 192 + 256 * 192) * 4 \
        + 2 * 4 * 128 * 4
    assert f["rng_ops"] == 2 * 128 * 128 * rng_ops_per_elem(7)
    assert tg.launch_counts() == before
    q = torch.randn(1, 2, 128, 32)
    assert counts.feature_vector(
        lambda x: tf.flash_attention_fwd(x, x, x), q)["flops"] == \
        4 * 2 * 128 * 128 * 32
