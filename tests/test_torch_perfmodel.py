"""The perf model in the port (``repro_torch.perfmodel``) and the
``site="auto"`` planning built on it, against the JAX package's, on the
CPU.

Every perfmodel function gives JAX's float, bit for bit, for GH100,
TPU_V5E and a calibrated Hardware, on every shipped config's block and
grouped host shapes; ``rank_host_sites`` and ``compile_schedule(site=
"auto")`` give JAX's ranking, resolved site, ``explain()`` text (the
headroom lines included) and summary with ``hw`` passed to both, on the
reduced llama2, yi, moonshot, arctic, an RWKV hybrid and recurrentgemma;
with no table the port ranks by GH100 (JAX's falls back to TPU_V5E); a
reduced-llama2 ``site="auto"`` train step equals JAX's at the same
calibrated hardware: the plan and the keep bits bitwise, the trajectory
at the f32 tolerances.

    PYTHONPATH=src python -m pytest -q tests/test_torch_perfmodel.py
"""
import dataclasses

import jax
import numpy as np
import pytest

import test_torch_grouped as grp
import test_torch_train as base
from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core import dropout_rng as j_rng
from repro.core import producer as jproducer
from repro.core.overlap import plan_from_config
from repro.core.schedule import compile_schedule as j_compile
from repro.perfmodel import hardware as jhw
from repro.perfmodel import model as jmodel
from repro.tune import tables as jtables
from repro_torch import tree
from repro_torch.config import get_arch, list_archs
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import dropout_rng, producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.perfmodel import hardware as hw
from repro_torch.perfmodel import model
from repro_torch.train import compile_run_schedule
from repro_torch.tune import tables

CAL = dict(mma_flops=4.1e14, hbm_bw=2.2e12, nonmma_ops=6.5e12,
           rng_interference=1.9, gemm_interference=1.18,
           step_overhead=2.5e-7)


def _hw_pairs():
    """(port Hardware, JAX Hardware) pairs: the closed forms and a
    calibrated one."""
    return [(hw.GH100, jhw.GH100), (hw.TPU_V5E, jhw.TPU_V5E),
            (hw.Hardware.calibrated(hw.GH100, source="t", **CAL),
             jhw.Hardware.calibrated(jhw.GH100, source="t", **CAL))]


def test_hardware_constants_are_jax_s():
    for mine, theirs in _hw_pairs():
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.is_calibrated == theirs.is_calibrated
        assert dataclasses.asdict(mine.scaled(3.0)) == \
            dataclasses.asdict(theirs.scaled(3.0))
    with pytest.raises(ValueError, match="source"):
        hw.Hardware.calibrated(hw.GH100, source="", **CAL)


@pytest.mark.parametrize("arch", list_archs())
def test_every_function_equals_jax_on_the_shipped_shapes(arch):
    cfg = get_arch(arch)
    for batch, seq in ((2, 2048), (8, 1024)):
        dense = producer.block_gemm_shapes(cfg, batch, seq)
        grouped = producer.grouped_host_shapes(cfg, batch, seq)
        elems = float(batch) * cfg.n_heads * seq * seq
        for mine, theirs in _hw_pairs():
            for db in (4, 2, 1):
                for (m, n, k) in dense.values():
                    blocks = producer.pick_gemm_blocks(m, n, k)
                    for fn in ("gemm_host_headroom", "gemm_host_cost",
                               "fused_host_time"):
                        assert getattr(model, fn)(
                            m, n, k, elems, mine, dtype_bytes=db) == \
                            getattr(jmodel, fn)(m, n, k, elems, theirs,
                                                dtype_bytes=db), fn
                    for blk in (None, blocks):
                        assert model.gemm_tile_time(
                            m, n, k, mine, blocks=blk, dtype_bytes=db) == \
                            jmodel.gemm_tile_time(m, n, k, theirs,
                                                  blocks=blk,
                                                  dtype_bytes=db)
                        assert model.fused_host_time(
                            m, n, k, elems, mine, blocks=blk,
                            dtype_bytes=db) == jmodel.fused_host_time(
                            m, n, k, elems, theirs, blocks=blk,
                            dtype_bytes=db)
                    if blocks is not None:
                        assert model.gemm_grid_steps(m, n, k, blocks) == \
                            jmodel.gemm_grid_steps(m, n, k, blocks)
                        assert model.gemm_tile_traffic_bytes(
                            m, n, k, blocks, db) == \
                            jmodel.gemm_tile_traffic_bytes(m, n, k, blocks,
                                                           db)
                for (e, c, k, n) in grouped.values():
                    for fn in ("grouped_gemm_host_headroom",
                               "grouped_gemm_host_cost"):
                        assert getattr(model, fn)(
                            e, c, n, k, elems, mine, dtype_bytes=db) == \
                            getattr(jmodel, fn)(e, c, n, k, elems, theirs,
                                                dtype_bytes=db), fn
                g = {s: (e, c, n, k) for s, (e, c, k, n) in grouped.items()}
                assert model.rank_host_gemms(
                    dense, elems, mine, dtype_bytes=db, grouped=g) == \
                    jmodel.rank_host_gemms(dense, elems, theirs,
                                           dtype_bytes=db, grouped=g)
            shape = dict(batch=batch, seq=seq, n_heads=cfg.n_heads,
                         head_dim=cfg.head_dim,
                         n_kv_heads=cfg.n_kv_heads)
            mine_s = model.BlockShape(**shape)
            theirs_s = jmodel.BlockShape(**shape)
            for rounds in (7, 5):
                assert model.kernel_times(mine_s, mine, rounds) == \
                    jmodel.kernel_times(theirs_s, theirs, rounds)
                for fn in ("baseline_block_time", "overlap_block_time",
                           "block_speedup"):
                    assert getattr(model, fn)(mine_s, mine, rounds) == \
                        getattr(jmodel, fn)(theirs_s, theirs, rounds), fn
            assert mine_s.mask_traffic_bytes() == \
                theirs_s.mask_traffic_bytes()


def test_headline_and_sweep_equal_jax():
    for mine, theirs in _hw_pairs():
        assert model.headline_table(mine) == jmodel.headline_table(theirs)
        assert model.sweep_speedup((1024, 4096), (16, 64), mine) == \
            jmodel.sweep_speedup((1024, 4096), (16, 64), theirs)


# ------------------------------------------------------- site="auto"

AUTO_MODELS = {
    "llama2": lambda: (j_get_arch("llama2-7b", reduced=True),
                       get_arch("llama2-7b", reduced=True)),
    "yi": lambda: (j_get_arch("yi-6b", reduced=True),
                   get_arch("yi-6b", reduced=True)),
    "moonshot": lambda: (j_get_arch("moonshot-v1-16b-a3b", reduced=True),
                         get_arch("moonshot-v1-16b-a3b", reduced=True)),
    "arctic": lambda: (j_get_arch("arctic-480b", reduced=True),
                       get_arch("arctic-480b", reduced=True)),
    "hybrid": grp._hybrid_cfgs,
    "recurrentgemma": lambda: (j_get_arch("recurrentgemma-9b",
                                          reduced=True),
                               get_arch("recurrentgemma-9b", reduced=True)),
}


@pytest.mark.parametrize("name", sorted(AUTO_MODELS))
def test_auto_ranking_and_schedule_equal_jax(name):
    jcfg, cfg = AUTO_MODELS[name]()
    for mine, theirs in _hw_pairs():
        for dtype in ("f32", "bf16", "fp8"):
            for replay in ("auto", "off"):
                kw = dict(mode="overlap", p=0.1, site="auto",
                          gemm_dtype=dtype, attn_replay=replay)
                for batch, seq in ((2, 128), (2, 256)):
                    assert producer.rank_host_sites(
                        cfg, DropoutPlan(DropoutPlanConfig(**kw)), batch,
                        seq, hw=mine) == jproducer.rank_host_sites(
                        jcfg, plan_from_config(JPlanConfig(**kw)), batch,
                        seq, hw=theirs)
                    got = compile_schedule(cfg, DropoutPlanConfig(**kw),
                                           batch, seq, attn_impl="pallas",
                                           hw=mine)
                    want = j_compile(jcfg, JPlanConfig(**kw), batch, seq,
                                     attn_impl="pallas", hw=theirs)
                    assert got.resolved_site == want.resolved_site
                    assert got.headroom == want.headroom
                    assert got.explain() == want.explain()
                    assert got.summary() == want.summary()
                    assert "auto candidate" in got.explain()
                    assert producer.pick_host_site(
                        cfg, DropoutPlan(DropoutPlanConfig(**kw)), batch,
                        seq, hw=mine) == jproducer.pick_host_site(
                        jcfg, plan_from_config(JPlanConfig(**kw)), batch,
                        seq, hw=theirs)


def test_no_table_ranks_by_gh100():
    """The port's default hardware is the card it runs on: with no tuned
    table ``rank_host_sites`` is its GH100 ranking (JAX's falls back to
    TPU_V5E), and a calibrated table's hardware takes over."""
    assert tables.installed() is None
    for arch in ("llama2-7b", "moonshot-v1-16b-a3b"):
        cfg = get_arch(arch)
        plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1,
                                             site="auto"))
        ranked = producer.rank_host_sites(cfg, plan, 2, 2048)
        assert ranked == producer.rank_host_sites(cfg, plan, 2, 2048,
                                                  hw=hw.GH100)
        assert ranked == tuple(jproducer.rank_host_sites(
            j_get_arch(arch), plan_from_config(JPlanConfig(
                mode="overlap", p=0.1, site="auto")), 2, 2048,
            hw=jhw.GH100))
        sched = compile_schedule(cfg, plan.cfg, 2, 2048, attn_impl="pallas")
        assert sched.headroom == ranked
        cal = tables.Calibration(source="t", residual_closed_form=1.0,
                                 residual_calibrated=0.5, n_cells=1, **CAL)
        with tables.overlay(tables.TunedTable(calibration=cal)):
            assert producer.rank_host_sites(cfg, plan, 2, 2048) == \
                producer.rank_host_sites(cfg, plan, 2, 2048,
                                         hw=cal.hardware())
    assert tables.installed() is None


@pytest.fixture
def same_calibration():
    """The same calibrated hardware installed on both sides (JAX's train
    step resolves "auto" through its active table, as the port's does)."""
    kw = dict(source="t", residual_closed_form=1.0, residual_calibrated=0.5,
              n_cells=1, **CAL)
    tables.install(tables.TunedTable(calibration=tables.Calibration(**kw)))
    jtables.install(jtables.TunedTable(
        calibration=jtables.Calibration(**kw)))
    yield
    tables.uninstall()
    jtables.uninstall()


def test_auto_train_step_equals_jax(same_calibration):
    knobs = base._knobs("auto", "auto")
    jrun, run = base._jax_run("llama2-7b", knobs), \
        base._port_run("llama2-7b", knobs)
    sched = compile_run_schedule(run.model, run)
    jsched = j_compile(jrun.model, jrun.dropout, 2, 128,
                       attn_impl="pallas")
    assert sched.resolved_site == jsched.resolved_site != "auto"
    assert sched.explain() == jsched.explain()
    # the keep bits of every consumer at step 1, bitwise
    plan, jplan = DropoutPlan(run.dropout), plan_from_config(jrun.dropout)
    for a in sched.assignments:
        if a.consumes:
            got = dropout_rng.packed_mask(
                2, run.model.n_heads, 128, 128, 0.1, plan.step_seed(1),
                plan.salt(a.layer), 7, 32, device="cpu")
            want = j_rng.packed_mask(
                2, jrun.model.n_heads, 128, 128, 0.1, jplan.step_seed(1),
                jplan.salt(a.layer), 7, 32)
            assert np.array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    master0, jstate, jmetrics = base._jax_trajectory("llama2-7b", knobs)
    state, metrics = base._port_trajectory(
        "llama2-7b", knobs,
        params_from_jax(master0, run.model, device="cpu"))
    for got, want in zip(metrics, jmetrics):
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert got[key] == pytest.approx(want[key], **base.APPROX), key
    for (path, got), want in zip(tree.leaves_with_paths(state["master"]),
                                 jax.tree.leaves(jstate["master"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **base.TOL)
