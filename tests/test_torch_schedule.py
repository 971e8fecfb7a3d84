"""The port's schedule compiler, producer planning, data pipeline and
optimizer against the JAX package: ``explain()`` text equal character for
character, batches equal token for token, one AdamW update within 1e-6
(weight-decay decisions included).

    PYTHONPATH=src python -m pytest -q tests/test_torch_schedule.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import ShapeConfig as JShapeConfig
from repro.config.base import StepKind as JStepKind
from repro.core import producer as jproducer
from repro.core.overlap import DropoutPlan as JPlan
from repro.core.schedule import compile_schedule as j_compile
from repro.core.schedule import inline_assignment as j_inline
from repro.data.pipeline import batch_for_step as j_batch
from repro.data.pipeline import embed_batch_for_step as j_embed_batch
from repro.optim.adamw import _decay_mask as j_decay_mask
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.adamw import schedule_lr as j_schedule_lr
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import (
    DropoutPlanConfig,
    OptimizerConfig,
    ShapeConfig,
    StepKind,
)
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule, inline_assignment
from repro_torch.data import batch_for_step, embed_batch_for_step
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import _decay_mask, schedule_lr

ARCHS = ["llama2-7b", "yi-6b"]


def _cfgs(arch, **over):
    jcfg = j_get_arch(arch, reduced=True)
    cfg = get_arch(arch, reduced=True)
    if over:
        jcfg, cfg = (dataclasses.replace(c, **over) for c in (jcfg, cfg))
    return jcfg, cfg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("site", ["xla", "qkv"])
@pytest.mark.parametrize("replay", ["auto", "off"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_explain_text_equals_jax(arch, site, replay, impl):
    jcfg, cfg = _cfgs(arch)
    kw = dict(mode="overlap", p=0.1, site=site, attn_replay=replay, seed=5)
    for batch, seq in ((2, 128), (1, 96)):
        want = j_compile(jcfg, JPlanConfig(**kw), batch, seq,
                         attn_impl=impl)
        got = compile_schedule(cfg, DropoutPlanConfig(**kw), batch, seq,
                               attn_impl=impl)
        assert got.explain() == want.explain()
        assert got.records() == want.records()
        assert got.summary() == want.summary()
        assert got.replay == want.replay
        for layer in range(cfg.n_layers):
            assert got.mask_key(layer, 7) == want.mask_key(layer, 7)
        assert dataclasses.asdict(
            inline_assignment(cfg, DropoutPlan(DropoutPlanConfig(**kw)),
                              batch, seq, attn_impl=impl)) == \
            dataclasses.asdict(j_inline(jcfg, JPlan(JPlanConfig(**kw)),
                                        batch, seq, attn_impl=impl))


def test_region3_and_untileable_cells_plan_as_jax():
    """A wide mask over a small QKV GEMM is Region 3 (standalone); a GEMM
    whose rows do not tile by 8 stays with the tensor-op producer; the
    8-bit scheme never reaches a kernel."""
    cases = [("llama2-7b", dict(d_model=64, n_heads=128, n_kv_heads=128,
                                head_dim=2), 1, 256,
              {}),
             ("yi-6b", {}, 1, 100, {}),
             ("llama2-7b", {}, 2, 128, dict(philox_bits=8))]
    seen = set()
    for arch, over, batch, seq, plan_over in cases:
        jcfg, cfg = _cfgs(arch, **over)
        kw = dict(mode="overlap", site="qkv", attn_replay="off", **plan_over)
        want = j_compile(jcfg, JPlanConfig(**kw), batch, seq,
                         attn_impl="pallas")
        got = compile_schedule(cfg, DropoutPlanConfig(**kw), batch, seq,
                               attn_impl="pallas")
        assert got.explain() == want.explain()
        seen.add(got.for_layer(0).how)
    assert seen == {"standalone", "xla"}


@pytest.mark.parametrize("shape", [(512, 192, 64), (4096, 12288, 4096),
                                   (96, 40, 24), (1000, 64, 64)])
def test_gemm_planning_helpers_equal_jax(shape):
    m, n, k = shape
    assert producer.pick_gemm_blocks(m, n, k) == \
        jproducer.pick_gemm_blocks(m, n, k)
    assert producer.mask_cols_cap(m, n) == jproducer.mask_cols_cap(m, n)
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        assert producer.block_gemm_shapes(cfg, 2, 128) == \
            jproducer.block_gemm_shapes(jcfg, 2, 128)
    for replay, bits, seq in (("auto", 32, 128), ("off", 32, 128),
                              ("auto", 8, 128), ("auto", 32, 96)):
        kw = dict(mode="overlap", attn_replay=replay, philox_bits=bits)
        for impl in ("pallas", "xla"):
            assert producer.replay_unsupported_reason(
                DropoutPlan(DropoutPlanConfig(**kw)), seq, seq, impl) == \
                jproducer.replay_unsupported_reason(
                    JPlan(JPlanConfig(**kw)), seq, seq, impl)


def test_unported_sites_and_dtypes_raise():
    cfg = get_arch("llama2-7b", reduced=True)
    for plan in (DropoutPlanConfig(mode="overlap", site="prev_gemm"),
                 DropoutPlanConfig(mode="overlap", site="auto"),
                 DropoutPlanConfig(mode="overlap", site="qkv",
                                   gemm_dtype="bf16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compile_schedule(cfg, plan, 2, 128, attn_impl="pallas")


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (11, 123)])
def test_batches_equal_jax(seed, step):
    cfg, jcfg = get_arch("yi-6b", reduced=True), j_get_arch("yi-6b",
                                                           reduced=True)
    shape = ShapeConfig("t", 96, 3, StepKind.TRAIN)
    jshape = JShapeConfig("t", 96, 3, JStepKind.TRAIN)
    for got, want in zip(batch_for_step(cfg, shape, step, seed),
                         j_batch(jcfg, jshape, step, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(embed_batch_for_step(cfg, shape, step, seed),
                         j_embed_batch(jcfg, jshape, step, seed)):
        np.testing.assert_array_equal(got, want)


def test_decay_rule_is_jax_verbatim():
    """The substring rule keeps its surprises: "u" exempts w_up and
    unembed from decay, while w_gate, w_down and embed decay."""
    paths = ["['stacks'][0]['l0']['ffn']['w_up']", "['unembed']",
             "['stacks'][0]['l0']['ffn']['w_gate']",
             "['stacks'][0]['l0']['ffn']['w_down']",
             "['stacks'][0]['l0']['mix']['w_q']", "['embed']",
             "['final_norm']['scale']", "['stacks'][0]['l0']['norm_mix']"]
    got = [_decay_mask(p) for p in paths]
    assert got == [j_decay_mask(p) for p in paths]
    assert got == [False, False, True, True, True, True, False, False]


@pytest.mark.parametrize("sched", ["cosine", "linear", "constant"])
def test_adamw_update_equals_jax(sched):
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          schedule=sched, grad_clip=0.5)
    jcfg = JOptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            schedule=sched, grad_clip=0.5)
    rng = np.random.default_rng(7)
    shapes = {"embed": (16, 8), "unembed": (8, 16),
              "final_norm": {"scale": (8,)},
              "stacks": [{"l0": {"ffn": {"w_up": (2, 8, 4),
                                         "w_gate": (2, 8, 4)},
                                 "mix": {"w_q": (2, 8, 8)}}}]}
    mk = lambda: jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    master, grads, m, v = mk(), mk(), mk(), mk()
    v = jax.tree.map(np.abs, v)
    for step in (0, 3, 9):
        assert schedule_lr(cfg, step) == pytest.approx(
            float(j_schedule_lr(jcfg, step)), rel=1e-6)
        jm, _, jopt, jmet = j_adamw_update(
            jax.tree.map(jnp.asarray, grads),
            {"m": jax.tree.map(jnp.asarray, m),
             "v": jax.tree.map(jnp.asarray, v)},
            jax.tree.map(jnp.asarray, master), jcfg, step)
        to = lambda t: tree.tree_map(torch.from_numpy, t)
        tm, _, topt, tmet = adamw_update(to(grads), {"m": to(m), "v": to(v)},
                                         to(master), cfg, step)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-6)
        for got, want in ((tm, jm), (topt["m"], jopt["m"]),
                          (topt["v"], jopt["v"])):
            for (path, g), w in zip(tree.leaves_with_paths(got),
                                    jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-6, rtol=1e-6,
                                           err_msg=path)
