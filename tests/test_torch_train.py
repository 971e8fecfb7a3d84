"""The port's training step against the JAX package's: 3-step
``make_train_step`` trajectories of the reduced llama2 and yi (GQA) on the
CPU, sites "xla" and "qkv" x ``attn_replay`` "auto" and "off" through the
flash path (``attn_impl="pallas"``), with the JAX weights carried over by
``params_from_jax`` and the batches made by each side's own pipeline.
Loss, ce and grad norm of every step and the final master parameters are
allclose at 1e-4.

    PYTHONPATH=src python -m pytest -q tests/test_torch_train.py
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
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import ShapeConfig as JShapeConfig
from repro.config.base import ShardingConfig as JShardingConfig
from repro.config.base import StepKind as JStepKind
from repro.config.base import TrainConfig as JTrainConfig
from repro.data.pipeline import batch_for_step as j_batch
from repro.train.loop import init_train_state as j_init_state
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import (
    AttentionKind,
    DropoutPlanConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    ShardingConfig,
    StepKind,
    TrainConfig,
)
from repro_torch.convert import params_from_jax
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import inline_assignment
from repro_torch.data import batch_for_step
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.optim import adamw_init
from repro_torch.train import (
    compile_run_schedule,
    init_train_state,
    make_eval_step,
    make_train_step,
)

TOL = dict(atol=1e-4, rtol=1e-4)
APPROX = dict(abs=1e-4, rel=1e-4)
STEPS = 3
# warm-up of one step, so steps 1 and 2 move the weights at the full rate
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _knobs(site, replay, remat="block", micro=0, seq=128):
    return dict(
        shape=("t", seq, 2), sharding=dict(attn_impl="pallas", remat=remat),
        dropout=dict(mode="overlap", site=site, p=0.1, attn_replay=replay,
                     seed=3),
        train=dict(microbatch=micro))


def _port_run(arch, knobs):
    name, seq, batch = knobs["shape"]
    return RunConfig(
        model=get_arch(arch, reduced=True),
        shape=ShapeConfig(name, seq, batch, StepKind.TRAIN),
        sharding=ShardingConfig(**knobs["sharding"]),
        dropout=DropoutPlanConfig(**knobs["dropout"]),
        train=TrainConfig(optimizer=OptimizerConfig(**OPT),
                          **knobs["train"]))


def _jax_run(arch, knobs):
    name, seq, batch = knobs["shape"]
    return JRunConfig(
        model=j_get_arch(arch, reduced=True),
        shape=JShapeConfig(name, seq, batch, JStepKind.TRAIN),
        sharding=JShardingConfig(**knobs["sharding"]),
        dropout=JPlanConfig(**knobs["dropout"]),
        train=JTrainConfig(optimizer=JOptimizerConfig(**OPT),
                           **knobs["train"]))


def _port_trajectory(arch, knobs, master):
    run = _port_run(arch, knobs)
    step_fn = make_train_step(run.model, run)
    state = {"master": master, "opt": adamw_init(master), "step": 0}
    metrics = []
    for i in range(STEPS):
        x, y = batch_for_step(run.model, run.shape, i, seed=0)
        state, m = step_fn(state, torch.from_numpy(x), torch.from_numpy(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _jax_trajectory(arch, knobs):
    run = _jax_run(arch, knobs)
    state = j_init_state(jax.random.PRNGKey(0), run.model)
    master0 = jax.tree.map(np.asarray, state["master"])
    step_fn = jax.jit(j_make_train_step(run.model, run))
    metrics = []
    for i in range(STEPS):
        x, y = j_batch(run.model, run.shape, i, seed=0)
        state, m = step_fn(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return master0, state, metrics


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-6b"])
@pytest.mark.parametrize("site", ["xla", "qkv"])
@pytest.mark.parametrize("replay", ["auto", "off"])
def test_three_step_trajectory_equals_jax(arch, site, replay):
    knobs = _knobs(site, replay)
    master0, jstate, jmetrics = _jax_trajectory(arch, knobs)
    cfg = get_arch(arch, reduced=True)
    state, metrics = _port_trajectory(
        arch, knobs, params_from_jax(master0, cfg, device="cpu"))
    assert state["step"] == STEPS
    for got, want in zip(metrics, jmetrics):
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert got[key] == pytest.approx(want[key], **APPROX), key
    jleaves = jax.tree.leaves(jstate["master"])
    for (path, got), want in zip(tree.leaves_with_paths(state["master"]),
                                 jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **TOL)
    how = compile_run_schedule(cfg, _port_run(arch, knobs)).for_layer(0).how
    assert how == {("xla", "auto"): "replay", ("xla", "off"): "xla",
                   ("qkv", "auto"): "replay",
                   ("qkv", "off"): "gemm_rng"}[(site, replay)]


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-6b"])
def test_remat_block_and_none_give_the_same_losses(arch):
    """Recomputing a unit in the backward redraws the same keep bits (the
    counters are position-based), so remat changes no loss."""
    master = init_train_state(get_arch(arch, reduced=True), seed=2,
                              device="cpu")["master"]
    runs = {remat: _port_trajectory(arch, _knobs("qkv", "auto", remat),
                                    master)
            for remat in ("block", "none")}
    for a, b in zip(runs["block"][1], runs["none"][1]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == pytest.approx(
            b["grad_norm"], rel=1e-6)


def test_microbatched_step_equals_jax():
    knobs = _knobs("qkv", "off", micro=2)
    master0, jstate, jmetrics = _jax_trajectory("llama2-7b", knobs)
    cfg = get_arch("llama2-7b", reduced=True)
    _, metrics = _port_trajectory("llama2-7b", knobs,
                                  params_from_jax(master0, cfg,
                                                  device="cpu"))
    for got, want in zip(metrics, jmetrics):
        assert got["loss"] == pytest.approx(want["loss"], **APPROX)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 **APPROX)


def test_eval_step_and_unported_knobs():
    cfg = get_arch("llama2-7b", reduced=True)
    run = _port_run("llama2-7b", _knobs("qkv", "auto"))
    master = init_train_state(cfg, seed=1, device="cpu")["master"]
    x, y = batch_for_step(cfg, run.shape, 0)
    ce = make_eval_step(cfg, run)(master, torch.from_numpy(x),
                                  torch.from_numpy(y))
    assert np.isfinite(float(ce)) and abs(float(ce) - np.log(256)) < 0.5
    ce16 = make_eval_step(cfg, run, compute_dtype=torch.bfloat16)(
        master, torch.from_numpy(x), torch.from_numpy(y))
    assert float(ce16) == pytest.approx(float(ce), rel=1e-2)
    # bf16 compute, dense bf16 hosts and the grouped bf16 host of a MoE
    # block are ported, and so is a sharding policy (it raised before): the
    # step's schedule plans shard-local producers
    make_train_step(cfg, dataclasses.replace(run, dropout=dataclasses.replace(
        run.dropout, gemm_dtype="bf16")), compute_dtype=torch.bfloat16)
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.train import compile_run_schedule
    pol = ShardingPolicy(AbstractMesh((2,), ("model",)))
    make_train_step(cfg, run, policy=pol, compute_dtype=torch.bfloat16)
    assert compile_run_schedule(cfg, run, pol).sharded
    moe = get_arch("moonshot-v1-16b-a3b", reduced=True)
    grouped = dataclasses.replace(run, model=moe, dropout=dataclasses.replace(
        run.dropout, site="ffn_up", gemm_dtype="bf16"))
    make_train_step(moe, grouped, compute_dtype=torch.bfloat16)
    make_train_step(moe, grouped, policy=pol, compute_dtype=torch.bfloat16)
    fused = dataclasses.replace(run, dropout=dataclasses.replace(
        run.dropout, mode="fused"))
    with pytest.raises(ValueError, match="overlap"):
        make_train_step(cfg, fused)


def test_flash_path_runs_the_plan_or_raises():
    """``attn_impl="pallas"`` always runs the flash kernels (their plain
    versions here). At S=192, which the JAX package's s % 128 gate hands
    to the tensor-op attention, the plan is premask and the flash path
    gives the tensor-op attention's result; so does a fused-mode plan,
    which JAX's gate also hands to the tensor-op attention and the port
    runs in the kernels' mode "fused" (the same bits). Where the kernels
    cannot go, and where the plan and the path disagree, the call raises;
    a producer whose kernel layout check contradicts the plan raises
    too."""
    cfg = get_arch("llama2-7b", reduced=True)
    p = attn_init(torch.Generator().manual_seed(0), cfg)
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", site="qkv", p=0.1,
                                         seed=3))
    rng = np.random.default_rng(0)
    x = lambda s: torch.from_numpy(  # noqa: E731
        rng.standard_normal((2, s, cfg.d_model)).astype(np.float32))
    kw = dict(kind=AttentionKind.FULL, layer_idx=1, step=2)
    asg = inline_assignment(cfg, plan, 2, 192, attn_impl="pallas")
    assert (asg.how, asg.site) == (producer.HOW_GEMM, "qkv")
    x192 = x(192)
    got = attn_apply(p, x192, cfg, plan=plan, impl="pallas", **kw)
    want = attn_apply(p, x192, cfg, plan=plan, impl="xla", asg=asg, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    with pytest.raises(NotImplementedError, match="SQ=96"):
        attn_apply(p, x(96), cfg, plan=plan, impl="pallas", **kw)
    fused = DropoutPlan(DropoutPlanConfig(mode="fused", p=0.1))
    x128 = x(128)
    got = attn_apply(p, x128, cfg, plan=fused, impl="pallas", **kw)
    want = attn_apply(p, x128, cfg, plan=fused, impl="xla", **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    fused8 = DropoutPlan(DropoutPlanConfig(mode="fused", p=0.1,
                                           philox_bits=8))
    with pytest.raises(NotImplementedError, match="philox_bits=8"):
        attn_apply(p, x128, cfg, plan=fused8, impl="pallas", **kw)
    replay = inline_assignment(cfg, plan, 2, 128, attn_impl="pallas")
    assert replay.how == producer.HOW_REPLAY
    with pytest.raises(ValueError, match="replay"):
        attn_apply(p, x(128), cfg, plan=plan, impl="xla", asg=replay, **kw)
    # Region 3: a (256, 768, 64) GEMM cannot host a 1x128x256x256 mask
    a = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    shape = (1, 128, 256, 256)
    with pytest.raises(RuntimeError, match="Region 3"):
        producer.gemm_with_mask(a, w, plan, shape, 0, 0, how=producer.HOW_GEMM)
    y, plane = producer.gemm_with_mask(a, w, plan, shape, 0, 0,
                                       how=producer.HOW_STANDALONE)
    assert torch.equal(plane, producer.standalone_packed_mask(
        plan, *shape, 0, 0, device="cpu"))
    np.testing.assert_allclose(y.numpy(), (a @ w).numpy(), atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="does not tile"):
        producer.gemm_with_mask(a[:100], w, plan, shape, 0, 0,
                                how=producer.HOW_GEMM)
