"""Fused-mode dropout (the paper's baseline) in the port against the JAX
package on the CPU: the keep bits drawn inside attention rather than by a
producer.

``attention_xla`` in fused mode draws each q-chunk's bits itself
(``DropoutPlan.chunk_keep_mask``): bits bitwise JAX's, outputs within
2e-5, a padded last chunk, GQA, a local window and the 8-bit scheme
included. ``make_train_step`` with ``mode="fused"`` on the reduced llama2,
yi (GQA) and moonshot (MoE) at f32 and bf16 compute under both attention
impls: two steps' losses and grad norms and the updated master against
JAX's (whose fused plans always run its tensor-op attention; the port's
``attn_impl="pallas"`` runs the flash kernels in mode "fused", their plain
versions here), at the f32 limits of tests/test_torch_train.py and the
bf16 limits of tests/test_torch_bf16.py. In the port, fused and overlap
give bitwise the same loss and gradients (JAX's
``test_dropout_modes_equivalent``); fused plans compile to JAX's schedule
(``explain()``, ``summary()``); a producer site with fused mode raises
``ValueError`` on both sides. Inputs are made with numpy from a seed and
the JAX weights carried over by ``params_from_jax``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_fused.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core.attention import attention_xla as j_attention_xla
from repro.core.overlap import plan_from_config
from repro.core.schedule import compile_schedule as j_compile
from repro.data.pipeline import batch_for_step as j_batch
from repro.train.loop import init_train_state as j_init_state
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.attention import attention_xla
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.data import batch_for_step
from repro_torch.optim import adamw_init
from repro_torch.train import make_grad_fn, make_train_step

import test_torch_bf16 as bf16
import test_torch_bf16_grouped as grp
import test_torch_train as base

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
STEPS = 2
ARCHS = ("llama2-7b", "yi-6b", "moonshot-v1-16b-a3b")
# bf16 under attn_impl="pallas" against JAX's fused step, which runs its
# tensor-op attention: that path rounds P to bf16 before P V, the flash
# kernels keep it f32, so the two attention paths differ by more than the
# port and JAX on one path. JAX against itself (overlap, the same bits,
# flash against tensor-op, bf16 compute): grad norm 4.5e-4 (llama2),
# 1.7e-3 (yi), 3.5e-3 (moonshot) apart over two steps; the port's fused
# pallas step reads 3.6e-3 on moonshot at step 0.
FLASH_VS_XLA_GRAD_NORM_REL = 5e-3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _fused_knobs(impl, mode="fused"):
    knobs = base._knobs("xla", "auto")
    knobs["sharding"]["attn_impl"] = impl
    knobs["dropout"]["mode"] = mode
    return knobs


# ------------------------------------------------------------ attention


# (SQ, chunk_q, kv heads, local window, philox bits): 96 rows in chunks of
# 64 pad the last chunk, whose rows still draw their own bits
ATTN_CASES = [(128, 64, 4, 0, 32), (96, 64, 4, 0, 32), (128, 128, 2, 48, 32),
              (128, 64, 1, 0, 8)]


@pytest.mark.parametrize("sq,chunk,kv,window,bits", ATTN_CASES)
def test_attention_xla_fused_equals_jax(sq, chunk, kv, window, bits):
    """Each chunk's keep bits bitwise JAX's; the output within 2e-5."""
    b, h, d = 2, 4, 16
    rng = np.random.default_rng(sq + chunk + kv + bits)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, sq, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, sq, d)).astype(np.float32)
    kw = dict(mode="fused", p=0.2, seed=11, philox_bits=bits)
    plan = DropoutPlan(DropoutPlanConfig(**kw))
    jplan = plan_from_config(JPlanConfig(**kw))
    for q0 in range(0, sq, chunk):
        got = plan.chunk_keep_mask(b, h, q0, chunk, sq, 3, 5, device="cpu")
        want = jplan.chunk_keep_mask(b, h, q0, chunk, sq, 3, 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args = dict(causal=True, local_window=window, layer_idx=3, step=5,
                chunk_q=chunk)
    got = attention_xla(*(torch.from_numpy(t) for t in (q, k, v)),
                        plan=plan, **args)
    want = j_attention_xla(*(jnp.asarray(t) for t in (q, k, v)),
                           plan=jplan, **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    assert DropoutPlan(DropoutPlanConfig(mode="none")).chunk_keep_mask(
        b, h, 0, chunk, sq, 3, 5) is None


# ------------------------------------------------------------ train step


@functools.lru_cache(maxsize=None)
def _jax_fused(arch, dtype):
    """JAX's fused trajectory (its tensor-op attention under either impl):
    the initial master, the final master and each step's metrics."""
    run = base._jax_run(arch, _fused_knobs("xla"))
    state = j_init_state(jax.random.PRNGKey(0), run.model)
    master0 = jax.tree.map(np.asarray, state["master"])
    step_fn = jax.jit(j_make_train_step(run.model, run,
                                        compute_dtype=DTYPES[dtype][0]))
    metrics = []
    for i in range(STEPS):
        x, y = j_batch(run.model, run.shape, i, seed=0)
        state, m = step_fn(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return master0, jax.tree.map(np.asarray, state["master"]), metrics


def _port_fused(arch, dtype, impl, master):
    run = base._port_run(arch, _fused_knobs(impl))
    step_fn = make_train_step(run.model, run, compute_dtype=DTYPES[dtype][1])
    state = {"master": master, "opt": adamw_init(master), "step": 0}
    metrics = []
    for i in range(STEPS):
        x, y = batch_for_step(run.model, run.shape, i, seed=0)
        state, m = step_fn(state, torch.from_numpy(x), torch.from_numpy(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return state["master"], metrics


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_train_steps_equal_jax(arch, dtype, impl):
    """Two fused steps (the second at the full learning rate): losses and
    grad norms, and the updated master, against JAX's -- at f32 within
    1e-4 (the pallas impl's plain flash versions sum in another order
    than JAX's chunked attention), at bf16 within the bf16 limits (the
    MoE's second step at tests/test_torch_bf16_grouped.py's later-step
    limits: the router carries a weight moved by a flipped bf16 ulp into
    the tokens' experts; the pallas impl's step-0 grad norm at
    FLASH_VS_XLA_GRAD_NORM_REL)."""
    master0, jmaster, jmetrics = _jax_fused(arch, dtype)
    cfg = get_arch(arch, reduced=True)
    master, metrics = _port_fused(
        arch, dtype, impl, params_from_jax(master0, cfg, device="cpu"))
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        if dtype == "f32":
            for key in ("loss", "ce", "grad_norm"):
                assert got[key] == pytest.approx(want[key], **base.APPROX)
            continue
        later = i > 0 and cfg.moe is not None
        gn_rel = (grp.LATER_GRAD_NORM_REL if later
                  else FLASH_VS_XLA_GRAD_NORM_REL if impl == "pallas"
                  else bf16.GRAD_NORM_REL)
        assert got["loss"] == pytest.approx(
            want["loss"], rel=grp.LATER_LOSS_REL if later else bf16.LOSS_REL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=gn_rel)
    for (path, got), want, w0 in zip(tree.leaves_with_paths(master),
                                     jax.tree.leaves(jmaster),
                                     jax.tree.leaves(master0)):
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                       **base.TOL)
            continue
        np.testing.assert_allclose(got.numpy(), want, atol=bf16.WEIGHT_ATOL,
                                   rtol=0, err_msg=path)
        d_port = got.numpy().astype(np.float64) - w0
        d_jax = want.astype(np.float64) - w0
        assert np.linalg.norm(d_port - d_jax) <= \
            bf16.CHANGE_REL * np.linalg.norm(d_jax), path


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_equals_overlap_bitwise(dtype, impl):
    """The same bits whether drawn inside attention or by a producer: the
    fused step's loss and every gradient bitwise the overlap step's (site
    "xla": the tensor-op producer's plane, or replay under the flash
    kernels), and unlike the step without dropout."""
    cfg = get_arch("llama2-7b", reduced=True)
    master = base.init_train_state(cfg, seed=1, device="cpu")["master"]
    out = {}
    for mode in ("fused", "overlap", "none"):
        run = base._port_run("llama2-7b", _fused_knobs(impl, mode))
        x, y = (torch.from_numpy(t)
                for t in batch_for_step(cfg, run.shape, 0, seed=0))
        loss, _, grads = make_grad_fn(cfg, run,
                                      compute_dtype=DTYPES[dtype][1])(
            master, x, y, 0)
        out[mode] = (loss, tree.leaves(grads))
    assert torch.equal(out["fused"][0], out["overlap"][0])
    assert all(torch.equal(a, b)
               for a, b in zip(out["fused"][1], out["overlap"][1]))
    assert not torch.equal(out["fused"][0], out["none"][0])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b",))
def test_fused_schedule_equals_jax(arch, impl):
    """A fused plan compiles to JAX's schedule, text and summary."""
    for kw in (dict(mode="fused", p=0.1), dict(mode="fused", p=0.1,
                                               attn_replay="off")):
        got = compile_schedule(get_arch(arch, reduced=True),
                               DropoutPlanConfig(**kw), 2, 128,
                               attn_impl=impl)
        want = j_compile(j_get_arch(arch, reduced=True), JPlanConfig(**kw),
                         2, 128, attn_impl=impl)
        assert got.explain() == want.explain()
        assert got.summary() == want.summary()


def test_fused_with_a_producer_site_raises():
    """Fused mode has no producer GEMM: a site other than "xla" raises
    ValueError in both packages' train steps."""
    knobs = _fused_knobs("pallas")
    knobs["dropout"]["site"] = "qkv"
    with pytest.raises(ValueError, match="overlap"):
        j_make_train_step(base._jax_run("llama2-7b", knobs).model,
                          base._jax_run("llama2-7b", knobs))
    run = base._port_run("llama2-7b", knobs)
    with pytest.raises(ValueError, match="overlap"):
        make_train_step(run.model, run)
    with pytest.raises(ValueError, match="overlap"):
        make_grad_fn(run.model, run)
