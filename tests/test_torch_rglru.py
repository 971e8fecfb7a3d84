"""The Griffin hybrid in the port against the JAX package on the CPU: the
RG-LRU block (``models/rglru.py``) and LOCAL attention in training.

``_scan_recurrence`` (a log-depth scan in tensor ops, where JAX runs
``jax.lax.associative_scan``) and ``rglru_apply`` with their gradients
against JAX's: the two scans sum in another order, so the states agree to
SCAN_TOL and the gradients to GRAD_TOL (measured: 2.6e-7 and 4.1e-6 of
(1 + |x|) at T up to 1000); at bf16 compute the block's output within the
JAX tests' bf16 3e-2. Three ``make_train_step`` steps of the reduced
recurrentgemma (R, R, A, R; window 32, MQA) against JAX's at 1e-4 under
both attention impls, one of them at the carried site "ffn_up", whose
plane rides past the recurrent blocks. On JAX's ``_griffin_cfg`` and the
reduced recurrentgemma every site gives the "xla" site's logits exactly
(JAX's ``test_griffin_sites_bit_identical``), and the schedule's text and
summary equal JAX's at every site under both impls. ``params_from_jax``
carries every RG-LRU leaf and a tied embedding of recurrentgemma's vocab
(256000) across bitwise, and refuses a tree whose RG-LRU leaves differ.

    PYTHONPATH=src python -m pytest -q tests/test_torch_rglru.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.config.base import AttentionKind as JAttentionKind
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.config.base import ModelConfig as JModelConfig
from repro.core.schedule import compile_schedule as j_compile
from repro.models import rglru as jr
from repro.models.transformer import model_init as j_model_init
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import AttentionKind, DropoutPlanConfig
from repro_torch.config.base import ModelConfig
from repro_torch.convert import RGLRU_LEAVES, params_from_jax
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.models import rglru as tr
from repro_torch.models.transformer import Runtime, forward, model_init

import test_torch_train as base

SCAN_TOL = 1e-6
GRAD_TOL = 1e-5
BF16_TOL = 3e-2
SITES = ("xla", "qkv", "prev_gemm", "ffn_up", "ffn_down")


def _jax_vjp(fn, cot, *args):
    """fn(*args) and its vjp at ``cot``, in one jitted call."""
    def both(cot_, *args_):
        out, vjp = jax.vjp(fn, *args_)
        return out, vjp(cot_)
    return jax.jit(both)(cot, *args)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want)))


def _griffin_kw(n_layers=6, vocab=64):
    """JAX's tests/test_schedule.py::_griffin_cfg: (R, R, FULL) x 2."""
    return dict(name="grif", family="hybrid", n_layers=n_layers, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=vocab,
                head_dim=32, local_window=32, attn_dropout=0.25)


def _griffin_cfgs(**kw):
    args = _griffin_kw(**kw)
    return (ModelConfig(block_pattern=(AttentionKind.RECURRENT,
                                       AttentionKind.RECURRENT,
                                       AttentionKind.FULL), **args),
            JModelConfig(block_pattern=(JAttentionKind.RECURRENT,
                                        JAttentionKind.RECURRENT,
                                        JAttentionKind.FULL), **args))


# ------------------------------------------------------------ the block


@pytest.mark.parametrize("t", [7, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_recurrence_equals_jax(t, with_h0):
    rng = np.random.default_rng(t)
    r_gate = rng.uniform(0, 1, (2, t, 16)).astype(np.float32)
    lam = rng.standard_normal((2, t, 16)).astype(np.float32)
    log_a = (-8 * np.log1p(np.exp(lam)) * r_gate).astype(np.float32)
    gated = rng.standard_normal((2, t, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    cot = rng.standard_normal((2, t, 16)).astype(np.float32)
    want, (want_da, want_dg) = _jax_vjp(
        lambda a, b: jr._scan_recurrence(
            a, b, None if h0 is None else jnp.asarray(h0)),
        jnp.asarray(cot), jnp.asarray(log_a), jnp.asarray(gated))
    a = torch.from_numpy(log_a).requires_grad_()
    b = torch.from_numpy(gated).requires_grad_()
    got = tr._scan_recurrence(a, b,
                              None if h0 is None else torch.from_numpy(h0))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), want, SCAN_TOL)
    _close(a.grad, want_da, GRAD_TOL)
    _close(b.grad, want_dg, GRAD_TOL)


def test_rglru_apply_equals_jax():
    """The block's output and every gradient (its ten leaves and x) at
    f32; at bf16 compute the output within BF16_TOL."""
    cfg = get_arch("recurrentgemma-9b", reduced=True)
    jcfg = j_get_arch("recurrentgemma-9b", reduced=True)
    jp = jr.rglru_init(jax.random.PRNGKey(1), jcfg)
    assert sorted(jp) == list(RGLRU_LEAVES)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 96, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want, (want_dp, want_dx) = _jax_vjp(
        lambda p, x_: jr.rglru_apply(p, x_, jcfg), jnp.asarray(cot), jp,
        jnp.asarray(x))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    got = tr.rglru_apply(p, xt, cfg)
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), want, SCAN_TOL)
    _close(xt.grad, want_dx, GRAD_TOL)
    for k in p:
        _close(p[k].grad, want_dp[k], GRAD_TOL)
    xb = jnp.asarray(x, jnp.bfloat16)
    want16 = jax.jit(lambda p, x_: jr.rglru_apply(p, x_, jcfg))(jp, xb)
    got16 = tr.rglru_apply({k: v.detach() for k, v in p.items()},
                           torch.from_numpy(np.array(xb.astype(jnp.float32)))
                           .to(torch.bfloat16), cfg)
    assert got16.dtype == torch.bfloat16
    _close(got16.float(), want16.astype(jnp.float32), BF16_TOL)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("impl,site", [("xla", "xla"), ("pallas", "ffn_up")])
def test_griffin_train_steps_equal_jax(impl, site):
    """Three steps of the reduced recurrentgemma: losses, grad norms and
    the updated master within 1e-4 of JAX's."""
    knobs = base._knobs(site, "auto")
    knobs["sharding"]["attn_impl"] = impl
    master0, jstate, jmetrics = base._jax_trajectory("recurrentgemma-9b",
                                                     knobs)
    cfg = get_arch("recurrentgemma-9b", reduced=True)
    state, metrics = base._port_trajectory(
        "recurrentgemma-9b", knobs, params_from_jax(master0, cfg,
                                                    device="cpu"))
    for got, want in zip(metrics, jmetrics):
        for key in ("loss", "ce", "grad_norm"):
            assert got[key] == pytest.approx(want[key], **base.APPROX), key
    for (path, got), want in zip(tree.leaves_with_paths(state["master"]),
                                 jax.tree.leaves(jstate["master"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **base.TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["grif", "recurrentgemma-9b"])
def test_griffin_sites_bit_identical(arch, impl):
    """Every site reproduces the "xla" site's logits exactly: the same
    masks, whichever host makes them, the carried plane crossing the
    recurrent blocks to the next attention layer."""
    cfg = (_griffin_cfgs()[0] if arch == "grif"
           else get_arch(arch, reduced=True))
    params = model_init(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32))
    logits = {}
    for site in SITES:
        plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.25, seed=7,
                                             site=site))
        logits[site], _ = forward(params, cfg, Runtime(
            plan=plan, step=4, attn_impl=impl), tokens)
    none, _ = forward(params, cfg, Runtime(attn_impl=impl), tokens)
    for site in SITES[1:]:
        assert torch.equal(logits[site], logits["xla"]), site
    assert not torch.equal(none, logits["xla"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_griffin_schedule_equals_jax(impl):
    """The per-layer plan (the emit stride over the recurrent blocks
    included) is JAX's, text and summary, at every site."""
    grif, jgrif = _griffin_cfgs()
    pairs = ((grif, jgrif), (get_arch("recurrentgemma-9b", reduced=True),
                             j_get_arch("recurrentgemma-9b", reduced=True)))
    for site in SITES:
        kw = dict(mode="overlap", p=0.25, seed=7, site=site)
        for cfg, jcfg in pairs:
            got = compile_schedule(cfg, DropoutPlanConfig(**kw), 1, 128,
                                   attn_impl=impl)
            want = j_compile(jcfg, JPlanConfig(**kw), 1, 128, attn_impl=impl)
            assert got.explain() == want.explain(), (cfg.name, site)
            assert got.summary() == want.summary(), (cfg.name, site)


def test_params_from_jax_round_trip():
    """Every leaf of a Griffin model with recurrentgemma's tied vocab of
    256000 bitwise JAX's, the port's own init of the same shapes; a tree
    whose RG-LRU leaves or embedding differ is refused."""
    cfg, jcfg = _griffin_cfgs(n_layers=4, vocab=256000)
    cfg = dataclasses.replace(cfg, tie_embeddings=True)
    jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
    np_tree = jax.tree.map(np.asarray,
                           j_model_init(jax.random.PRNGKey(2), jcfg))
    assert "unembed" not in np_tree
    params = params_from_jax(np_tree, cfg, device="cpu")
    assert params["embed"].shape == (256000, cfg.d_model)
    mine = model_init(cfg, seed=0, device="cpu")
    got = tree.leaves_with_paths(params)
    assert [p for p, _ in got] == [p for p, _ in
                                   tree.leaves_with_paths(mine)]
    for (path, leaf), want, own in zip(got, jax.tree.leaves(np_tree),
                                       tree.leaves(mine)):
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=path)
        assert leaf.shape == own.shape, path
    bad = jax.tree.map(lambda a: a, np_tree)
    bad["stacks"][0]["l0"]["mix"].pop("lambda")
    with pytest.raises(ValueError, match="RG-LRU"):
        params_from_jax(bad, cfg, device="cpu")
    bad = dict(np_tree, unembed=np_tree["embed"].T)
    with pytest.raises(ValueError, match="ties"):
        params_from_jax(bad, cfg, device="cpu")
