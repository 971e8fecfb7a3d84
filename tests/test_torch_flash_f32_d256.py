"""The f32 flash kernels at head_dim 256 in the port against the JAX
package on the CPU.

The CUDA instances (``csrc/flash_f32_wide.cuh``: the D = 256 kernels of
``flash_fwd_f32.cu``, ``flash_dq_f32.cu`` and ``flash_dkv_f32.cu``) run
only on the card, where ``chip_smoke.py`` holds them to their plain
versions. Here the wrappers take their plain versions, as for every CPU
tensor, and are held against JAX's f32 ``flash_attention_mosaic`` (its
Pallas kernels in interpret mode, as its own tests run them) at head_dim
256 with MQA (4 query heads over one kv head) and a local window, in
dropout modes none, premask, replay and fused: O and lse within 2e-5,
dq, dk, dv within 1e-4. The wrappers send f32 D = 256 to the entry points
of the three f32 libraries and count the launches as the instances
``flash_*_f32_d256``. Then ``make_train_step`` at f32 compute with
``attn_impl="pallas"`` on the reduced recurrentgemma at head_dim 256 (R,
R, LOCAL, R; window 32, MQA): three steps at site "ffn_up" (the carried
plane made under the gate+up GEMM, replayed) and two in fused mode,
losses and grad norms within 1e-4 of JAX's, and at step 0 under premask
every plane the flash path reads bitwise JAX's oracle.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_f32_d256.py
"""
import contextlib
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.core.overlap import plan_from_config
from repro.data.pipeline import batch_for_step as j_batch
from repro.kernels import philox_common as jpc
from repro.kernels.ref import philox_mask_ref
from repro.train.loop import init_train_state as j_init_state
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.config import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.overlap import DropoutPlan
from repro_torch.data import batch_for_step
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels import flash_attention_bwd as tb
from repro_torch.kernels import launch_counts
from repro_torch.kernels import philox_common as tpc
from repro_torch.models import attention
from repro_torch.models.transformer import Runtime, forward
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step

import test_torch_train as base

jf = importlib.import_module("repro.kernels.flash_attention")

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, H, KV, S, D = 1, 4, 1, 128, 256
WINDOW = 48
ARGS = dict(causal=True, local_window=WINDOW, dropout_p=0.1, seed=9, salt=3)


def _operands(mode):
    """The JAX and the port operand of the mask slot for ``mode``."""
    if mode == "premask":
        plane = philox_mask_ref(B, H, S, S, 0.1, seed=9, salt=3)
        return plane, torch.from_numpy(np.array(plane).view(np.int32))
    if mode == "replay":
        return (jpc.seed_salt_smem(jnp.uint32(9), jnp.uint32(3)),
                tpc.seed_salt_smem(torch.tensor(9), 3))
    return None, None


@pytest.mark.parametrize("mode", ["none", "premask", "replay", "fused"])
def test_f32_d256_flash_equals_jax(mode):
    """O, lse and the gradients of q, k and v (the GQA group sum of the
    per-head dk, dv included) at head_dim 256, MQA and a window, against
    JAX's f32 kernels in interpret mode."""
    rng = np.random.default_rng(256 + len(mode))
    q, g = (rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, KV, S, D)).astype(np.float32)
            for _ in range(2))
    jm, tm = _operands(mode)
    args = (True, WINDOW, 0.1, mode, 9, 3, 7)

    def f(q_, k_, v_):
        return jf.flash_attention_mosaic(q_, k_, v_, jm, *args, 128, 128,
                                         True, 0)

    jo, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    _, jlse = jf.flash_attention_fwd(*map(jnp.asarray, (q, k, v)), jm,
                                     mode=mode, return_lse=True,
                                     interpret=True, **ARGS)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = tf.flash_attention_mosaic(tq, tk, tv, tm, *args, 0)
    to.backward(torch.from_numpy(g))
    _, tlse = tf.flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(),
                                     tm, mode=mode, return_lse=True, **ARGS)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors routed as if they lay on the card: each entry point
    records its arguments instead of launching
    (tests/test_torch_gemm_tc.py's pattern)."""
    calls = []

    def kernel_fn(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class Stream:
        cuda_stream = 0

    for mod in (tf, tb):
        monkeypatch.setattr(mod, "_kernel_fn", kernel_fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    return calls


def test_f32_d256_wrappers_reach_the_f32_entry_points(fake_card):
    """f32 q/k/v at head_dim 256 pass the kernels' shape check and reach
    repro_flash_fwd, repro_flash_dq and repro_flash_dkv (the f32
    libraries, whose D = 256 instances are kernels of their own) with D =
    256, counted as flash_fwd_f32_d256, flash_dq_f32_d256 and
    flash_dkv_f32_d256 -- not as the D <= 128 instances."""
    x = torch.zeros((1, 2, 64, 256), dtype=torch.float32)
    kv = torch.zeros((1, 1, 64, 256), dtype=torch.float32)
    rows = torch.zeros((1, 2, 64), dtype=torch.float32)
    assert 256 in tf.KERNEL_HEAD_DIMS[torch.float32]
    assert tf.kernel_shape_unsupported_reason(64, 64, 256) is None
    dp = tf.resolve_dropout("replay", None, batch=1, n_heads=2, sq=64,
                            sk=64, dropout_p=0.1, seed=9, salt=3, rounds=7,
                            heads_global=0)
    before = launch_counts()
    tf._fwd_kernel(x, kv, kv, dp, True, 32, 0.0625)
    for name in tb.KERNELS[torch.float32]:
        tb._bwd_kernel(name, x, kv, kv, x, rows, rows, x,
                       None if name == tb.KERNEL_DQ else x, dp, True, 32,
                       0.0625)
    after = launch_counts()
    names = ("flash_fwd_f32_d256", "flash_dq_f32_d256", "flash_dkv_f32_d256")
    assert [after[n] - before[n] for n in names] == [1, 1, 1]
    assert all(after[n] == before[n] for n in after if n not in names)
    assert [name for name, _ in fake_card] == ["flash_fwd", "flash_dq",
                                               "flash_dkv"]
    # (B, H, KV, SQ, SK, D) follow the five / nine pointers
    assert fake_card[0][1][5:11] == (1, 2, 1, 64, 64, 256)
    assert all(args[9:15] == (1, 2, 1, 64, 64, 256)
               for _, args in fake_card[1:])
    csrc = Path(build.CSRC)
    for src, kernel in (("flash_fwd_f32", "flash_fwd_kernel_wide"),
                        ("flash_dq_f32", "flash_dq_kernel_split"),
                        ("flash_dkv_f32", "flash_dkv_kernel_wide")):
        text = (csrc / f"{src}.cu").read_text()
        assert kernel in text and '#include "flash_f32_wide.cuh"' in text
    x = torch.zeros((1, 2, 64, 512), dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tf.check_kernel_shapes(x, x, x)


# ------------------------------------------------------------ the model

STEPS = 3


def _cfgs():
    """The reduced recurrentgemma (R, R, LOCAL, R; MQA, window 32) at
    head_dim 256, on both sides."""
    return (dataclasses.replace(get_arch("recurrentgemma-9b", reduced=True),
                                head_dim=256),
            dataclasses.replace(j_get_arch("recurrentgemma-9b",
                                           reduced=True), head_dim=256))


def _knobs(site, mode="overlap", replay="auto"):
    knobs = base._knobs(site, replay)
    knobs["dropout"]["mode"] = mode
    return knobs


def _trajectories(knobs, steps):
    """(port metrics, JAX metrics) of ``steps`` f32 steps from JAX's
    initial weights, each side with its own batches."""
    cfg, jcfg = _cfgs()
    jrun = dataclasses.replace(base._jax_run("recurrentgemma-9b", knobs),
                               model=jcfg)
    run = dataclasses.replace(base._port_run("recurrentgemma-9b", knobs),
                              model=cfg)
    jstate = j_init_state(jax.random.PRNGKey(0), jcfg)
    master = params_from_jax(jax.tree.map(np.asarray, jstate["master"]),
                             cfg, device="cpu")
    jstep = jax.jit(j_make_train_step(jcfg, jrun))
    step = make_train_step(cfg, run)
    state = {"master": master, "opt": adamw_init(master), "step": 0}
    got, want = [], []
    for i in range(steps):
        x, y = j_batch(jcfg, jrun.shape, i, seed=0)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        want.append({k: float(v) for k, v in jm.items()})
        x, y = batch_for_step(cfg, run.shape, i, seed=0)
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        got.append({k: float(v) for k, v in m.items()})
    return got, want


@pytest.mark.parametrize("site,mode,steps", [("ffn_up", "overlap", STEPS),
                                             ("xla", "fused", 2)],
                         ids=["ffn_up", "fused"])
def test_griffin_d256_f32_train_steps_equal_jax(site, mode, steps):
    """Steps of the reduced recurrentgemma at head_dim 256 and f32 compute
    through the flash path: loss, ce and grad norm within 1e-4 of JAX's
    (JAX runs its fused plans through its tensor-op attention; the port's
    flash kernels draw the same bits)."""
    got, want = _trajectories(_knobs(site, mode), steps)
    for g, w in zip(got, want):
        for key in ("loss", "ce", "grad_norm"):
            assert np.isfinite(g[key]), key
            assert g[key] == pytest.approx(w[key], **base.APPROX), key


def test_griffin_d256_f32_planes_equal_jax(monkeypatch):
    """Premask consumption at site "ffn_up": the plane the LOCAL layer's
    flash call reads (the bootstrap from the standalone Philox kernel's
    plain version; the only attention layer) is bitwise JAX's oracle, and
    the logits are within 1e-4 of a replayed forward's."""
    cfg, jcfg = _cfgs()
    knobs = _knobs("ffn_up", replay="off")
    run = dataclasses.replace(base._port_run("recurrentgemma-9b", knobs),
                              model=cfg)
    jrun = dataclasses.replace(base._jax_run("recurrentgemma-9b", knobs),
                               model=jcfg)
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init_state(jax.random.PRNGKey(0), jcfg)["master"]),
        cfg, device="cpu")
    x, _ = batch_for_step(cfg, run.shape, 0, seed=0)
    plan, jplan = DropoutPlan(run.dropout), plan_from_config(jrun.dropout)
    seen = []
    real = attention._attn_pallas_sharded

    def record(q, k, v, packed, *args, **kw):
        seen.append((q.shape, packed))
        return real(q, k, v, packed, *args, **kw)

    monkeypatch.setattr(attention, "_attn_pallas_sharded", record)
    logits, _ = forward(params, cfg, Runtime(plan=plan, step=0,
                                             attn_impl="pallas"),
                        torch.from_numpy(x))
    monkeypatch.undo()
    batch, seq = run.shape.global_batch, run.shape.seq_len
    assert len(seen) == 1 and seen[0][0][3] == 256
    layer = 2   # R, R, LOCAL, R
    want = philox_mask_ref(batch, cfg.n_heads, seq, seq, 0.1,
                           int(jplan.step_seed(0)),
                           salt=int(jplan.salt(layer)))
    np.testing.assert_array_equal(seen[0][1].numpy().view(np.uint32),
                                  np.asarray(want))
    replayed, _ = forward(params, cfg, Runtime(
        plan=DropoutPlan(dataclasses.replace(run.dropout,
                                             attn_replay="auto")),
        step=0, attn_impl="pallas"), torch.from_numpy(x))
    np.testing.assert_allclose(replayed.numpy(), logits.numpy(),
                               **base.TOL)
