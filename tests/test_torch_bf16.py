"""The port's bf16 training step against the JAX package's on the CPU.

Kernel level: the bf16 GEMM+RNG host (C within 3e-2, the plane bitwise
JAX's and the f32 host's, Region 3 included, the dgrad pair within 3e-2)
and the flash forward / backward at bf16 q/k/v (none, premask and replay;
MHA and GQA 2:1; out, dq, dk, dv within 3e-2, lse within 2e-5 -- it is f32
arithmetic on the exactly upcast inputs), the JAX tests' bf16 tolerance.
Model level: ``gemm_with_mask`` at gemm_dtype "f32" / "bf16" under f32 and
bf16 activations (JAX's casts), the layers' casts (RMSNorm, RoPE, SwiGLU,
embedding, f32 unembedding), ``attention_xla`` with bf16 probabilities
(alone and through a step with ``attn_probs_bf16``), the schedule (JAX's
text for bf16 dense and MoE plans; what the port still refuses at bf16
compute raises), and 3-step ``make_train_step`` trajectories at
``compute_dtype=bf16`` of the reduced llama2 and yi (GQA) against JAX's,
with the JAX weights carried over by ``params_from_jax``; replay ==
premask bitwise in the port; gemm_dtype "f32" under bf16 compute runs the
same kernel as "bf16" (bitwise the same step); the block's roundings
against JAX's compiled block (the forward's logits, step 2's gradients
from JAX's own state). Inputs are made with numpy
from a seed and rounded to bf16 before both sides see them; the JAX
kernels run in Pallas interpret mode, the port's wrappers take their
plain versions on the CPU.

    PYTHONPATH=src python -m pytest -q tests/test_torch_bf16.py

The ``gpu``-marked test holds the bf16 CUDA kernels against their plain
versions on the card and skips here.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core import producer as jproducer
from repro.core.attention import attention_xla as j_attention_xla
from repro.core.overlap import plan_from_config
from repro.core.schedule import compile_schedule as j_compile
from repro.data.pipeline import batch_for_step as j_batch
from repro.kernels import gemm_rng as jg
from repro.kernels import philox_common as jpc
from repro.kernels.ref import philox_mask_ref
from repro.train.loop import init_train_state as j_init_state
from repro.train.loop import make_eval_step as j_make_eval_step
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import producer
from repro_torch.core.attention import attention_xla
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.data import batch_for_step
from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels import flash_attention_bwd as tb
from repro_torch.kernels import gemm_rng as tg
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import philox_common as tpc
from repro_torch.optim import adamw_init
from repro_torch.train import make_eval_step, make_grad_fn, make_train_step

import test_torch_train as base

jf = importlib.import_module("repro.kernels.flash_attention")
jfb = importlib.import_module("repro.kernels.flash_attention_bwd")
jattn = importlib.import_module("repro.models.attention")

BF16 = torch.bfloat16
# the JAX tests' bf16 tolerance (tests/test_kernels_flash_attention.py,
# test_kernels_gemm_rng.py)
TOL = dict(atol=3e-2, rtol=3e-2)
LSE_TOL = dict(atol=2e-5, rtol=2e-5)
# Model level, bf16 compute, 3 steps (two at the full learning rate)
# against JAX. A bf16 rounding of an f32 sum taken in another order flips
# by one bf16 ulp (2^-8 relative) where the sum lies near a rounding
# boundary: the loss moves by far less (measured 1.9e-5 relative), a
# gradient norm more (measured 7.9e-4; JAX's own sites "xla" and "qkv"
# differ by 3.5e-4 at step 0), and AdamW turns a flipped near-zero
# gradient into a weight step of up to lr the other way, so a master
# weight may end up to 2 lr a step away after the two full-rate updates
# (measured 2.6e-3 = 2.6 lr, on the embedding). That per-weight limit
# cannot see a master that did not move, so each leaf's change over the
# 3 steps is held too: |port's change - JAX's change| / |JAX's change|
# (Frobenius), measured 0.097 at worst (the embedding, whose rows of
# unseen tokens move by weight decay and sign flips alone), 0.027 on
# every other leaf; a master left unchanged reads 1, one moved the wrong
# way 2.
LOSS_REL = 1e-4
GRAD_NORM_REL = 2e-3
WEIGHT_ATOL = 4 * base.OPT["lr"]
CHANGE_REL = 0.25


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bf16_np(rng, shape) -> np.ndarray:
    """Standard normal values that are bf16 numbers, as f32."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(BF16)


def _j(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ GEMM + RNG

# (m, k, n), logical blocks (bm, bn, bk), plane (B, H, SQ, SK), mask cols
GEMM_CASES = [
    ((256, 128, 256), (128, 128, 128), (2, 2, 64, 128), 128),
    ((512, 256, 384), (128, 128, 128), (2, 2, 64, 128), 128),
    # ffn_down's K at llama2 width: bk = 344
    ((64, 1376, 64), (64, 64, 344), (1, 1, 32, 64), 64),
]


@pytest.mark.parametrize("dims,blocks,plane,cols", GEMM_CASES)
def test_bf16_gemm_rng_equals_jax(dims, blocks, plane, cols):
    """C within 3e-2 of JAX's bf16 kernel and of the f32 product, in bf16;
    the plane bitwise JAX's, the oracle's and the f32 host's."""
    m, k, n = dims
    rng = np.random.default_rng(sum(dims))
    a, b = _bf16_np(rng, (m, k)), _bf16_np(rng, (k, n))
    mb, mh, sq, sk = plane
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sk, p=0.25,
              seed=4, salt=2, block_m=blocks[0], block_n=blocks[1],
              block_k=blocks[2], mask_block_cols=cols)
    c, mask = tg.gemm_with_rng(_t(a), _t(b), **kw)
    jc, jmask = jg.gemm_with_rng(_j(a), _j(b), **kw)
    assert c.dtype == BF16 and jc.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(c), _f32(jc), **TOL)
    np.testing.assert_allclose(_f32(c), a @ b, **TOL)
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    _, mask32 = tg.gemm_with_rng(torch.from_numpy(a), torch.from_numpy(b),
                                 **kw)
    assert torch.equal(mask, mask32)
    np.testing.assert_array_equal(
        _u32(mask), np.asarray(philox_mask_ref(mb, mh, sq, sk, 0.25, 4,
                                               salt=2)))
    pc, pmask = tg.gemm_with_rng_plain(_t(a), _t(b), **kw)
    assert torch.equal(pc, c) and torch.equal(pmask, mask)


def test_bf16_gemm_rng_region3_and_grads_equal_jax():
    """Region 3: (plain bf16 product, None) as JAX's. The dgrad pair: bf16
    products with f32 sums rounded to bf16 (JAX's ``_dgrad_pair``)."""
    rng = np.random.default_rng(5)
    a, b = _bf16_np(rng, (128, 128)), _bf16_np(rng, (128, 128))
    kw = dict(mask_batch=8, mask_heads=16, mask_sq=2048, mask_sk=2048,
              p=0.1, seed=0, block_m=128, block_n=128, block_k=128)
    c, mask = tg.gemm_with_rng(_t(a), _t(b), **kw)
    jc, jmask = jg.gemm_with_rng(_j(a), _j(b), **kw)
    assert mask is None and jmask is None and c.dtype == BF16
    np.testing.assert_allclose(_f32(c), _f32(jc), **TOL)
    # gradients through a hosting call
    a, b = _bf16_np(rng, (256, 128)), _bf16_np(rng, (128, 256))
    dc = _bf16_np(rng, (256, 256))
    kw = dict(mask_batch=2, mask_heads=2, mask_sq=64, mask_sk=128, p=0.25,
              seed=4, salt=2, block_m=128, block_n=128, block_k=128,
              mask_block_cols=128)
    ta, tb_ = _t(a).requires_grad_(), _t(b).requires_grad_()
    c, _ = tg.gemm_with_rng(ta, tb_, **kw)
    c.backward(_t(dc))

    def jloss(x, y):
        return jnp.sum(jg.gemm_with_rng(x, y, **kw)[0].astype(jnp.float32)
                       * _j(dc).astype(jnp.float32))

    jda, jdb = jax.grad(jloss, argnums=(0, 1))(_j(a), _j(b))
    assert ta.grad.dtype == BF16 and jda.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(ta.grad), _f32(jda), **TOL)
    np.testing.assert_allclose(_f32(tb_.grad), _f32(jdb), **TOL)


def test_bf16_host_checks_and_cpu_launches_nothing():
    """bf16 operands take the plain versions of the dense, grouped and fp8
    hosts on the CPU (C in bf16) and launch nothing; mixed dtypes and
    dtypes without a kernel raise."""
    reset_launch_counts()
    kw = dict(mask_batch=1, mask_heads=1, mask_sq=32, mask_sk=32, p=0.1,
              seed=0)
    a = torch.zeros((64, 32), dtype=BF16)
    for fn, ops in ((tg.gemm_with_rng, (a, a.T)),
                    (tg.gemm_with_rng_grouped, (a[None], a.T[None])),
                    (tg.gemm_with_rng_fp8, (a, a.T)),
                    (tg.gemm_with_rng_grouped_fp8, (a[None], a.T[None]))):
        c, _ = fn(*ops, **kw)
        assert c.dtype == BF16 and not c.any(), fn.__name__
    with pytest.raises(NotImplementedError, match="one dtype"):
        tg.gemm_with_rng(a, a.T.float(), **kw)
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        tg.gemm_with_rng(a.half(), a.T.half(), **kw)
    with pytest.raises(NotImplementedError, match="one dtype"):
        tg.gemm_with_rng_grouped(a[None], a.T[None].float(), **kw)
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        tg.gemm_with_rng_fp8(a.half(), a.T.half(), **kw)
    q = torch.zeros((1, 2, 64, 16), dtype=BF16)
    with pytest.raises(NotImplementedError, match="one dtype"):
        tf.check_kernel_shapes(q, q.float(), q)
    tf.check_kernel_shapes(q, q, q)
    assert set(launch_counts().values()) == {0}


# ------------------------------------------------------------ flash

@pytest.mark.parametrize("mode", ["none", "premask", "replay"])
@pytest.mark.parametrize("kv", [4, 2])
def test_bf16_flash_equals_jax(mode, kv):
    """Forward (out, lse) and backward (dq, dk, dv) at bf16 q/k/v against
    JAX's kernels in interpret mode; outputs in bf16, lse in f32, as
    JAX's; replay's bits are premask's."""
    b, h, s, d = 2, 4, 128, 32
    rng = np.random.default_rng(kv * 10 + len(mode))
    q, do = _bf16_np(rng, (b, h, s, d)), _bf16_np(rng, (b, h, s, d))
    k, v = _bf16_np(rng, (b, kv, s, d)), _bf16_np(rng, (b, kv, s, d))
    args = dict(causal=True, dropout_p=0.1, mode=mode, seed=9, salt=3)
    jplane = philox_mask_ref(b, h, s, s, 0.1, 9, salt=3)
    jop = {"premask": jplane, "replay": jpc.seed_salt_smem(9, 3)}.get(mode)
    top = {"premask": torch.from_numpy(np.array(jplane).view(np.int32)),
           "replay": tpc.seed_salt_smem(9, 3)}.get(mode)
    jo, jl = jf.flash_attention_fwd(_j(q), _j(k), _j(v), jop,
                                    return_lse=True, **args)
    o, lse = tf.flash_attention_fwd(_t(q), _t(k), _t(v), top,
                                    return_lse=True, **args)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(o), _f32(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **LSE_TOL)
    grads = tb.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), top,
                                   **args)
    jgrads = jfb.flash_attention_bwd(_j(q), _j(k), _j(v), jo, jl, _j(do),
                                     jop, **args)
    for got, want in zip(grads, jgrads):
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    if mode == "replay":
        o_p = tf.flash_attention_fwd(
            _t(q), _t(k), _t(v),
            torch.from_numpy(np.array(jplane).view(np.int32)),
            **dict(args, mode="premask"))
        assert torch.equal(o, o_p)


def test_bf16_flash_plain_rounds_once():
    """The plain versions compute in f32 on the upcast inputs and round
    each output once: at bf16 they are the f32 plain versions' outputs
    rounded to bf16."""
    b, h, s, d = 1, 2, 64, 16
    rng = np.random.default_rng(3)
    q, k, v, do = (_bf16_np(rng, (b, h, s, d)) for _ in range(4))
    args = dict(causal=True, dropout_p=0.1, mode="replay", seed=2, salt=1)
    o16, l16 = tf.flash_attention_fwd_plain(_t(q), _t(k), _t(v), **args)
    o32, l32 = tf.flash_attention_fwd_plain(*(torch.from_numpy(x)
                                              for x in (q, k, v)), **args)
    assert torch.equal(o16, o32.to(BF16)) and torch.equal(l16, l32)
    g16 = tb.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o16, l16,
                                       _t(do), **args)
    g32 = tb.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), o16.float(), l32,
        torch.from_numpy(do), **args)
    for a, b_ in zip(g16, g32):
        assert torch.equal(a, b_.to(BF16))


# ------------------------------------------------------------ producer

@pytest.mark.parametrize("gemm_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_gemm_with_mask_casts_as_jax(gemm_dtype, compute):
    """The dense host at gemm_dtype "f32" / "bf16" under f32 and bf16
    activations: y in the activations' dtype, within 3e-2 of JAX's (1e-4
    when everything is f32), the plane bitwise JAX's. Under bf16
    activations both dtypes run the bf16 kernel on the operands as they
    are, so y is the same bits."""
    dt, jdt = ((torch.float32, jnp.float32) if compute == "f32"
               else (BF16, jnp.bfloat16))
    rng = np.random.default_rng(11)
    x, w = _bf16_np(rng, (256, 128)), _bf16_np(rng, (128, 384))
    kw = dict(mode="overlap", site="qkv", p=0.25, seed=5,
              gemm_dtype=gemm_dtype)
    plan = DropoutPlan(DropoutPlanConfig(**kw))
    jplan = plan_from_config(JPlanConfig(**kw))
    shape, layer, step = (2, 2, 128, 128), 3, 1
    y, mask = producer.gemm_with_mask(
        torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt), plan, shape,
        layer, step, how=producer.HOW_GEMM)
    jy, jmask, jhow = jproducer.gemm_with_mask(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jplan, shape, layer, step,
        how=jproducer.HOW_GEMM)
    assert jhow == producer.HOW_GEMM
    assert y.dtype == dt and jy.dtype == jdt
    tol = TOL if "bf16" in (gemm_dtype, compute) else dict(atol=1e-4,
                                                          rtol=1e-4)
    np.testing.assert_allclose(_f32(y), _f32(jy), **tol)
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    if compute == "bf16":
        other = DropoutPlan(DropoutPlanConfig(**dict(
            kw, gemm_dtype={"f32": "bf16", "bf16": "f32"}[gemm_dtype])))
        y2, _ = producer.gemm_with_mask(
            torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt), other,
            shape, layer, step, how=producer.HOW_GEMM)
        assert torch.equal(y, y2)
    if (gemm_dtype, compute) == ("bf16", "f32"):
        # the host rounds its operands and C to bf16
        want = (torch.from_numpy(x) @ torch.from_numpy(w)).to(BF16)
        np.testing.assert_allclose(_f32(y), _f32(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("probs", [torch.float32, BF16])
def test_attention_xla_probs_dtype(dtype, probs):
    """``attention_xla`` casts P to ``probs_dtype`` after the softmax and
    drops and rescales it there (``attn_probs_bf16``), as JAX's does. The
    JAX program is compiled, and XLA may keep an f32 value it was asked to
    round to bf16 and back (excess precision), so the two agree at the
    bf16 tolerance; the port's bf16 probabilities are exactly its f32 ones
    rounded."""
    b, h, kv, s, d = 2, 4, 2, 128, 32
    rng = np.random.default_rng(7)
    q = _bf16_np(rng, (b, h, s, d))
    k, v = _bf16_np(rng, (b, kv, s, d)), _bf16_np(rng, (b, kv, s, d))
    kw = dict(mode="overlap", p=0.1, seed=3)
    jplan = plan_from_config(JPlanConfig(**kw))
    plane = jplan.precompute_mask(b, h, s, s, 1, 2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jpdt = jnp.float32 if probs == torch.float32 else jnp.bfloat16
    args = dict(causal=True, layer_idx=1, step=2, chunk_q=64)
    got = attention_xla(
        *(torch.from_numpy(t).to(dtype) for t in (q, k, v)),
        plan=DropoutPlan(DropoutPlanConfig(**kw)),
        packed_mask=torch.from_numpy(np.array(plane).view(np.int32)),
        probs_dtype=probs, **args)
    want = j_attention_xla(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                           plan=jplan, packed_mask=plane, probs_dtype=jpdt,
                           **args)
    assert got.dtype == dtype
    tol = (dict(atol=1e-5, rtol=1e-5)
           if (dtype, probs) == (torch.float32, torch.float32) else TOL)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    if probs == BF16 and dtype == torch.float32:
        f32 = attention_xla(
            *(torch.from_numpy(t) for t in (q, k, v)),
            plan=DropoutPlan(DropoutPlanConfig(**kw)),
            packed_mask=torch.from_numpy(np.array(plane).view(np.int32)),
            probs_dtype=torch.float32, **args)
        assert not torch.equal(got, f32)


# ------------------------------------------------------------ model casts

def test_bf16_layer_casts_equal_jax():
    """The model's casts at bf16 compute follow JAX's: the embedding cast
    to the compute dtype, RMSNorm and RoPE in f32 rounded back to bf16,
    the SwiGLU activation in f32 then bf16, and the f32 unembedding. Each
    layer gets the same bf16 inputs and parameters on both sides; outputs
    have JAX's dtypes; the elementwise f32 layers (RMSNorm, RoPE, the
    embedding) give JAX's bits, the GEMM layers agree within a bf16
    rounding of f32 sums taken in another order."""
    from repro.models import layers as jl
    from repro.models import transformer as jt
    from repro_torch.models import layers as tl
    from repro_torch.models import transformer as tt
    cfg, jcfg = get_arch("llama2-7b", reduced=True), j_get_arch(
        "llama2-7b", reduced=True)
    rng = np.random.default_rng(4)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    x = _bf16_np(rng, (2, 64, d))
    scale = 1.0 + 0.1 * _bf16_np(rng, (d,))
    got = tl.norm_apply({"scale": _t(scale)}, _t(x), cfg)
    want = jl.norm_apply({"scale": _j(scale)}, _j(x), jcfg)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    qh = _bf16_np(rng, (2, 4, 64, hd))
    pos = np.arange(64, dtype=np.int32)
    got = tl.apply_rope(_t(qh), torch.from_numpy(pos), cfg.rope_theta)
    want = jl.apply_rope(_j(qh), jnp.asarray(pos), jcfg.rope_theta)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    p = {k: _bf16_np(rng, s) / np.sqrt(s[0]) for k, s in (
        ("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    got = tl.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    want = jl.ffn_apply({k: _j(v) for k, v in p.items()}, _j(x), jcfg)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    emb = _bf16_np(rng, (cfg.vocab_size, d))
    tokens = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    got = tt.embed_inputs({"embed": _t(emb)}, cfg, torch.from_numpy(tokens),
                          tt.Runtime(compute_dtype=BF16))
    want = jt.embed_inputs({"embed": _j(emb)}, jcfg, jnp.asarray(tokens),
                           jt.Runtime(compute_dtype=jnp.bfloat16))
    assert got.dtype == BF16 and np.array_equal(_f32(got), _f32(want))
    un = _bf16_np(rng, (d, cfg.vocab_size))
    got = tt.unembed({"unembed": _t(un)}, cfg, _t(x))
    want = jt.unembed({"unembed": _j(un)}, jcfg, _j(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("site", ["qkv", "prev_gemm", "ffn_up", "ffn_down"])
@pytest.mark.parametrize("replay", ["auto", "off"])
def test_bf16_dense_plans_equal_jax(site, replay):
    """bf16 hosts plan as JAX's: the same explain() text and records for
    the dense stacks and, at the FFN sites, the MoE stack's grouped
    hosts."""
    kw = dict(mode="overlap", site=site, p=0.1, gemm_dtype="bf16",
              attn_replay=replay)
    for arch in ("llama2-7b", "yi-6b"):
        sched = compile_schedule(get_arch(arch, reduced=True),
                                 DropoutPlanConfig(**kw), 2, 128,
                                 attn_impl="pallas")
        jsched = j_compile(j_get_arch(arch, reduced=True), JPlanConfig(**kw),
                           2, 128, attn_impl="pallas")
        assert sched.explain() == jsched.explain()
        assert sched.records() == jsched.records()
    if site.startswith("ffn"):
        arch = "moonshot-v1-16b-a3b"
        sched = compile_schedule(get_arch(arch, reduced=True),
                                 DropoutPlanConfig(**kw), 2, 128,
                                 attn_impl="pallas")
        jsched = j_compile(j_get_arch(arch, reduced=True), JPlanConfig(**kw),
                           2, 128, attn_impl="pallas")
        assert sched.explain() == jsched.explain()
        assert producer.HOW_GEMM_GROUPED in {a.emit_how
                                             for a in sched.assignments}


# ------------------------------------------------------------ training

def _bf16_knobs(site, replay, gemm_dtype="bf16"):
    knobs = base._knobs(site, replay)
    knobs["dropout"]["gemm_dtype"] = gemm_dtype
    return knobs


def _jax_bf16_trajectory(arch, knobs):
    run = base._jax_run(arch, knobs)
    state = j_init_state(jax.random.PRNGKey(0), run.model)
    master0 = jax.tree.map(np.asarray, state["master"])
    step_fn = jax.jit(j_make_train_step(run.model, run,
                                        compute_dtype=jnp.bfloat16))
    metrics = []
    for i in range(base.STEPS):
        x, y = j_batch(run.model, run.shape, i, seed=0)
        state, m = step_fn(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return master0, state, metrics


def _port_bf16_trajectory(arch, knobs, master):
    run = base._port_run(arch, knobs)
    step_fn = make_train_step(run.model, run, compute_dtype=BF16)
    state = {"master": master, "opt": adamw_init(master), "step": 0}
    metrics = []
    for i in range(base.STEPS):
        x, y = batch_for_step(run.model, run.shape, i, seed=0)
        state, m = step_fn(state, torch.from_numpy(x), torch.from_numpy(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-6b"])
@pytest.mark.parametrize("replay", ["auto", "off"])
def test_bf16_three_step_trajectory_equals_jax(arch, replay):
    """``make_train_step(compute_dtype=bf16)`` at site "qkv" / bf16 host on
    the flash path: loss and ce within LOSS_REL, grad norm within
    GRAD_NORM_REL of JAX's at every step, the final f32 master within
    WEIGHT_ATOL and each leaf's change over the steps within CHANGE_REL
    of JAX's; the master stays f32."""
    knobs = _bf16_knobs("qkv", replay)
    master0, jstate, jmetrics = _jax_bf16_trajectory(arch, knobs)
    cfg = get_arch(arch, reduced=True)
    state, metrics = _port_bf16_trajectory(
        arch, knobs, params_from_jax(master0, cfg, device="cpu"))
    for got, want in zip(metrics, jmetrics):
        for key in ("loss", "ce"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_REL), key
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=GRAD_NORM_REL)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    for (path, got), want, w0 in zip(tree.leaves_with_paths(state["master"]),
                                     jax.tree.leaves(jstate["master"]),
                                     jax.tree.leaves(master0)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=path)
        w0 = np.asarray(w0, np.float64)
        d_port = got.numpy().astype(np.float64) - w0
        d_jax = np.asarray(want, np.float64) - w0
        assert np.linalg.norm(d_port - d_jax) <= \
            CHANGE_REL * np.linalg.norm(d_jax), path


@pytest.mark.parametrize("impl,site,replay", [("xla", "xla", "auto"),
                                               ("pallas", "ffn_up", "auto"),
                                               ("pallas", "ffn_up", "off")])
def test_griffin_bf16_three_step_trajectory_equals_jax(impl, site, replay):
    """The reduced recurrentgemma (R, R, A, R; RG-LRU blocks and a LOCAL
    layer) at ``compute_dtype=bf16`` under both attention impls, the
    carried site "ffn_up" on the flash path: the same limits as the dense
    trajectories above. Two roundings of JAX's compiled program are the
    port's: each RG-LRU gate adds its bias in f32 (models/rglru.py
    ``_gates``), and the first norm of a unit's second and third blocks
    reads the previous block's unrounded sum (models/transformer.py
    ``block_apply``). Measured: loss within 4.9e-5, grad norm within
    1.2e-3, a leaf's change within 0.05; rounding as the source does read
    2.5e-3 at step 2 under "xla"."""
    knobs = _bf16_knobs(site, replay)
    knobs["sharding"]["attn_impl"] = impl
    arch = "recurrentgemma-9b"
    master0, jstate, jmetrics = _jax_bf16_trajectory(arch, knobs)
    cfg = get_arch(arch, reduced=True)
    state, metrics = _port_bf16_trajectory(
        arch, knobs, params_from_jax(master0, cfg, device="cpu"))
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        print(f"{impl}/{site} step {i}: grad norm {got['grad_norm']} "
              f"against JAX's {want['grad_norm']}, loss {got['loss']} "
              f"against {want['loss']}")
        for key in ("loss", "ce"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_REL), key
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=GRAD_NORM_REL)
    for (path, got), want, w0 in zip(tree.leaves_with_paths(state["master"]),
                                     jax.tree.leaves(jstate["master"]),
                                     jax.tree.leaves(master0)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=path)
        w0 = np.asarray(w0, np.float64)
        d_port = got.numpy().astype(np.float64) - w0
        d_jax = np.asarray(want, np.float64) - w0
        assert np.linalg.norm(d_port - d_jax) <= \
            CHANGE_REL * np.linalg.norm(d_jax), path


# the 2-block bf16 recurrentgemma's logits against JAX's jitted forward,
# Frobenius, relative: the port reads 0 on some hosts and 6.35e-4 on
# others (XLA's CPU code is not bitwise the same on every host), the same
# port with the second block's norm reading the rounded sum 4.3e-3
GRIFFIN_UNIT_REL = 1.5e-3


def test_griffin_unit_rounds_as_compiled_jax(monkeypatch):
    """Two RG-LRU blocks of one stack unit at bf16 compute: the logits are
    within GRIFFIN_UNIT_REL of JAX's jitted forward's (the second block's
    first norm reads the first block's unrounded sum), and the control --
    that norm reading the rounded sum -- lies outside it. The limit is
    not bitwise: XLA's CPU code differs from host to host."""
    from repro.models import Runtime as JRuntime
    from repro.models import forward as j_forward
    from repro.models.transformer import model_init as j_model_init
    from repro_torch.models import Runtime, forward
    from repro_torch.models import transformer
    jcfg = dataclasses.replace(j_get_arch("recurrentgemma-9b", reduced=True),
                               n_layers=2)
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b", reduced=True),
                              n_layers=2)
    master = jax.tree.map(np.asarray,
                          j_model_init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    jrt = JRuntime(plan=None, compute_dtype=jnp.bfloat16)
    want = jax.jit(lambda p, t: j_forward(p, jcfg, jrt, t)[0])(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), master),
        jnp.asarray(tokens))
    params = tree.tree_map(lambda t: t.to(BF16),
                           params_from_jax(master, cfg, device="cpu"))

    def logits():
        with torch.no_grad():
            return forward(params, cfg, Runtime(compute_dtype=BF16),
                           torch.from_numpy(tokens))[0].float().numpy()

    rel = _rel(logits(), want)
    block = transformer.block_apply
    monkeypatch.setattr(transformer, "block_apply",
                        lambda *a, x32=None, **k: block(*a, x32=None, **k))
    rel_rounded = _rel(logits(), want)
    print(f"griffin unit logits from JAX's jitted forward: {rel:.3g}; the "
          f"rounded-sum control {rel_rounded:.3g} (limit "
          f"{GRIFFIN_UNIT_REL})")
    assert rel <= GRIFFIN_UNIT_REL < rel_rounded


# JAX's compiled bf16 block keeps two sums in f32 that its source rounds
# to bf16 (XLA's excess precision; the CPU program's fusions show it): the
# residual sum the second norm reads, and the FFN GEMMs' input cotangents
# that the norm's backward reads. The port does the same in models
# without MoE layers (models/transformer.py::_residual_norm). Measured at
# the trajectory's step-2 state (llama2 / yi): the bf16 logits 1.55e-3 /
# 1.22e-3 (Frobenius, relative) from JAX's jitted forward, where rounding
# as the source does read 8.78e-3 / 8.41e-3 -- as far as JAX's own
# op-by-op evaluation is from its jitted one (8.76e-3 / 8.41e-3); step
# 2's gradients 0.13-0.77 % / 0.11-0.87 % from JAX's leaf by leaf, where
# rounding as the source does read 0.38-1.27 % / 0.69-1.43 %.
BLOCK_LOGITS_REL = 4e-3
BLOCK_GRAD_REL = 1e-2


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-6b"])
def test_bf16_block_rounds_as_compiled_jax(arch):
    """At bf16 compute the port rounds as JAX's compiled block does: the
    forward's logits within BLOCK_LOGITS_REL of JAX's jitted forward (JAX
    evaluated op by op, with every rounding of its source, is printed
    beside them), and the gradients of step 2 of the trajectory (site
    "qkv", replay off) taken from JAX's own step-1 state within
    BLOCK_GRAD_REL of JAX's, leaf by leaf (each printed)."""
    from repro.models import Runtime as JRuntime
    from repro.models import forward as j_forward
    from repro_torch.models import Runtime, forward
    knobs = _bf16_knobs("qkv", "off")
    jrun = base._jax_run(arch, knobs)
    jcfg, cfg = jrun.model, get_arch(arch, reduced=True)
    state = j_init_state(jax.random.PRNGKey(0), jcfg)
    jstep = jax.jit(j_make_train_step(jcfg, jrun, compute_dtype=jnp.bfloat16))
    for i in range(2):
        x, y = j_batch(jcfg, jrun.shape, i, seed=0)
        state, _ = jstep(state, jnp.asarray(x), jnp.asarray(y))
    master = jax.tree.map(np.asarray, state["master"])
    tmaster = params_from_jax(master, cfg, device="cpu")

    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), master)
    jrt = JRuntime(plan=None, compute_dtype=jnp.bfloat16)
    want = jax.jit(lambda p, t: j_forward(p, jcfg, jrt, t)[0])(
        jparams, jnp.asarray(tokens))
    with jax.disable_jit():
        op_by_op = j_forward(jparams, jcfg, jrt, jnp.asarray(tokens))[0]
    got, _ = forward(tree.tree_map(lambda t: t.to(BF16), tmaster), cfg,
                     Runtime(compute_dtype=BF16), torch.from_numpy(tokens))
    logits_rel = _rel(got.numpy(), want)
    print(f"{arch}: logits {logits_rel:.4g} from JAX's jitted forward; "
          f"JAX op by op {_rel(op_by_op, want):.4g} from it, "
          f"{_rel(got.numpy(), op_by_op):.4g} from the port")
    assert logits_rel <= BLOCK_LOGITS_REL

    # JAX's step-2 gradients: its train step's loss, differentiated alone
    from repro.train import loop as jloop
    plan, sched = plan_from_config(jrun.dropout), \
        jloop.compile_run_schedule(jcfg, jrun)

    def loss_fn(m, xb, yb):
        p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), m)
        rt = JRuntime(plan=plan, step=2, compute_dtype=jnp.bfloat16,
                      remat=jrun.sharding.remat,
                      attn_impl=jrun.sharding.attn_impl, schedule=sched)
        logits, aux = j_forward(p, jcfg, rt, xb)
        return jloop.cross_entropy(logits, yb) + jloop.AUX_WEIGHT * aux

    x, y = j_batch(jcfg, jrun.shape, 2, seed=0)
    jgrads = jax.jit(jax.grad(loss_fn))(state["master"], jnp.asarray(x),
                                        jnp.asarray(y))
    _, _, grads = make_grad_fn(cfg, base._port_run(arch, knobs),
                               compute_dtype=BF16)(
        tmaster, torch.from_numpy(x), torch.from_numpy(y), 2)
    norms = [np.sqrt(sum(float(np.sum(np.square(np.asarray(a, np.float64))))
                         for a in t))
             for t in ([g.numpy() for g in tree.leaves(grads)],
                       jax.tree.leaves(jgrads))]
    print(f"{arch}: step-2 grad norm {norms[0]:.7g}, JAX's {norms[1]:.7g}")
    for (path, g), w in zip(tree.leaves_with_paths(grads),
                            jax.tree.leaves(jgrads)):
        rel = _rel(g.numpy(), w)
        print(f"{arch}: step-2 gradient {path} {rel:.4g} from JAX's")
        assert rel <= BLOCK_GRAD_REL, path


@pytest.mark.parametrize("arch", ["llama2-7b", "yi-6b"])
def test_bf16_replay_equals_premask_bitwise(arch):
    """At bf16 compute, replay and premask consume the same bits: step-0
    loss, every f32 gradient and the updated master are bitwise equal;
    gemm_dtype "f32" under bf16 compute runs the bf16 kernel on the same
    operands (as JAX does), so its step is bitwise the "bf16" one."""
    cfg = get_arch(arch, reduced=True)
    master = base.init_train_state(cfg, seed=1, device="cpu")["master"]
    x, y = (torch.from_numpy(t) for t in batch_for_step(
        cfg, base._port_run(arch, base._knobs("qkv", "off")).shape, 0,
        seed=0))
    out = {}
    for replay, gd in (("auto", "bf16"), ("off", "bf16"), ("off", "f32")):
        run = base._port_run(arch, _bf16_knobs("qkv", replay, gd))
        loss, _, grads = make_grad_fn(cfg, run, compute_dtype=BF16)(
            master, x, y, 0)
        state = {"master": tree.tree_map(torch.clone, master),
                 "opt": adamw_init(master), "step": 0}
        new, _ = make_train_step(cfg, run, compute_dtype=BF16)(state, x, y)
        out[(replay, gd)] = (loss, tree.leaves(grads),
                             tree.leaves(new["master"]))
    ref = out[("auto", "bf16")]
    assert all(g.dtype == torch.float32 for g in ref[1])
    for key in (("off", "bf16"), ("off", "f32")):
        loss, grads, new = out[key]
        assert torch.equal(loss, ref[0]), key
        assert all(torch.equal(a, b) for a, b in zip(grads, ref[1])), key
        assert all(torch.equal(a, b) for a, b in zip(new, ref[2])), key


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_attn_probs_bf16_step_equals_jax(compute):
    """``ShardingConfig(attn_probs_bf16=True)`` reaches the tensor-op
    attention through the step (site "xla", attn_impl "xla"): one step's
    loss and grad norm are JAX's within LOSS_REL / GRAD_NORM_REL, and
    differ from the same step with f32 probabilities."""
    knobs = _bf16_knobs("xla", "off")
    knobs["sharding"] = dict(attn_impl="xla", remat="block",
                             attn_probs_bf16=True)
    jrun = base._jax_run("llama2-7b", knobs)
    jstate = j_init_state(jax.random.PRNGKey(0), jrun.model)
    master0 = jax.tree.map(np.asarray, jstate["master"])
    x, y = j_batch(jrun.model, jrun.shape, 0, seed=0)
    jdt, dt = ((jnp.float32, torch.float32) if compute == "f32"
               else (jnp.bfloat16, BF16))
    _, jm = jax.jit(j_make_train_step(jrun.model, jrun, compute_dtype=jdt))(
        jstate, jnp.asarray(x), jnp.asarray(y))
    cfg = get_arch("llama2-7b", reduced=True)
    master = params_from_jax(master0, cfg, device="cpu")
    run = base._port_run("llama2-7b", knobs)
    metrics = {}
    for probs16 in (True, False):
        r = dataclasses.replace(run, sharding=dataclasses.replace(
            run.sharding, attn_probs_bf16=probs16))
        _, m = make_train_step(cfg, r, compute_dtype=dt)(
            {"master": master, "opt": adamw_init(master), "step": 0},
            torch.from_numpy(x), torch.from_numpy(y))
        metrics[probs16] = m
    got = metrics[True]
    assert float(got["loss"]) == pytest.approx(float(jm["loss"]),
                                               rel=LOSS_REL)
    assert float(got["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                    rel=GRAD_NORM_REL)
    assert not torch.equal(got["loss"], metrics[False]["loss"])


def test_bf16_eval_step_equals_jax():
    """``make_eval_step`` at bf16 compute: the cross entropy of JAX's."""
    knobs = _bf16_knobs("qkv", "auto")
    run = base._jax_run("llama2-7b", knobs)
    jmaster = j_init_state(jax.random.PRNGKey(0), run.model)["master"]
    x, y = j_batch(run.model, run.shape, 0, seed=0)
    want = float(j_make_eval_step(run.model, run, compute_dtype=jnp.bfloat16)(
        jmaster, jnp.asarray(x), jnp.asarray(y)))
    cfg = get_arch("llama2-7b", reduced=True)
    master = params_from_jax(jax.tree.map(np.asarray, jmaster), cfg,
                             device="cpu")
    got = float(make_eval_step(cfg, base._port_run("llama2-7b", knobs),
                               compute_dtype=BF16)(
        master, torch.from_numpy(x), torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=LOSS_REL)
    assert master["embed"].dtype == torch.float32    # the master untouched


def test_bf16_unported_raise():
    """What the port still refuses raises: fused-mode dropout with a
    producer site (``ValueError``, as in JAX). recurrentgemma at head_dim
    256 under ``attn_impl="pallas"`` runs at f32 compute (the f32 flash
    kernels' D = 256 instances; tests/test_torch_flash_f32_d256.py) and at
    bf16 compute. Fused-mode training and LOCAL / recurrent layers are
    ported (tests/test_torch_fused.py, tests/test_torch_rglru.py), and so
    are the prefill caches of LOCAL layers: ``attn_prefill`` over a prompt
    past the window runs within 1e-4 of JAX's, its ring cache included
    (tests/test_torch_serve_contiguous.py holds the whole serving path)."""
    from repro_torch.models.attention import attn_prefill
    from repro_torch.config.base import AttentionKind
    cfg = get_arch("recurrentgemma-9b", reduced=True)
    wide = dataclasses.replace(cfg, head_dim=256)
    knobs = _bf16_knobs("ffn_up", "auto")
    run = dataclasses.replace(base._port_run("recurrentgemma-9b", knobs),
                              model=wide)
    master = base.init_train_state(wide, seed=0, device="cpu")["master"]
    x, y = (torch.from_numpy(t) for t in batch_for_step(wide, run.shape, 0))
    loss, _, _ = make_grad_fn(wide, run)(master, x, y, 0)
    assert torch.isfinite(loss)
    loss, _, _ = make_grad_fn(wide, run, compute_dtype=BF16)(master, x, y, 0)
    assert torch.isfinite(loss)
    jcfg = j_get_arch("recurrentgemma-9b", reduced=True)
    jp = jattn.attn_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)
    y, cache = attn_prefill(tree.tree_map(torch.from_numpy,
                                          jax.tree.map(np.array, jp)),
                            torch.from_numpy(x), cfg,
                            kind=AttentionKind.LOCAL)
    jy, jcache = jattn.attn_prefill(jp, jnp.asarray(x), jcfg,
                                    kind=jcfg.block_pattern[-1], plan=None,
                                    layer_idx=0, step=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    for f in ("k", "v"):
        assert cache[f].shape[2] == cfg.local_window
        np.testing.assert_allclose(cache[f].numpy(), np.asarray(jcache[f]),
                                   atol=1e-4, rtol=1e-4)
    assert int(cache["len"]) == int(jcache["len"]) == 64
    for arch in ("llama2-7b", "moonshot-v1-16b-a3b"):
        knobs = _bf16_knobs("qkv", "off")
        knobs["dropout"]["mode"] = "fused"
        run = base._port_run(arch, knobs)
        with pytest.raises(ValueError, match="overlap"):
            make_grad_fn(get_arch(arch, reduced=True), run,
                         compute_dtype=BF16)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
def test_bf16_kernels_equal_plain_on_gpu():
    """The bf16 GEMM+RNG kernel (emission on and off) and the bf16 flash
    kernels against their plain versions on the card: planes bitwise, C
    and every output within 1e-2 (1 + |x|) -- one bf16 ulp is 2^-8 of a
    value, and f32 sums in another order may round either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none on this machine")
    reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(BF16)

    def close(got, want):
        assert got.dtype == want.dtype == BF16
        err = (got.float() - want.float()).abs()
        assert bool((err <= 1e-2 * (1 + want.float().abs())).all())

    a, w = rnd(512, 320), rnd(320, 384)
    kw = dict(mask_batch=2, mask_heads=4, mask_sq=256, mask_sk=256, p=0.1,
              seed=torch.tensor(7), salt=3, block_m=256, block_n=128,
              block_k=64)
    c, mask = tg.gemm_with_rng(a, w, **kw)
    want_c, want = tg.gemm_with_rng_plain(a, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(mask, want)
    close(c, want_c)
    c3, none = tg.gemm_with_rng(a, w, **dict(kw, block_m=512, block_n=384))
    assert none is None
    close(c3, want_c)
    q, do = rnd(2, 4, 256, 64), rnd(2, 4, 256, 64)
    kk, vv = rnd(2, 2, 256, 64), rnd(2, 2, 256, 64)
    sd = tpc.seed_salt_smem(torch.tensor(9), 3)
    args = dict(causal=True, dropout_p=0.1, mode="replay")
    o, lse = tf.flash_attention_fwd(q, kk, vv, sd, return_lse=True, **args)
    po, plse = tf.flash_attention_fwd_plain(q, kk, vv, sd, **args)
    grads = tb.flash_attention_bwd(q, kk, vv, o, lse, do, sd, **args)
    pdq, pdk, pdv = tb.flash_attention_bwd_plain(q, kk, vv, po, plse, do, sd,
                                                 **args)
    pdk, pdv = (t.reshape(2, 2, 2, 256, 64).sum(2) for t in (pdk, pdv))
    torch.cuda.synchronize()
    close(o, po)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    for got, want_g in zip(grads, (pdq, pdk, pdv)):
        close(got, want_g)
    counts = launch_counts()
    assert counts.pop(tg.KERNEL_BF16) == 2
    for name in (tf.KERNEL_BF16, tb.KERNEL_DQ_BF16, tb.KERNEL_DKV_BF16):
        assert counts.pop(name) == 1
    assert set(counts.values()) == {0}
