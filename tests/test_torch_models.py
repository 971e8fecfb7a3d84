"""The port's model against the JAX package on the reduced llama2 (MHA)
and yi (GQA 2:1) configs, with the JAX weights moved across by
``params_from_jax``. Tolerance 1e-4 (f32; XLA and torch sum in different
orders).

    PYTHONPATH=src python -m pytest -q tests/test_torch_models.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.core.attention import attention_xla as j_attention_xla
from repro.core.overlap import DropoutPlan as JPlan
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.models import (
    Runtime as JRuntime,
    decode_step_paged as j_decode_step_paged,
    model_init as j_model_init,
    paged_kv_write as j_paged_kv_write,
    paged_pools_init as j_paged_pools_init,
    prefill as j_prefill,
)
from repro.models import layers as jlayers
from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.attention import attention_xla
from repro_torch.core.overlap import DropoutPlan
from repro_torch.models import (
    Runtime,
    decode_step_paged,
    model_init,
    paged_kv_write,
    paged_pools_init,
    prefill,
)
from repro_torch.models import layers
from repro_torch.serve.paged_kv import PagePool

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["llama2-7b", "yi-6b"]


def _pair(arch):
    jcfg, cfg = j_get_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jp = j_model_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_init_matches_jax_tree(arch):
    """Same tree, shapes and scales as the JAX init; the converter is a
    plain copy."""
    jcfg, cfg, jp, tp = _pair(arch)
    mine = model_init(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    w = mine["stacks"][0]["l0"]["mix"]["w_q"]
    assert abs(float(w.std()) - 1 / np.sqrt(cfg.d_model)) < 0.01
    np.testing.assert_array_equal(
        tp["stacks"][0]["l0"]["ffn"]["w_down"].numpy(),
        np.asarray(jp["stacks"][0]["l0"]["ffn"]["w_down"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_vs_jax(arch):
    jcfg, cfg, jp, tp = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    jl, jc = j_prefill(jp, jcfg, JRuntime(plan=None), jnp.asarray(toks),
                       capacity=48, last_pos=33)
    tl, tc = prefill(tp, cfg, Runtime(), torch.from_numpy(toks),
                     capacity=48, last_pos=33)
    assert tl.shape == (2, 1, cfg.vocab_size)
    _close(tl, jl)
    for jstack, tstack in zip(jc, tc):
        for key in jstack:
            for f in ("k", "v"):
                assert tstack[key][f].shape == jstack[key][f].shape
                _close(tstack[key][f], jstack[key][f])
            np.testing.assert_array_equal(tstack[key]["len"].numpy(),
                                          np.asarray(jstack[key]["len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_with_keep_rows_vs_jax(arch):
    """Paged decode through a shuffled page table, with decode-dropout keep
    rows sliced from the same packed plane, against JAX for 3 steps."""
    jcfg, cfg, jp, tp = _pair(arch)
    plen, ps, cap, steps, p_drop = 12, 8, 32, 3, 0.1
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, plen))
    jl, jc = j_prefill(jp, jcfg, JRuntime(plan=None), jnp.asarray(prompt),
                       capacity=16)
    alloc = PagePool(num_pages=6, page_size=ps).allocate(4)
    alloc.pages.reverse()                       # non-contiguous map
    slots = np.asarray([alloc.physical_slot(i) for i in range(plen)])
    n_phys = 6 * ps + 4
    jpools = j_paged_pools_init(jcfg, n_phys, jnp.float32)
    jpools = [{k: {f: pool[f].at[:, :, slots, :].set(
        jc[si][k][f][:, 0, :, :plen, :]) for f in ("k", "v")}
        for k, pool in stack.items()} for si, stack in enumerate(jpools)]
    tpools = paged_pools_init(cfg, n_phys, torch.float32, device="cpu")
    for stack, jstack in zip(tpools, jpools):
        for key in stack:
            for f in ("k", "v"):
                stack[key][f].copy_(torch.from_numpy(
                    np.array(jstack[key][f])))
    phys = alloc.physical_index(cap)[None, :]
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=p_drop, seed=4))
    planes = [plan.precompute_mask(1, cfg.n_heads, cap, cap, layer, 0,
                                   device="cpu")
              for layer in range(cfg.n_layers)]
    tok, pos = int(np.argmax(np.asarray(jl)[0, -1])), plen
    for _ in range(steps):
        rows = np.stack([((pl.numpy()[0, :, pos // 32, :] >> (pos % 32)) & 1)
                         .astype(bool) for pl in planes])   # (L, H, CAP)
        keep = rows[:, None, :, None, :]                     # (L,1,H,1,CAP)
        toks = np.full((1, 1), tok, np.int32)
        posn = np.full((1, 1), pos, np.int32)
        jlog, jups = j_decode_step_paged(
            jp, jcfg, JRuntime(plan=None), jnp.asarray(toks), jpools,
            jnp.asarray(phys), jnp.asarray(posn),
            keep_rows=[{"l0": jnp.asarray(keep)}], p_drop=p_drop)
        tlog, tups = decode_step_paged(
            tp, cfg, Runtime(), torch.from_numpy(toks), tpools,
            torch.from_numpy(phys.astype(np.int64)), torch.from_numpy(posn),
            keep_rows=[{"l0": torch.from_numpy(keep)}], p_drop=p_drop)
        _close(tlog, jlog)
        _close(tups[0]["l0"]["k"], jups[0]["l0"]["k"])
        wslot = np.full((1, 1), alloc.physical_slot(pos), np.int32)
        jpools = j_paged_kv_write(jpools, jups, jnp.asarray(wslot))
        tpools = paged_kv_write(tpools, tups, torch.from_numpy(wslot))
        _close(tpools[0]["l0"]["v"], jpools[0]["l0"]["v"])
        tok, pos = int(np.argmax(np.asarray(jlog)[0, 0])), pos + 1


def test_attention_xla_chunks_and_packed_mask_vs_jax():
    """Multi-chunk causal attention (GQA 4:2) with and without
    overlap-mode packed keep bits against JAX; a padded last chunk keeps
    its mask rows aligned (the single-chunk result)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 96, 16), np.float32)
    k = rng.standard_normal((1, 2, 96, 16), np.float32)
    v = rng.standard_normal((1, 2, 96, 16), np.float32)
    jplan = JPlan(JPlanConfig(mode="overlap", p=0.2, seed=5))
    tplan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.2, seed=5))
    packed = tplan.precompute_mask(1, 4, 96, 96, 1, 0, device="cpu")
    jpacked = jplan.precompute_mask(1, 4, 96, 96, 1, 0)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jpacked))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for plan, jp, pm, jpm, chunk in ((None, None, None, None, 64),
                                     (tplan, jplan, packed, jpacked, 32)):
        want = j_attention_xla(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), plan=jp, packed_mask=jpm,
                               chunk_q=chunk)
        got = attention_xla(tq, tk, tv, plan=plan, packed_mask=pm,
                            chunk_q=chunk)
        _close(got, want)
    whole = attention_xla(tq, tk, tv, plan=tplan, packed_mask=packed,
                          chunk_q=96)
    padded = attention_xla(tq, tk, tv, plan=tplan, packed_mask=packed,
                           chunk_q=64)
    torch.testing.assert_close(padded, whole, **TOL)


@pytest.mark.parametrize("ffn", ["swiglu", "geglu", "gelu"])
def test_layers_vs_jax(ffn):
    """Norms, rope and the un-hosted FFN kinds against JAX."""
    import dataclasses
    from repro.config.base import FFNKind as JFFN, NormKind as JNorm
    from repro_torch.config.base import FFNKind, NormKind
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64), np.float32)
    for norm in ("rmsnorm", "layernorm"):
        jcfg = dataclasses.replace(j_get_arch("llama2-7b", reduced=True),
                                   ffn=JFFN(ffn), norm=JNorm(norm))
        cfg = dataclasses.replace(get_arch("llama2-7b", reduced=True),
                                  ffn=FFNKind(ffn), norm=NormKind(norm))
        jn = jlayers.norm_init(jcfg)
        jn = {k: v + 0.1 * jnp.arange(v.shape[0], dtype=jnp.float32)
              for k, v in jn.items()}
        tn = {k: torch.from_numpy(np.array(v)) for k, v in jn.items()}
        _close(layers.norm_apply(tn, torch.from_numpy(x), cfg),
               jlayers.norm_apply(jn, jnp.asarray(x), jcfg))
    jf = jlayers.ffn_init(jax.random.PRNGKey(1), jcfg)
    tf = {k: torch.from_numpy(np.array(v)) for k, v in jf.items()}
    _close(layers.ffn_apply(tf, torch.from_numpy(x), cfg),
           jlayers.ffn_apply(jf, jnp.asarray(x), jcfg))
    hx = rng.standard_normal((2, 3, 5, 16), np.float32)
    pos = np.arange(5, dtype=np.int32)
    _close(layers.apply_rope(torch.from_numpy(hx), torch.from_numpy(pos),
                             1e4),
           jlayers.apply_rope(jnp.asarray(hx), jnp.asarray(pos), 1e4))
    _close(layers.rms_head_norm(torch.ones(16), torch.from_numpy(hx), 1e-6),
           jlayers.rms_head_norm(jnp.ones(16), jnp.asarray(hx), 1e-6))
