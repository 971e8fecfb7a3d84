"""The port's contiguous-cache serving path against the JAX package's on the
CPU: ``cache_init``, ``prefill`` and ``decode_step`` for every layer kind
(FULL caches, LOCAL ring caches, RG-LRU and RWKV states, MoE decode),
16-bit and int8 caches, and the step makers ``make_prefill_step`` /
``make_serve_step``.

The reduced configs of the archs JAX's own
``tests/test_models_smoke.py::test_prefill_decode_matches_forward`` serves,
plus llama2, with JAX's weights carried over by ``params_from_jax``, at
f32. Prefill logits and every cache field agree within 1e-4 (``len``
exactly, int8 values bitwise), and so do 3 decode steps; the port's decode
agrees with the port's own forward within JAX's 2e-3. recurrentgemma's
window is 32: at prompt 33 its ring rolls in the prefill and wraps in the
decode, at prompt 20 it is zero-padded. Inputs are made with numpy from a
seed. This path runs no Pallas kernel in JAX and no CUDA kernel in the
port.

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve_contiguous.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.core.attention import attention_decode as j_attention_decode
from repro.models import Runtime as JRuntime
from repro.models import attention as jattn
from repro.models import cache_init as j_cache_init
from repro.models import decode_step as j_decode_step
from repro.models import model_init as j_model_init
from repro.models import prefill as j_prefill
from repro.models import rglru as jrglru
from repro.train.loop import make_prefill_step as j_make_prefill_step
from repro.train.loop import make_serve_step as j_make_serve_step
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import AttentionKind
from repro_torch.convert import params_from_jax
from repro_torch.core import attention_decode
from repro_torch.models import (
    Runtime,
    cache_init,
    decode_step,
    decode_step_paged,
    forward,
    paged_kv_write,
    paged_pools_init,
    prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trglru
from repro_torch.serve import PagePool
from repro_torch.train import make_prefill_step, make_serve_step

TOL = dict(atol=1e-4, rtol=1e-4)
# JAX's own limit for decode against the forward
# (tests/test_models_smoke.py::test_prefill_decode_matches_forward)
FORWARD_TOL = 2e-3
ARCHS = ["yi-6b", "qwen3-8b", "recurrentgemma-9b", "rwkv6-7b",
         "moonshot-v1-16b-a3b", "arctic-480b", "musicgen-large",
         "llama2-7b"]
B, S, NEW = 2, 33, 3


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX config, port config, JAX params, the same params in the port)."""
    jcfg, cfg = j_get_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def _inputs(cfg, s, seed=0):
    """(B, s) token ids, or (B, s, D) embeddings for an embedding
    front end."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_caches_equal(got, want, where=""):
    """Same tree, shapes and dtypes; ``len`` and int8 values exact, the
    rest within TOL."""
    assert len(got) == len(want), where
    for si, (gs, ws) in enumerate(zip(got, want)):
        assert sorted(gs) == sorted(ws), where
        for key in gs:
            assert sorted(gs[key]) == sorted(ws[key]), (where, key)
            for f, g in gs[key].items():
                g, w = _np(g), np.asarray(ws[key][f])
                msg = f"{where} stack {si} {key}.{f}"
                assert g.shape == w.shape, msg
                assert g.dtype == w.dtype, msg
                if f == "len" or g.dtype == np.int8:
                    np.testing.assert_array_equal(g, w, err_msg=msg)
                else:
                    np.testing.assert_allclose(g, w, err_msg=msg, **TOL)


def _runtimes():
    return JRuntime(plan=None, chunk_q=16), Runtime(chunk_q=16)


# --------------------------------------------------- model level vs JAX

@pytest.mark.parametrize("arch,s", [(a, S) for a in ARCHS]
                         + [("recurrentgemma-9b", 20)])
def test_prefill_and_decode_equal_jax(arch, s):
    """Prefill logits and caches, then NEW decode steps (logits and
    caches after each), against JAX's."""
    jcfg, cfg, jparams, tparams = _models(arch)
    jrt, rt = _runtimes()
    inp = _inputs(cfg, s + NEW)
    jlg, jc = j_prefill(jparams, jcfg, jrt, jnp.asarray(inp[:, :s]),
                        capacity=s + NEW)
    lg, c = prefill(tparams, cfg, rt, torch.from_numpy(inp[:, :s]),
                    capacity=s + NEW)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_caches_equal(c, jc, "prefill")
    for t in range(NEW):
        tok = inp[:, s + t:s + t + 1]
        jlg, jc = j_decode_step(jparams, jcfg, jrt, jnp.asarray(tok), jc)
        lg, c = decode_step(tparams, cfg, rt, torch.from_numpy(tok), c)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _assert_caches_equal(c, jc, f"decode {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's prefill + decode against the port's forward on the whole
    sequence, at the positions decoded: JAX's own check and limit."""
    _, cfg, _, tparams = _models(arch)
    _, rt = _runtimes()
    inp = torch.from_numpy(_inputs(cfg, S + NEW, seed=1))
    with torch.no_grad():
        full, _ = forward(tparams, cfg, rt, inp)
        lg, c = prefill(tparams, cfg, rt, inp[:, :S], capacity=S + NEW)
        err = float((lg[:, 0] - full[:, S - 1]).abs().max())
        for t in range(NEW):
            lg, c = decode_step(tparams, cfg, rt, inp[:, S + t:S + t + 1], c)
            err = max(err, float((lg[:, 0] - full[:, S + t]).abs().max()))
    assert err < FORWARD_TOL, (arch, err)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "yi-6b"])
def test_int8_cache_decode_equals_jax(arch):
    """``kv_bits=8``: 36 tokens decoded from empty caches (recurrentgemma's
    32-slot ring wraps): the logits of every step within TOL, the int8
    keys and values bitwise, their scale columns within TOL."""
    jcfg, cfg, jparams, tparams = _models(arch)
    jrt, rt = _runtimes()
    n = 36
    inp = _inputs(cfg, n, seed=2)
    jc = j_cache_init(jcfg, B, n, jnp.float32, kv_bits=8)
    c = cache_init(cfg, B, n, torch.float32, kv_bits=8, device="cpu")
    jstep = jax.jit(lambda p, x, cc: j_decode_step(p, jcfg, jrt, x, cc))
    for t in range(n):
        jlg, jc = jstep(jparams, jnp.asarray(inp[:, t:t + 1]), jc)
        lg, c = decode_step(tparams, cfg, rt,
                            torch.from_numpy(inp[:, t:t + 1]), c)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   err_msg=f"step {t}", **TOL)
    _assert_caches_equal(c, jc, "int8")
    assert any(c8["k"].dtype == torch.int8 for st in c for c8 in st.values()
               if "k" in c8)


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("prefilled", [0, 7])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b",
                                  "moonshot-v1-16b-a3b", "yi-6b"])
def test_cache_init_equals_jax(arch, prefilled, kv_bits):
    """``cache_init`` trees, shapes, dtypes and values (zeros, ``len`` =
    ``prefilled_len``) against JAX's, LOCAL rings at min(max_len,
    window)."""
    jcfg, cfg, _, _ = _models(arch)
    for max_len in (24, 40):
        want = j_cache_init(jcfg, 3, max_len, jnp.float32,
                            prefilled_len=prefilled, kv_bits=kv_bits)
        got = cache_init(cfg, 3, max_len, torch.float32,
                         prefilled_len=prefilled, kv_bits=kv_bits,
                         device="cpu")
        _assert_caches_equal(got, want, f"max_len {max_len}")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "moonshot-v1-16b-a3b"])
def test_step_makers_equal_jax(arch, tmp_path):
    """``make_prefill_step(capacity=)`` and ``make_serve_step`` against
    JAX's: logits and caches."""
    jcfg, cfg, jparams, tparams = _models(arch)
    inp = _inputs(cfg, S + 2, seed=3)
    jlg, jc = j_make_prefill_step(jcfg, capacity=S + 2)(
        jparams, jnp.asarray(inp[:, :S]))
    lg, c = make_prefill_step(cfg, capacity=S + 2)(
        tparams, torch.from_numpy(inp[:, :S]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_caches_equal(c, jc, "prefill step")
    jserve, serve = j_make_serve_step(jcfg), make_serve_step(cfg)
    for t in range(2):
        tok = inp[:, S + t:S + t + 1]
        jlg, jc = jserve(jparams, jnp.asarray(tok), jc)
        lg, c = serve(tparams, torch.from_numpy(tok), c)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _assert_caches_equal(c, jc, f"serve step {t}")
    # under a policy (one rank here: tests/test_torch_multirank4.py runs
    # four) the step places the token batch and runs the same decode
    import torch_multirank
    from repro_torch.distributed.sharding import ShardingPolicy, gather_full
    from repro_torch.distributed.specs import param_specs, place_tree
    from repro_torch.launch.mesh import make_host_mesh
    with torch_multirank.one_rank_group(tmp_path):
        pol = ShardingPolicy(make_host_mesh((1, 1), ("data", "model"),
                                            device="cpu"))
        _, c0 = make_prefill_step(cfg, capacity=S + 2)(
            tparams, torch.from_numpy(inp[:, :S]))
        tok = torch.from_numpy(inp[:, S:S + 1])
        want, _ = make_serve_step(cfg)(tparams, tok, c0)
        _, c1 = make_prefill_step(cfg, policy=pol, capacity=S + 2)(
            place_tree(tparams, param_specs(tparams, pol), pol.mesh),
            torch.from_numpy(inp[:, :S]))
        got, _ = make_serve_step(cfg, policy=pol)(
            place_tree(tparams, param_specs(tparams, pol), pol.mesh), tok, c1)
        np.testing.assert_allclose(gather_full(got).numpy(), want.numpy(),
                                   **TOL)


def test_paged_decode_matches_contiguous_decode():
    """``decode_step_paged`` through a fragmented page table produces the
    logits of the contiguous ``decode_step`` on the same prefill (the port's
    counterpart of tests/test_serve.py's check, its limit 2e-4)."""
    _, cfg, _, tparams = _models("yi-6b")
    _, rt = _runtimes()
    plen, steps, ps, cap = 12, 5, 8, 32
    prompt = torch.arange(plen, dtype=torch.int32)[None, :] % cfg.vocab_size
    logits, caches = prefill(tparams, cfg, rt, prompt, capacity=cap + steps)
    alloc = PagePool(num_pages=6, page_size=ps).allocate(4)
    alloc.pages.reverse()                 # force a non-contiguous map
    pools = paged_pools_init(cfg, 6 * ps + 4, torch.float32, device="cpu")
    slots = torch.tensor([alloc.physical_slot(i) for i in range(plen)])
    for stack_pools, stack_cache in zip(pools, caches):
        for key, pool in stack_pools.items():
            for f in ("k", "v"):
                pool[f][:, :, slots, :] = stack_cache[key][f][:, 0, :, :plen]
    phys = torch.from_numpy(alloc.physical_index(cap)[None, :])
    tok, pos = int(logits[0, -1].argmax()), plen
    for _ in range(steps):
        t = torch.full((1, 1), tok, dtype=torch.int32)
        logits_c, caches = decode_step(tparams, cfg, rt, t, caches)
        logits_p, updates = decode_step_paged(
            tparams, cfg, rt, t, pools, phys,
            torch.full((1, 1), pos, dtype=torch.int32))
        np.testing.assert_allclose(logits_c[0, -1].numpy(),
                                   logits_p[0, 0].numpy(), rtol=2e-4,
                                   atol=2e-4)
        pools = paged_kv_write(pools, updates, torch.full(
            (1, 1), alloc.physical_slot(pos), dtype=torch.int32))
        tok, pos = int(logits_p[0, 0].argmax()), pos + 1


# --------------------------------------------------- layer level vs JAX

@pytest.mark.parametrize("s", [20, 32, 33, 70])
def test_local_prefill_ring_equals_jax(s):
    """LOCAL ``attn_prefill``: attention within the window and the ring
    cache (rolled when s >= window, so that slot (s - w + i) % w holds key
    s - w + i; zero-padded below it) against JAX's."""
    jcfg, cfg, _, _ = _models("recurrentgemma-9b")
    jp = jattn.attn_init(jax.random.PRNGKey(1), jcfg)
    tp = tree.tree_map(torch.from_numpy, jax.tree.map(np.array, jp))
    x = np.random.default_rng(s).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    y, c = tattn.attn_prefill(tp, torch.from_numpy(x), cfg,
                              kind=AttentionKind.LOCAL, chunk_q=16)
    jy, jc = jattn.attn_prefill(jp, jnp.asarray(x), jcfg,
                                kind=jcfg.block_pattern[-1], plan=None,
                                layer_idx=0, step=0, chunk_q=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _assert_caches_equal([{"l0": c}], [{"l0": jc}], f"s={s}")
    w = cfg.local_window
    assert c["k"].shape[2] == w
    if s < w:
        assert not c["k"][:, :, s:].any()


@pytest.mark.parametrize("t", [2, 20])
def test_rglru_prefill_and_decode_equal_jax(t):
    """``rglru_prefill`` (the conv tail zero-padded when T < 3) and two
    ``rglru_decode`` steps against JAX's: outputs and states."""
    jcfg, cfg, _, _ = _models("recurrentgemma-9b")
    jp = jrglru.rglru_init(jax.random.PRNGKey(2), jcfg)
    tp = tree.tree_map(torch.from_numpy, jax.tree.map(np.array, jp))
    x = np.random.default_rng(t).standard_normal(
        (B, t + 2, cfg.d_model)).astype(np.float32)
    y, c = trglru.rglru_prefill(tp, torch.from_numpy(x[:, :t]), cfg)
    jy, jc = jrglru.rglru_prefill(jp, jnp.asarray(x[:, :t]), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _assert_caches_equal([{"l0": c}], [{"l0": jc}], "prefill")
    for i in range(t, t + 2):
        y, c = trglru.rglru_decode(tp, torch.from_numpy(x[:, i:i + 1]), c,
                                   cfg)
        jy, jc = jrglru.rglru_decode(jp, jnp.asarray(x[:, i:i + 1]), jc,
                                     jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        _assert_caches_equal([{"l0": c}], [{"l0": jc}], f"decode {i}")


def test_quantize_kv_bitwise():
    """``quantize_kv`` against JAX's bitwise, ties included: a row whose
    largest magnitude is 127 has scale 1 in f32, so x.5 values round half
    to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] + [0.0]
                    * 8, np.float32)
    x[0, 0, 0] = ties
    q, scale = tattn.quantize_kv(torch.from_numpy(x))
    jq, jscale = jattn.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert q[0, 0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("local_window", [0, 5])
def test_attention_decode_equals_jax(local_window, tmp_path):
    """``core.attention_decode`` (GQA 2:1, 11 of 16 slots valid) against
    JAX's; ``attention_decode_appended`` under a sharding policy (one rank
    here; the sequence-sharded branch on four: test_torch_multirank4.py)
    gives the unsharded result."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
            for _ in range(2))
    got = attention_decode(*(torch.from_numpy(a) for a in (q, k, v)), 11,
                           local_window=local_window)
    want = j_attention_decode(*(jnp.asarray(a) for a in (q, k, v)), 11,
                              local_window=local_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    import torch_multirank
    from repro_torch.distributed.sharding import ShardingPolicy, gather_full
    from repro_torch.launch.mesh import make_host_mesh
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    args = (tq, tk, tv, tk[:, :, :1], tv[:, :, :1], 11, 16, False)
    want = tattn.attention_decode_appended(*args)
    with torch_multirank.one_rank_group(tmp_path):
        pol = ShardingPolicy(make_host_mesh((1,), ("model",), device="cpu"))
        got = tattn.attention_decode_appended(*args, policy=pol)
    np.testing.assert_array_equal(gather_full(got).numpy(), want.numpy())
