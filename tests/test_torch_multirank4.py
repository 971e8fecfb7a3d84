"""The port's sharded paths on four gloo ranks on the CPU, held against
the JAX package's single-device functions on the same seeded inputs (one
spawn, ``tests/torch_multirank.py``; the JAX references computed here):

* producers on (data=2, model=2): every rank's standalone, fused dense
  and grouped (E=1) planes bitwise its ``shard_plane_windows`` tile;
* the reduced moonshot's MoE layer through the three dispatch bodies
  (``_dispatch_combine``: experts on data, hidden dim on model;
  ``_dispatch_combine_dedup``; ``_dispatch_combine_ep_model``) on (data=2,
  model=2): ``y`` within 2e-4 of JAX's ``moe_apply(..., None)``, aux within
  0.1, the y-path gradients within 2e-4, the plane hosted in the dispatch
  body bitwise its tile of ``philox_mask_ref``'s plane;
* sequence-sharded decode of the reduced yi on (model=4), whose 2
  kv-heads do not divide the axis (the flash-decoding branch): prefill and
  three decode steps' logits within 2e-5 of JAX's single-device decode,
  and ``core.attention_decode`` on a cache whose sequence dim is sharded
  within 1e-5 of JAX's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_multirank*.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_multirank
from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core.attention import attention_decode as j_attention_decode
from repro.core.overlap import plan_from_config
from repro.kernels.philox_common import shard_plane_windows
from repro.kernels.ref import philox_mask_ref
from repro.models import decode_step as j_decode_step
from repro.models import prefill as j_prefill
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_init as j_moe_init
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import model_init as j_model_init
from test_torch_multirank import check_producers, producer_payload

MOE_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 128
BODIES = ["ep", "dedup", "ep_model"]
PROMPT, CAPACITY, NEW = 24, 32, 3


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    cfg = j_get_arch("moonshot-v1-16b-a3b", reduced=True)
    params = j_moe_init(jax.random.PRNGKey(4), cfg)
    x = jax.random.normal(jax.random.PRNGKey(5), (B, S, cfg.d_model))
    g = jax.random.normal(jax.random.PRNGKey(6), (B, S, cfg.d_model))
    y, aux = j_moe_apply(params, x, cfg, None)
    gx, gw = jax.grad(lambda xx, pp: jnp.sum(
        j_moe_apply(pp, xx, cfg, None)[0] * g), argnums=(0, 1))(x, params)
    moe = dict(params=jax.tree.map(np.asarray, params), x=np.asarray(x),
               g=np.asarray(g))
    moe_want = dict(y=np.asarray(y), aux=float(aux), gx=np.asarray(gx),
                    gw={k: np.asarray(v) for k, v in gw.items()})
    # decode: yi, JAX's prefill then three greedy tokens on one device
    ycfg = j_get_arch("yi-6b", reduced=True)
    yparams = j_model_init(jax.random.PRNGKey(7), ycfg)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(8),
                                           (B, PROMPT), 0, 256), np.int32)
    rt = JRuntime(plan=None, step=0)
    logits, caches = j_prefill(yparams, ycfg, rt, jnp.asarray(prompt),
                               capacity=CAPACITY)
    want, fed = [np.asarray(logits)], []
    for _ in range(NEW):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)
        fed.append(tok)
        logits, caches = j_decode_step(yparams, ycfg, rt, jnp.asarray(tok),
                                       caches)
        want.append(np.asarray(logits))
    rng = np.random.default_rng(5)
    attn = dict(q=rng.standard_normal((2, 4, 1, 16)).astype(np.float32),
                k=rng.standard_normal((2, 2, 16, 16)).astype(np.float32),
                v=rng.standard_normal((2, 2, 16, 16)).astype(np.float32),
                len=11, window=6)
    attn_want = np.asarray(j_attention_decode(
        *(jnp.asarray(attn[n]) for n in ("q", "k", "v")), 11,
        local_window=6))
    pl = dict(producers=producer_payload(), moe=moe, attn_decode=attn,
              decode=dict(params=jax.tree.map(np.asarray, yparams),
                          prompt=prompt, fed=fed, capacity=CAPACITY))
    res = torch_multirank.run("four_ranks", 4, pl,
                              tmp_path_factory.mktemp("four_ranks"))
    return res, pl, moe_want, want, attn_want


def test_producers_bitwise_tiles_on_data_x_model(four_ranks):
    res, pl, _, _, _ = four_ranks
    seen = check_producers(res, pl["producers"])
    b, h = pl["producers"]["mask_shape"][:2]
    assert seen == set(shard_plane_windows(b, h, 2, 2))


@pytest.mark.parametrize("body", BODIES)
def test_moe_dispatch_body_equals_jax(four_ranks, body):
    res, _, want, _, _ = four_ranks
    for r in res:
        got = r["moe"][body]
        np.testing.assert_allclose(got["y"], want["y"], **MOE_TOL)
        assert abs(got["aux"] - want["aux"]) < 0.1
        np.testing.assert_allclose(got["gx"], want["gx"], **MOE_TOL)
        # the router's and every expert weight's gradient
        assert sorted(got["gw"]) == sorted(want["gw"])
        for k, gw in got["gw"].items():
            np.testing.assert_allclose(gw, want["gw"][k], **MOE_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("body", BODIES)
def test_moe_hosted_plane_bitwise_tiles(four_ranks, body):
    res, _, _, _, _ = four_ranks
    cfg = j_get_arch("moonshot-v1-16b-a3b", reduced=True)
    plan = plan_from_config(JPlanConfig(mode="overlap", site="ffn_up",
                                        p=0.1, seed=3))
    seen = set()
    for r in res:
        got = r["moe"][body]
        plane = np.asarray(philox_mask_ref(
            B, cfg.n_heads, S, S, 0.1, int(plan.step_seed(0)),
            int(plan.salt(got["layer"]))))
        off, b_loc, h_loc = got["window"]
        b0, h0 = off // cfg.n_heads, off % cfg.n_heads
        np.testing.assert_array_equal(
            got["plane"].view(np.uint32),
            plane[b0:b0 + b_loc, h0:h0 + h_loc].view(np.uint32))
        seen.add(got["window"])
    assert seen == set(shard_plane_windows(B, cfg.n_heads, 2, 2))


def test_sequence_sharded_decode_equals_jax(four_ranks):
    res, _, _, want, _ = four_ranks
    for r in res:
        # the cache's sequence dim is split over model (flash-decoding)
        assert r["cache_placements"] == "[Shard(dim=3)]"
        assert len(r["decode"]) == len(want)
        for got, w in zip(r["decode"], want):
            np.testing.assert_allclose(got, w, **TOL)


def test_core_attention_decode_on_a_sequence_sharded_cache(four_ranks):
    """``core.attention_decode`` with its caches' sequence dim split over
    model=4 (DTensor's reductions over the shards) equals JAX's."""
    res, _, _, _, want = four_ranks
    for r in res:
        np.testing.assert_allclose(r["attn_decode"], want, rtol=1e-5,
                                   atol=1e-5)
