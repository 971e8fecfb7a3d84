"""The port's MoE block, RWKV layers and the grouped-hosted model paths
against the JAX package, mirroring ``tests/test_grouped_host.py`` at the
model level: ``moe_apply`` against JAX's single-device dispatch body
(``_dispatch_combine``: output, aux loss and gradients within 1e-4, the
hosted plane bitwise), the plane invariant to routing and capacity, the
RWKV time-mix, channel-mix FFN and token shift, the cross-site bit identity
on the (dense, moe, moe) stack and the RWKV hybrid, fp8 giving the same
masks, gradients through the grouped host in the train step, and 3-step
``make_train_step`` trajectories of the reduced moonshot-v1-16b-a3b and
arctic-480b equal to JAX's (loss, ce, grad norm and weights within 1e-4,
every plane the attention consumed bitwise; fp8 at the looser tolerances
stated below). Inputs and weights are made with numpy / the JAX package
from a seed and handed to both; JAX's Pallas kernels run in interpret mode
on the CPU, the port's wrappers take their plain versions there.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.config.base import AttentionKind as JAttentionKind
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.config.base import FFNKind as JFFNKind
from repro.config.base import ModelConfig as JModelConfig
from repro.config.base import MoEConfig as JMoEConfig
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import ShapeConfig as JShapeConfig
from repro.config.base import ShardingConfig as JShardingConfig
from repro.config.base import StepKind as JStepKind
from repro.config.base import TrainConfig as JTrainConfig
from repro.core import producer as jproducer
from repro.core.overlap import plan_from_config
from repro.data.pipeline import batch_for_step as j_batch
from repro.kernels.ref import philox_mask_ref
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_init as j_model_init
from repro.train.loop import cross_entropy as j_cross_entropy
from repro.train.loop import init_train_state as j_init_state
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import tree
from repro_torch.config import get_arch
from repro_torch.config.base import (
    AttentionKind,
    DropoutPlanConfig,
    FFNKind,
    ModelConfig,
    MoEConfig,
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
from repro_torch.core.schedule import compile_schedule
from repro_torch.data import batch_for_step
from repro_torch.models import Runtime, attention, forward, model_init
from repro_torch.models import moe, rwkv
from repro_torch.models.layers import ffn_apply, token_shift
from repro_torch.optim import adamw_init
from repro_torch.train import make_grad_fn, make_train_step

P, SEED = 0.25, 5
TOL = dict(atol=1e-4, rtol=1e-4)
APPROX = dict(abs=1e-4, rel=1e-4)
# fp8 at model level. With equal inputs the grouped e4m3 host equals JAX's
# within 3e-5 (test_torch_grouped.py). In a model, an activation that
# differs from JAX's in its last f32 bit now and then rounds to the
# neighbouring e4m3 value (up to 1/8 of it away) at a quantized expert
# GEMM, and the next layer's router sees it: measured at step 0 of the
# reduced moonshot, from equal weights, 1.16e-2 on the logits of one token
# at ffn_down and 5.5e-3 at ffn_up (all other logits within 5e-3; loss
# within 1e-5). Over a trajectory Adam moves a weight by up to lr a step
# whatever its gradient (as reasoned in tests/test_torch_sites.py).
FP8_LOGITS_TOL = dict(atol=2.5e-2, rtol=2.5e-2)
FP8_APPROX = dict(abs=1e-3, rel=1e-3)
# ... and a weight that differs by about lr moves the router's choices and
# the gradients it routes: after two fp8 updates of the reduced moonshot
# the grad norm was 1.3e-3 (ffn_down) and 3.4e-3 (ffn_up) relative from
# JAX's, with loss, ce and aux within 1.3e-4 and every weight within
# 2.6e-3 (< 3 lr)
FP8_GRAD_NORM_APPROX = dict(abs=1e-2, rel=1e-2)
# One fp8 MoE layer from equal inputs: y equals JAX's within 2.4e-7 at both
# sites, so it is held at TOL. Its gradients are the bf16 dgrad pair's: an
# operand that differs from JAX's in its last f32 bit can round to the
# neighbouring bf16 value (2^-8 of it away). Measured largest differences:
# 2.7e-4 on w_gate's gradient at ffn_up (|g| up to 31), 7.6e-5 at
# ffn_down; held at twice the larger.
FP8_LAYER_GRAD_TOL = dict(atol=5e-4, rtol=1e-4)
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
BATCH, SEQ = 2, 128


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _plan_kw(site, **kw):
    return dict(mode="overlap", p=P, seed=SEED, site=site, **kw)


def _plans(site, **kw):
    return (DropoutPlan(DropoutPlanConfig(**_plan_kw(site, **kw))),
            plan_from_config(JPlanConfig(**_plan_kw(site, **kw))))


def _moe_cfgs(**kw):
    """(dense, moe, moe) stack: test_grouped_host.py's config in both
    packages."""
    m = kw.pop("moe", dict(n_experts=4, top_k=2, d_ff_expert=128,
                           first_dense_layers=1, capacity_factor=2.0))
    ffn = kw.pop("ffn", "swiglu")
    base = dict(name="dmm", family="moe", n_layers=3, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=64,
                head_dim=32, attn_dropout=P)
    base.update(kw)
    return (JModelConfig(block_pattern=(JAttentionKind.FULL,),
                         ffn=JFFNKind(ffn), moe=JMoEConfig(**m), **base),
            ModelConfig(block_pattern=(AttentionKind.FULL,),
                        ffn=FFNKind(ffn), moe=MoEConfig(**m), **base))


def _hybrid_cfgs():
    """(WKV, FULL) hybrid with RWKV channel-mix FFNs."""
    base = dict(name="rwkv-hyb", family="hybrid", n_layers=4, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=64,
                head_dim=32, rwkv_head_dim=32, attn_dropout=P)
    return (JModelConfig(block_pattern=(JAttentionKind.WKV,
                                        JAttentionKind.FULL),
                         ffn=JFFNKind.RWKV_CHANNEL, **base),
            ModelConfig(block_pattern=(AttentionKind.WKV,
                                       AttentionKind.FULL),
                        ffn=FFNKind.RWKV_CHANNEL, **base))


def _tokens(cfg, batch=2, seq=128):
    return np.array(jax.random.randint(jax.random.PRNGKey(3), (batch, seq),
                                       0, cfg.vocab_size))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- MoE block

@pytest.mark.parametrize("site,dtype", [
    (None, "f32"), ("ffn_up", "f32"), ("ffn_down", "f32"), ("ffn_up", "fp8"),
    ("ffn_down", "fp8")])
def test_moe_apply_equals_jax_dispatch_combine(site, dtype):
    """moe_apply against JAX's single-device body: y and aux within 1e-4,
    the hosted plane bitwise, gradients (of y and aux) within 1e-4 in f32
    and at FP8_LAYER_GRAD_TOL through the fp8 host's straight-through bf16
    dgrad pair."""
    jcfg, cfg = _moe_cfgs(n_layers=2)
    jparams = jmoe.moe_init(jax.random.PRNGKey(2), jcfg)
    params = tree.tree_map(torch.tensor, _np(jparams))
    x = _x(0, 2, 128, cfg.d_model)
    shape = (2, 2, 128, 128)
    host = jhost = None
    if site is not None:
        plan, jplan = _plans(site, gemm_dtype=dtype)
        host = producer.FFNHost(plan=plan, site=site, mask_shape=shape,
                                layer_idx=1, step=7,
                                how=producer.HOW_GEMM_GROUPED)
        jhost = jproducer.FFNHost(plan=jplan, site=site, mask_shape=shape,
                                  layer_idx=1, step=7,
                                  how=jproducer.HOW_GEMM_GROUPED)
    leaves = [t.clone().requires_grad_() for t in tree.leaves(params)]
    tx = torch.from_numpy(x).requires_grad_()
    out = moe.moe_apply(tree.unflatten_like(params, leaves), tx, cfg,
                        host=host)
    jout = jmoe.moe_apply(jparams, jnp.asarray(x), jcfg, None, host=jhost)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jout[0]),
                               **TOL)
    assert float(out[1].detach()) == pytest.approx(float(jout[1]),
                                                  **APPROX)
    if site is not None:
        np.testing.assert_array_equal(_u32(out[2]), np.asarray(jout[2]))
        want = philox_mask_ref(*shape, P, int(jplan.step_seed(7)),
                               int(jplan.salt(1)))
        np.testing.assert_array_equal(_u32(out[2]), np.asarray(want))
    grads = torch.autograd.grad(out[0].square().sum() + out[1],
                                leaves + [tx])

    def jloss(p_, x_):
        o = jmoe.moe_apply(p_, x_, jcfg, None, host=jhost)
        return jnp.sum(jnp.square(o[0])) + o[1]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    gtol = FP8_LAYER_GRAD_TOL if dtype == "fp8" else TOL
    for got, want in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **gtol)


@pytest.mark.parametrize("perturb", ["router", "capacity"])
def test_mask_invariant_to_routing(perturb):
    """The hosted plane is a function of (seed, salt, layer, step) only:
    other routing (a perturbed router) or capacity overflow (cf 0.5, a new
    expert grid) changes which tokens each expert tile holds and not one
    bit."""
    moe_kw = dict(n_experts=4, top_k=2, d_ff_expert=128,
                  first_dense_layers=0, capacity_factor=2.0)
    _, cfg = _moe_cfgs(n_layers=2, moe=moe_kw)
    plan, jplan = _plans("ffn_up")
    b, h, s = 2, 2, 128
    x = torch.from_numpy(_x(1, b, s, cfg.d_model))
    host = producer.FFNHost(plan=plan, site="ffn_up",
                            mask_shape=(b, h, s, s), layer_idx=1, step=7,
                            how=producer.HOW_GEMM_GROUPED)
    params = tree.tree_map(torch.from_numpy, _np(jmoe.moe_init(
        jax.random.PRNGKey(2), _moe_cfgs(n_layers=2, moe=moe_kw)[0])))
    y_ref, _, mask_ref = moe.moe_apply(params, x, cfg, host=host)
    if perturb == "router":
        p2 = dict(params)
        p2["router"] = -params["router"] + 0.3 * torch.from_numpy(
            _x(9, *params["router"].shape))
        y_got, _, mask_got = moe.moe_apply(p2, x, cfg, host=host)
    else:
        _, cfg2 = _moe_cfgs(n_layers=2, moe=dict(moe_kw,
                                                 capacity_factor=0.5))
        y_got, _, mask_got = moe.moe_apply(params, x, cfg2, host=host)
    assert not torch.equal(y_got, y_ref)           # the routing did move
    assert torch.equal(mask_got, mask_ref)
    want = philox_mask_ref(b, h, s, s, P, int(jplan.step_seed(7)),
                           int(jplan.salt(1)))
    np.testing.assert_array_equal(_u32(mask_ref), np.asarray(want))


def test_moe_apply_policy_raises(tmp_path):
    """``moe_apply`` under a policy (it raised before multi-device was
    ported) runs the dispatch body with its collectives: on one rank's
    (data=1, model=1) mesh it is bitwise the single-device body (the three
    bodies against JAX on four ranks: test_torch_multirank4.py)."""
    import torch_multirank
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  gather_full, use_policy)
    from repro_torch.launch.mesh import make_host_mesh
    _, cfg = _moe_cfgs()
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, cfg)
    x = torch.randn((2, 8, 64), generator=gen)
    y_ref, aux_ref = moe.moe_apply(params, x, cfg)
    with torch_multirank.one_rank_group(tmp_path):
        pol = ShardingPolicy(make_host_mesh((1, 1), ("data", "model"),
                                            device="cpu"))
        with use_policy(pol):
            y, aux = moe.moe_apply(params, x, cfg, pol)
        assert torch.equal(gather_full(y), y_ref)
        assert torch.equal(gather_full(aux), aux_ref)


# ------------------------------------------------------------------ RWKV

def test_rwkv_time_mix_equals_jax():
    """rwkv_apply (token shift, LoRA mixing, chunked WKV, group norm) within
    1e-4 of JAX's at a length the chunk does not divide, and one
    ``rwkv_decode`` step (``wkv_step``) from a random state within 1e-4 of
    JAX's: the output and every field of the new state."""
    _, cfg = _hybrid_cfgs()
    jcfg = _hybrid_cfgs()[0]
    jp = jrwkv.rwkv_init(jax.random.PRNGKey(4), jcfg)
    tp = tree.tree_map(torch.from_numpy, _np(jp))
    x = _x(2, 2, 40, cfg.d_model)
    got = rwkv.rwkv_apply(tp, torch.from_numpy(x), cfg)
    want = jrwkv.rwkv_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hd = cfg.rwkv_head_dim
    state = {"s": _x(5, 2, cfg.n_heads, hd, hd),
             "shift_tm": _x(6, 2, cfg.d_model),
             "shift_cm": _x(7, 2, cfg.d_model),
             "len": np.asarray(40, np.int32)}
    x1 = _x(8, 2, 1, cfg.d_model)
    got, gstate = rwkv.rwkv_decode(
        tp, torch.from_numpy(x1),
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg)
    want, wstate = jrwkv.rwkv_decode(
        jp, jnp.asarray(x1), {k: jnp.asarray(v) for k, v in state.items()},
        jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(gstate) == sorted(wstate)
    for k in gstate:
        np.testing.assert_allclose(gstate[k].numpy(), np.asarray(wstate[k]),
                                   err_msg=k, **TOL)


def test_channel_mix_ffn_and_token_shift_equal_jax():
    jcfg, cfg = _hybrid_cfgs()
    jf = jlayers.ffn_init(jax.random.PRNGKey(5), jcfg)
    x = _x(3, 2, 128, cfg.d_model)
    last = _x(4, 2, cfg.d_model)
    for lst in (None, last):
        for xs in (x, x[:, :1]):
            got = token_shift(torch.from_numpy(xs), None if lst is None
                              else torch.from_numpy(lst))
            want = jlayers.token_shift(jnp.asarray(xs), None if lst is None
                                       else jnp.asarray(lst))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shifted = token_shift(torch.from_numpy(x))
    fp = tree.tree_map(torch.from_numpy, _np(jf))
    got = ffn_apply(fp, torch.from_numpy(x), cfg, shifted=shifted)
    want = jlayers.ffn_apply(jf, jnp.asarray(x), jcfg,
                             shifted=jlayers.token_shift(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
@pytest.mark.parametrize("dtype", ["f32", "fp8"])
def test_channel_mix_grouped_host_equals_jax(site, dtype):
    """The channel-mix FFN hosting through the grouped kernel (E=1): y
    within 1e-4 of JAX's hosted FFN (fp8 too: the e4m3 host at the key /
    value GEMM, measured within 1.2e-7 of JAX's), the plane bitwise."""
    jcfg, cfg = _hybrid_cfgs()
    plan, jplan = _plans(site, gemm_dtype=dtype)
    jf = jlayers.ffn_init(jax.random.PRNGKey(6), jcfg)
    x = _x(5, 2, 128, cfg.d_model)
    shape = (2, 2, 128, 128)
    y, plane = ffn_apply(
        tree.tree_map(torch.from_numpy, _np(jf)), torch.from_numpy(x), cfg,
        shifted=token_shift(torch.from_numpy(x)),
        host=producer.FFNHost(plan=plan, site=site, mask_shape=shape,
                              layer_idx=1, step=2,
                              how=producer.HOW_GEMM_GROUPED))
    jy, jplane = jlayers.ffn_apply(
        jf, jnp.asarray(x), jcfg,
        shifted=jlayers.token_shift(jnp.asarray(x)),
        host=jproducer.FFNHost(plan=jplan, site=site, mask_shape=shape,
                               layer_idx=1, step=2,
                               how=jproducer.HOW_GEMM_GROUPED))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(_u32(plane), np.asarray(jplane))


@pytest.mark.parametrize("block", ["moe", "channel_mix"])
def test_grouped_hosts_run_the_plan_or_raise(block):
    """A block whose host is planned ``gemm_rng_grouped`` runs the grouped
    kernel or raises: on a capacity (MoE) or token count (channel-mix)
    that does not tile, and on a grid too small to hide the mask (Region
    3), where JAX's host degrades to the tensor-op product or the
    standalone producer on its own."""
    plan, _ = _plans("ffn_up")
    if block == "moe":
        moe_kw = dict(n_experts=4, top_k=2, d_ff_expert=128,
                      first_dense_layers=0, capacity_factor=2.0)
        jcfg, cfg = _moe_cfgs(n_layers=2, moe=moe_kw)
        # capacity_factor 1.02: C = ceil(256 * 2 * 1.02 / 4) = 131, prime
        _, cfg_odd = _moe_cfgs(n_layers=2, moe=dict(moe_kw,
                                                    capacity_factor=1.02))
        params = tree.tree_map(torch.from_numpy, _np(jmoe.moe_init(
            jax.random.PRNGKey(2), jcfg)))
        x = torch.from_numpy(_x(1, 2, 128, cfg.d_model))

        def run(shape, odd=False):
            return moe.moe_apply(params, x, cfg_odd if odd else cfg,
                                 host=_host(plan, shape))
    else:
        jcfg, cfg = _hybrid_cfgs()
        params = tree.tree_map(torch.from_numpy, _np(jlayers.ffn_init(
            jax.random.PRNGKey(6), jcfg)))

        def run(shape, odd=False):
            # 2 x 131 tokens: the (262, 64) x (64, 128) key GEMM
            xs = torch.from_numpy(_x(5, 2, 131 if odd else 128,
                                     cfg.d_model))
            return ffn_apply(params, xs, cfg, shifted=token_shift(xs),
                             host=_host(plan, shape))

    small, large = (2, 2, 128, 128), (1, 64, 2048, 2048)
    assert run(small)[-1].shape == (2, 2, 4, 128)
    with pytest.raises(ValueError, match="does not tile"):
        run(small, odd=True)
    with pytest.raises(RuntimeError, match="Region 3"):
        run(large)


def _host(plan, shape):
    return producer.FFNHost(plan=plan, site="ffn_up", mask_shape=shape,
                            layer_idx=1, step=2,
                            how=producer.HOW_GEMM_GROUPED)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b",
                                  "hybrid", "dmm"])
def test_model_init_matches_jax_tree(arch):
    """model_init gives the JAX tree (keys, shapes) with its scales, and
    params_from_jax carries the MoE and RWKV trees over."""
    if arch == "hybrid":
        jcfg, cfg = _hybrid_cfgs()
    elif arch == "dmm":
        jcfg, cfg = _moe_cfgs()
    else:
        jcfg, cfg = j_get_arch(arch, reduced=True), get_arch(arch,
                                                              reduced=True)
    jp = _np(j_model_init(jax.random.PRNGKey(0), jcfg))
    p = model_init(cfg, seed=0, device="cpu")
    got = tree.leaves_with_paths(p)
    want = jax.tree_util.tree_leaves_with_path(jp)
    assert [path for path, _ in got] == [jax.tree_util.keystr(path)
                                         for path, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert tuple(t.shape) == w.shape, path
        assert float(t.std()) == pytest.approx(float(w.std()), rel=0.25,
                                               abs=1e-3), path
    conv = params_from_jax(jp, cfg, device="cpu")
    for (path, t), (_, w) in zip(tree.leaves_with_paths(conv), want):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=path)


def _logits(params, cfg, site, impl, tokens, step=4, **kw):
    rt = Runtime(plan=DropoutPlan(DropoutPlanConfig(**_plan_kw(site, **kw))),
                 step=step, attn_impl=impl)
    return forward(params, cfg, rt, torch.from_numpy(tokens))


def _jlogits(jparams, jcfg, site, impl, tokens, step=4, **kw):
    rt = JRuntime(plan=plan_from_config(JPlanConfig(**_plan_kw(site, **kw))),
                  step=step, attn_impl=impl)
    return j_forward(jparams, jcfg, rt, jnp.asarray(tokens))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
def test_moe_stack_sites_bit_identical(site, impl):
    """On the (dense, moe, moe) stack the grouped-hosted sites give the
    per-layer xla site's logits exactly (the same bits), and those equal
    JAX's within 1e-4 (aux too)."""
    jcfg, cfg = _moe_cfgs()
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    tokens = _tokens(cfg)
    got, aux = _logits(params, cfg, site, impl, tokens)
    ref, _ = _logits(params, cfg, "xla", impl, tokens)
    assert torch.equal(got, ref)
    want, jaux = _jlogits(jparams, jcfg, site, impl, tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == pytest.approx(float(jaux), **APPROX)


@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
def test_rwkv_hybrid_sites_bit_identical(site):
    """The RWKV hybrid's channel-mix-hosted pipeline (E=1 grouped host, the
    carry riding through the WKV blocks) gives the xla site's logits
    exactly, and JAX's within 1e-4."""
    jcfg, cfg = _hybrid_cfgs()
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    tokens = _tokens(cfg)
    got, _ = _logits(params, cfg, site, "pallas", tokens)
    assert torch.equal(got, _logits(params, cfg, "xla", "pallas",
                                    tokens)[0])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(_jlogits(jparams, jcfg, site, "pallas",
                                         tokens)[0]), **TOL)


def test_first_dense_channel_mix_forward_bit_identical():
    """A MoE stack whose first-dense layer has an RWKV channel-mix FFN
    (hosted on its own E=1 grid) matches the xla site bitwise."""
    jcfg, cfg = _moe_cfgs(ffn="rwkv_channel")
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    tokens = _tokens(cfg)
    got, _ = _logits(params, cfg, "ffn_up", "pallas", tokens)
    assert torch.equal(got, _logits(params, cfg, "xla", "pallas",
                                    tokens)[0])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(_jlogits(jparams, jcfg, "ffn_up", "pallas",
                                         tokens)[0]), **TOL)


def _planes_seen(monkeypatch, params, cfg, plan, tokens, step):
    """Every plane the flash path consumed in one forward (premask)."""
    seen = []
    real = attention._attn_pallas_sharded

    def record(q, k, v, packed, *args, **kw):
        seen.append(packed)
        return real(q, k, v, packed, *args, **kw)

    monkeypatch.setattr(attention, "_attn_pallas_sharded", record)
    logits, _ = forward(params, cfg, Runtime(plan=plan, step=step,
                                             attn_impl="pallas"),
                        torch.from_numpy(tokens))
    monkeypatch.undo()
    return logits, seen


@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
def test_moe_stack_fp8_same_masks(site, monkeypatch):
    """gemm_dtype="fp8" moves the expert GEMMs' precision, never the bits:
    every plane the attention reads equals the oracle; the logits are
    finite and JAX's fp8 logits within FP8_LOGITS_TOL."""
    jcfg, cfg = _moe_cfgs()
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    tokens = _tokens(cfg, batch=1)
    plan, jplan = _plans(site, gemm_dtype="fp8", attn_replay="off")
    logits, seen = _planes_seen(monkeypatch, params, cfg, plan, tokens, 4)
    assert bool(torch.isfinite(logits).all())
    assert len(seen) == cfg.n_layers
    for layer, plane in enumerate(seen):
        want = philox_mask_ref(1, cfg.n_heads, SEQ, SEQ, P,
                               int(jplan.step_seed(4)),
                               salt=int(jplan.salt(layer)))
        np.testing.assert_array_equal(_u32(plane), np.asarray(want))
    want, _ = _jlogits(jparams, jcfg, site, "pallas", tokens,
                       gemm_dtype="fp8", attn_replay="off")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               **FP8_LOGITS_TOL)


def test_moe_train_step_grads_through_grouped_host():
    """Gradients flow through the grouped-hosted expert GEMMs in the train
    step: the loss equals the xla site's on tensor ops, the gradients JAX's
    within 1e-4, and the weights stay finite."""
    jcfg, cfg = _moe_cfgs()
    shape = ("t", SEQ, 1)

    def run(site, impl):
        return RunConfig(
            model=cfg, shape=ShapeConfig(*shape, StepKind.TRAIN),
            dropout=DropoutPlanConfig(**_plan_kw(site)),
            sharding=ShardingConfig(remat="block", attn_impl=impl),
            train=TrainConfig(optimizer=OptimizerConfig()))

    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    master = params_from_jax(_np(jparams), cfg, device="cpu")
    x = torch.from_numpy(_tokens(cfg, batch=1))
    y = torch.from_numpy(np.roll(_tokens(cfg, batch=1), 1, axis=1))
    losses = {}
    for site, impl in (("xla", "xla"), ("ffn_up", "pallas")):
        state = {"master": master, "opt": adamw_init(master), "step": 0}
        new, m = make_train_step(cfg, run(site, impl))(state, x, y)
        losses[site] = float(m["loss"])
        assert all(bool(torch.isfinite(t).all())
                   for t in tree.leaves(new["master"]))
    assert losses["ffn_up"] == pytest.approx(losses["xla"], abs=1e-4)
    loss, _, grads = make_grad_fn(cfg, run("ffn_up", "pallas"))(
        master, x, y, 0)
    jrt = JRuntime(plan=plan_from_config(JPlanConfig(**_plan_kw("ffn_up"))),
                   step=0, attn_impl="pallas")

    def jloss(p_):
        lg, aux = j_forward(p_, jcfg, jrt, jnp.asarray(x.numpy()))
        return j_cross_entropy(lg, jnp.asarray(y.numpy())) + 0.01 * aux

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    assert float(loss) == pytest.approx(float(jl), **APPROX)
    for (path, got), want in zip(tree.leaves_with_paths(grads),
                                 jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **TOL)


# -------------------------------------------------------- trajectories

ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]


def _runs(arch, site, dtype, replay):
    kw = dict(mode="overlap", site=site, gemm_dtype=dtype, p=0.1,
              attn_replay=replay, seed=3)
    shape = ("t", SEQ, BATCH)
    port = RunConfig(
        model=get_arch(arch, reduced=True),
        shape=ShapeConfig(*shape, StepKind.TRAIN),
        sharding=ShardingConfig(attn_impl="pallas", remat="block"),
        dropout=DropoutPlanConfig(**kw),
        train=TrainConfig(optimizer=OptimizerConfig(**OPT)))
    jax_run = JRunConfig(
        model=j_get_arch(arch, reduced=True),
        shape=JShapeConfig(*shape, JStepKind.TRAIN),
        sharding=JShardingConfig(attn_impl="pallas", remat="block"),
        dropout=JPlanConfig(**kw),
        train=JTrainConfig(optimizer=JOptimizerConfig(**OPT)))
    return port, jax_run


TRAJECTORIES = [(arch, site, dtype, "off") for arch in ARCHS
                for site, dtype in (("ffn_up", "f32"), ("ffn_down", "fp8"))
                ] + [("moonshot-v1-16b-a3b", "ffn_down", "f32", "auto"),
                     ("arctic-480b", "ffn_up", "fp8", "auto")]


@pytest.mark.parametrize("arch,site,dtype,replay", TRAJECTORIES)
def test_three_step_trajectory_equals_jax(arch, site, dtype, replay):
    """3 make_train_step steps from JAX's initial state: loss, ce, aux and
    grad norm of every step and the final weights within 1e-4 (fp8 at the
    stated looser tolerances after the first update; step 0 at 1e-4)."""
    run, jrun = _runs(arch, site, dtype, replay)
    jstate = j_init_state(jax.random.PRNGKey(0), jrun.model)
    master = params_from_jax(_np(jstate["master"]), run.model, device="cpu")
    jstep = jax.jit(j_make_train_step(jrun.model, jrun))
    step = make_train_step(run.model, run)
    state = {"master": master, "opt": adamw_init(master), "step": 0}
    for i in range(STEPS):
        jx, jy = j_batch(jrun.model, jrun.shape, i, seed=0)
        x, y = batch_for_step(run.model, run.shape, i, seed=0)
        jstate, jm = jstep(jstate, jnp.asarray(jx), jnp.asarray(jy))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        fp8_later = dtype == "fp8" and i > 0
        for key in ("loss", "ce", "aux", "grad_norm"):
            approx = APPROX if not fp8_later else (
                FP8_GRAD_NORM_APPROX if key == "grad_norm" else FP8_APPROX)
            assert float(m[key]) == pytest.approx(float(jm[key]),
                                                  **approx), (i, key)
    wtol = dict(atol=STEPS * OPT["lr"], rtol=0) if dtype == "fp8" else TOL
    for (path, got), want in zip(tree.leaves_with_paths(state["master"]),
                                 jax.tree.leaves(jstate["master"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **wtol)
    sched = compile_schedule(run.model, run.dropout, BATCH, SEQ,
                             attn_impl="pallas")
    assert sched.carried and sched.replay == (replay == "auto")
    assert producer.HOW_GEMM_GROUPED in {a.emit_how
                                         for a in sched.assignments}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("site,dtype", [("ffn_up", "f32"),
                                        ("ffn_down", "fp8")])
def test_step0_logits_grads_and_planes_equal_jax(arch, site, dtype,
                                                 monkeypatch):
    """Premask consumption: every plane the flash path reads (the bootstrap
    and the carried emissions of the dense and grouped hosts) equals JAX's
    oracle bitwise; step 0's loss and gradients within 1e-4, the logits
    too in f32 (fp8 logits at FP8_LOGITS_TOL)."""
    run, jrun = _runs(arch, site, dtype, "off")
    cfg, jcfg = run.model, jrun.model
    jparams = j_model_init(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu")
    x, y = batch_for_step(cfg, run.shape, 0, seed=0)
    plan = DropoutPlan(run.dropout)
    jplan = plan_from_config(jrun.dropout)
    logits, seen = _planes_seen(monkeypatch, params, cfg, plan, x, 0)
    jrt = JRuntime(plan=jplan, step=0, attn_impl="pallas")
    jlogits, _ = j_forward(jparams, jcfg, jrt, jnp.asarray(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **(FP8_LOGITS_TOL if dtype == "fp8" else TOL))
    assert len(seen) == cfg.n_layers
    for layer, plane in enumerate(seen):
        want = philox_mask_ref(BATCH, cfg.n_heads, SEQ, SEQ, 0.1,
                               int(jplan.step_seed(0)),
                               salt=int(jplan.salt(layer)))
        np.testing.assert_array_equal(_u32(plane), np.asarray(want))
    loss, _, grads = make_grad_fn(cfg, run)(params, torch.from_numpy(x),
                                            torch.from_numpy(y), 0)

    def jloss(p_):
        lg, aux = j_forward(p_, jcfg, jrt, jnp.asarray(x))
        return j_cross_entropy(lg, jnp.asarray(y)) + 0.01 * aux

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    assert float(loss) == pytest.approx(float(jl), **APPROX)
    for (path, got), want in zip(tree.leaves_with_paths(grads),
                                 jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=path, **TOL)


def test_donated_step_equals_functional():
    """make_train_step(donate=True) updates the state in place and gives
    bitwise the functional step's weights, moments and metrics."""
    _, cfg = _moe_cfgs()
    run = RunConfig(
        model=cfg, shape=ShapeConfig("t", SEQ, 1, StepKind.TRAIN),
        dropout=DropoutPlanConfig(**_plan_kw("ffn_up")),
        sharding=ShardingConfig(remat="block", attn_impl="pallas"),
        train=TrainConfig(optimizer=OptimizerConfig(**OPT)))
    master = model_init(cfg, seed=2, device="cpu")
    x = torch.from_numpy(_tokens(cfg, batch=1))
    y = torch.from_numpy(np.roll(_tokens(cfg, batch=1), 1, axis=1))
    runs = {}
    for donate in (False, True):
        state = {"master": tree.tree_map(torch.clone, master),
                 "opt": adamw_init(master), "step": 0}
        held = tree.leaves(state["master"])
        step = make_train_step(cfg, run, donate=donate)
        for _ in range(2):
            state, m = step(state, x, y)
        same = all(a is b for a, b in zip(held, tree.leaves(state["master"])))
        assert same == donate
        runs[donate] = (state, m)
    (fs, fm), (ds, dm) = runs[False], runs[True]
    for a, b in zip(tree.leaves([fs["master"], fs["opt"]]),
                    tree.leaves([ds["master"], ds["opt"]])):
        assert torch.equal(a, b)
    assert all(torch.equal(fm[k], dm[k]) for k in ("loss", "grad_norm"))
