"""The port's sharded paths on two gloo ranks on the CPU (the kernels'
plain versions), held against the JAX package's single-device functions
on the same seeded inputs (``tests/torch_multirank.py`` spawns the ranks;
the JAX references are computed here and reach the ranks as numpy
arrays):

* producers on (data=2) and (model=2): the standalone, fused dense and
  grouped (E=1) hosts' local planes bitwise their ``shard_plane_windows``
  tiles of ``philox_mask_ref``'s plane, the gathered GEMM within 2e-5;
* sharded forwards of the reduced llama2 and yi (GQA) on (model=2), every
  site and replay on / off under ``attn_impl="pallas"``: logits within
  2e-5 of JAX's unsharded ``forward``;
* ``compressed_allreduce`` against JAX's formulas (the int8 payload
  bitwise, floats within 1e-6), ``ppermute`` on a ring against
  ``jax.lax.ppermute`` and on a partial permutation against its stated
  semantics (values and gradients), and ``pipeline_apply`` over 2 stages
  against the stages applied in turn;
* two train steps of the reduced llama2 under (data=2) and (model=2):
  losses and the master within 2e-5 of JAX's;
* ``device_batch`` / ``Prefetcher`` under (data=2): each rank its rows;
* the multi-rank runs' dropout operand check, in-process: each flash
  call's operand held to the one its place names;
* the elastic re-mesh: 1 rank -> 2 ranks -> 1 rank with checkpoints and
  the contract gates ("recompiled" at both changes), losses and the final
  master within 2e-5 of the uninterrupted single-rank run.

    PYTHONPATH=src python -m pytest -q tests/test_torch_multirank*.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multirank
from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import ShapeConfig as JShapeConfig
from repro.config.base import ShardingConfig as JShardingConfig
from repro.config.base import StepKind as JStepKind
from repro.config.base import TrainConfig as JTrainConfig
from repro.core.overlap import plan_from_config
from repro.data.pipeline import batch_for_step as j_batch
from repro.kernels.philox_common import shard_plane_windows
from repro.kernels.ref import philox_mask_ref
from repro.models.transformer import Runtime as JRuntime
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_init as j_model_init
from repro.optim import compression as jcomp
from repro.train.loop import init_train_state as j_init_state
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.config import get_arch
from repro_torch.data import batch_for_step
from repro_torch.distributed.chaos import remesh_segment
from repro_torch.tree import leaves

TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 128
ARCHS = ["llama2-7b", "yi-6b"]
SITES = ["qkv", "prev_gemm", "ffn_up", "ffn_down"]
STEPS = 2
N1, N2, N3 = 2, 4, 5          # the elastic run's topology changes


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def producer_payload():
    rng = np.random.default_rng(0)
    return dict(p=0.25, seed=5, layer=1, step=7, mask_shape=(B, 2, S, S),
                x=rng.standard_normal((B * S, 64)).astype(np.float32),
                w=rng.standard_normal((64, 192)).astype(np.float32))


def producer_want(pl):
    plan = plan_from_config(JPlanConfig(mode="overlap", site="qkv",
                                        p=pl["p"], seed=pl["seed"]))
    b, h, s = pl["mask_shape"][:3]
    plane = np.asarray(philox_mask_ref(
        b, h, s, s, pl["p"], int(plan.step_seed(pl["step"])),
        int(plan.salt(pl["layer"]))))
    return plane, pl["x"] @ pl["w"]


def check_producers(results, pl, key=None):
    """Every rank's planes are its window's tile of the plane; the tiles
    of the ranks cover the windows of the mesh; the GEMMs agree."""
    plane, y = producer_want(pl)
    b, h = pl["mask_shape"][:2]
    seen = set()
    for r in results:
        got = r["producers"][key] if key else r["producers"]
        off, b_loc, h_loc = got["window"]
        b0, h0 = off // h, off % h
        tile = plane[b0:b0 + b_loc, h0:h0 + h_loc]
        for name in ("standalone", "fused", "grouped"):
            np.testing.assert_array_equal(got[name].view(np.uint32),
                                          tile.view(np.uint32), err_msg=name)
        np.testing.assert_allclose(got["fused_y"], y, **TOL)
        np.testing.assert_allclose(got["grouped_y"], y, **TOL)
        seen.add(got["window"])
    return seen


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks for the producer, model, compression and
    pipeline checks, with the JAX references beside its payload."""
    models, want = {}, {}
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (B, S),
                                           0, 256), np.int32)
    for arch in ARCHS:
        jcfg = j_get_arch(arch, reduced=True)
        jparams = j_model_init(jax.random.PRNGKey(1), jcfg)
        models[arch] = _np_tree(jparams)
        plan = plan_from_config(JPlanConfig(mode="overlap", site="qkv",
                                            p=0.1, seed=3,
                                            attn_replay="off"))
        logits, _ = j_forward(jparams, jcfg,
                              JRuntime(plan=plan, step=0,
                                       attn_impl="pallas"),
                              jnp.asarray(tokens))
        want[arch] = np.asarray(logits)
    rng = np.random.default_rng(1)
    compress = dict(grads=rng.standard_normal((2, 33, 7)).astype(np.float32),
                    residuals=(0.01 * rng.standard_normal((2, 33, 7))
                               ).astype(np.float32))
    pipe = dict(w=(0.3 * rng.standard_normal((2, 16, 16))).astype(np.float32),
                b=(0.1 * rng.standard_normal((2, 16))).astype(np.float32),
                x=rng.standard_normal((3, 4, 16)).astype(np.float32))
    permute = dict(x=rng.standard_normal((2, 3)).astype(np.float32),
                   w=rng.standard_normal((2, 3)).astype(np.float32))
    pl = dict(producers=producer_payload(), models=models, tokens=tokens,
              compress=compress, pipe=pipe, permute=permute)
    res = torch_multirank.run("two_ranks", 2, pl,
                              tmp_path_factory.mktemp("two_ranks"))
    return res, pl, want


@pytest.mark.parametrize("axis", ["data", "model"])
def test_producers_bitwise_tiles_of_the_plane(two_ranks, axis):
    res, pl, _ = two_ranks
    seen = check_producers(res, pl["producers"], axis)
    b, h = pl["producers"]["mask_shape"][:2]
    nb, nh = (2, 1) if axis == "data" else (1, 2)
    assert seen == set(shard_plane_windows(b, h, nb, nh))
    if axis == "model":
        # each rank computed its own column slice of the GEMM
        assert "Shard(dim=1)" in res[0]["producers"][axis]["fused_y_spec"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("replay", ["auto", "off"])
def test_sharded_logits_equal_jax(two_ranks, arch, site, replay):
    res, _, want = two_ranks
    for r in res:
        np.testing.assert_allclose(r["logits"][(arch, site, replay)],
                                   want[arch], **TOL)


def test_compressed_allreduce_equals_jax_formulas(two_ranks):
    res, pl, _ = two_ranks
    g, r = pl["compress"]["grads"], pl["compress"]["residuals"]
    qs, scales, new_r = [], [], []
    for i in range(2):
        q, s, nr = jcomp.compress_with_feedback(jnp.asarray(g[i]),
                                                jnp.asarray(r[i]))
        qs.append(np.asarray(q).astype(np.int32))
        scales.append(np.float32(s))
        new_r.append(np.asarray(nr))
    summed = qs[0] + qs[1]
    out = summed.astype(np.float32) * ((scales[0] + scales[1]) / 2) / 2
    for rk in res:
        got, got_r = rk["compress"]
        np.testing.assert_allclose(got[0], out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1], out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_r, np.stack(new_r), rtol=1e-6,
                                   atol=1e-6)
        # the integer payload: the dequantized sum over the mean scale
        np.testing.assert_array_equal(
            np.round(got[0] / ((scales[0] + scales[1]) / 4)).astype(np.int32),
            summed)


PERMS = {"ring": ((0, 1), (1, 0)), "partial": ((0, 1),)}


@pytest.mark.parametrize("perm", sorted(PERMS))
def test_ppermute_equals_jax(two_ranks, perm):
    """``compat.ppermute`` in a (pp=2) body, y = ppermute(2 x) * w, and the
    gradient of sum(y) in x. The ring against ``jax.lax.ppermute`` under a
    named vmap; the partial permutation, which JAX's vmap rule refuses,
    against ``jax.lax.ppermute``'s stated semantics: a shard nobody sends
    to gets zeros, and so does the gradient of a shard that sends
    nowhere."""
    res, pl, _ = two_ranks
    x, w = pl["permute"]["x"], pl["permute"]["w"]
    if perm == "ring":
        def f(xs):
            return jax.vmap(lambda a, b: jax.lax.ppermute(
                a * 2, "i", PERMS[perm]) * b, axis_name="i")(xs, w)
        want_y = np.asarray(f(jnp.asarray(x)))
        want_g = np.asarray(jax.grad(lambda xs: f(xs).sum())(
            jnp.asarray(x)))
    else:
        want_y = np.stack([np.zeros_like(x[0]), 2 * x[0] * w[1]])
        want_g = np.stack([2 * w[1], np.zeros_like(x[1])])
    for r in res:
        got_y, got_g = r["permute"][perm]
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_g, want_g)


def test_pipeline_apply_equals_sequential_stages(two_ranks):
    res, pl, _ = two_ranks
    p = pl["pipe"]
    want = p["x"]
    for s in range(2):
        want = np.tanh(want @ p["w"][s] + p["b"][s])
    for r in res:
        np.testing.assert_allclose(r["pipe"], want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# training and the elastic re-mesh
# --------------------------------------------------------------------------

def _jax_run(steps=10):
    return JRunConfig(
        model=j_get_arch("llama2-7b", reduced=True),
        shape=JShapeConfig("t", S, B, JStepKind.TRAIN),
        sharding=JShardingConfig(attn_impl="pallas", remat="block"),
        dropout=JPlanConfig(mode="overlap", site="qkv", p=0.1, seed=3,
                            attn_replay="auto"),
        train=JTrainConfig(optimizer=JOptimizerConfig(
            lr=1e-3, warmup_steps=1, total_steps=steps)))


def _port_run(steps):
    from torch_multirank import _run_config
    return _run_config(get_arch("llama2-7b", reduced=True), "qkv", "auto", B,
                       S, steps=steps)


def _batch_fn(step):
    cfg = get_arch("llama2-7b", reduced=True)
    x, y = batch_for_step(cfg, _port_run(20).shape, step)
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    jrun = _jax_run()
    jstate = j_init_state(jax.random.PRNGKey(0), jrun.model)
    master0 = _np_tree(jstate["master"])
    jstep = jax.jit(j_make_train_step(jrun.model, jrun))
    batches, jlosses = [], []
    for i in range(STEPS):
        jx, jy = j_batch(jrun.model, jrun.shape, i, seed=0)
        batches.append((np.asarray(jx), np.asarray(jy)))
        jstate, jm = jstep(jstate, jnp.asarray(jx), jnp.asarray(jy))
        jlosses.append(float(jm["loss"]))
    jmaster = [np.asarray(a) for a in jax.tree.leaves(jstate["master"])]
    # the elastic run's single-rank stretches, here; the middle on 2 ranks
    cfg = get_arch("llama2-7b", reduced=True)
    d = str(tmp_path_factory.mktemp("elastic"))
    run = _port_run(20)
    _, l1, _ = remesh_segment(cfg, run, d, 0, N1, _batch_fn, device="cpu")
    pl = dict(master=master0, batches=batches, shape=(B, S),
              elastic=dict(dir=d, start=N1, stop=N2))
    res = torch_multirank.run("training", 2, pl,
                              tmp_path_factory.mktemp("training"))
    v3, l3, st3 = remesh_segment(cfg, run, d, N2, N3, _batch_fn,
                                 device="cpu")
    _, lref, stref = remesh_segment(cfg, run,
                                    str(tmp_path_factory.mktemp("ref")), 0,
                                    N3, _batch_fn, device="cpu")
    elastic = dict(losses=l1 + res[0]["elastic"][1] + l3, ref=lref,
                   verdicts=(res[0]["elastic"][0], v3),
                   master=leaves(st3["master"]),
                   ref_master=leaves(stref["master"]))
    return res, jlosses, jmaster, elastic


@pytest.mark.parametrize("axis", ["data", "model"])
def test_two_train_steps_equal_jax(training, axis):
    res, jlosses, jmaster, _ = training
    for r in res:
        losses, norms, master = r[axis]
        np.testing.assert_allclose(losses, jlosses, **TOL)
        assert all(np.isfinite(norms))
        for got, want in zip(master, jmaster):
            np.testing.assert_allclose(got, want, **TOL)


def test_elastic_remesh_1_to_2_to_1(training):
    res, _, _, el = training
    assert el["verdicts"] == ("recompiled", "recompiled")
    assert res[0]["elastic"] == res[1]["elastic"]
    np.testing.assert_allclose(el["losses"], el["ref"], **TOL)
    for got, want in zip(el["master"], el["ref_master"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_device_batch_and_prefetcher_take_each_ranks_rows(training):
    """Under (data=2) each rank holds its own rows of the global batch (it
    makes no other rank's), in ``device_batch`` and ``Prefetcher``."""
    res, _, _, _ = training
    cfg = get_arch("llama2-7b", reduced=True)
    wx, wy = batch_for_step(cfg, _port_run(20).shape, 5)
    for rank, r in enumerate(res):
        x, y, step, px, placements = r["batch"]
        rows = slice(rank * (B // 2), (rank + 1) * (B // 2))
        np.testing.assert_array_equal(x, wx[rows])
        np.testing.assert_array_equal(y, wy[rows])
        np.testing.assert_array_equal(px, wx[rows])
        assert step == 5 and placements == "[Shard(dim=0)]"


# --------------------------------------------------------------------------
# the dropout operand check of the multi-rank runs (no ranks)
# --------------------------------------------------------------------------

def test_operand_check_holds_each_call_to_its_place():
    """``launch.multirank``'s operand check, in-process on one CPU device:
    the expected planes are JAX's ``philox_mask_ref`` planes (digests) in
    the order the flash calls consume them (each step's forward, then the
    recomputation in reverse); two steps of the reduced llama2 read
    exactly those; a log with two calls swapped, a call missing or
    another window's tiles is flagged at each wrong place."""
    from repro_torch.launch import multirank
    job = dict(arch="llama2-7b", reduced=True, layers=2, batch=B, seq=64,
               steps=STEPS, site="qkv", replay="off", compute="f32",
               p=0.1, seed=3, device="cpu", mesh=None)
    cfg = get_arch("llama2-7b", reduced=True)
    h, s = cfg.n_heads, job["seq"]
    want = multirank.expected_operands(cfg, job, (0, B, h), STEPS, "cpu")
    plan = plan_from_config(JPlanConfig(mode="overlap", site="qkv", p=0.1,
                                        seed=3))
    assert [k for k, _ in want] == [
        (st, layer, pas) for st in range(STEPS)
        for layer, pas in ((0, "forward"), (1, "forward"), (1, "remat"),
                           (0, "remat"))]
    for (st, layer, _), digests in want:
        plane = np.asarray(philox_mask_ref(
            B, h, s, s, 0.1, int(plan.step_seed(st)), int(plan.salt(layer))))
        assert digests["premask"] == multirank._digest(
            np.ascontiguousarray(plane).tobytes())
    r = multirank.train_job(0, 1, job)
    assert r["operands"] == (len(want), len(want), [])
    assert r["modes"] == ["premask"] * len(want)
    log = [("premask", d["premask"]) for _, d in want]
    assert multirank.check_operands(log, want) == []
    swapped = [log[1], log[0]] + log[2:]
    assert [b[0] for b in multirank.check_operands(swapped, want)] == [0, 1]
    assert [b[0] for b in multirank.check_operands(log[:-1], want)] == [
        len(want) - 1]
    other = multirank.expected_operands(cfg, job, (h // 2, B, h // 2), STEPS,
                                        "cpu")
    assert len(multirank.check_operands(log, other)) == len(want)
