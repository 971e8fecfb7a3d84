"""The port's partition-spec arithmetic against the JAX package's, in one
process (no ranks): ``ShardingPolicy.spec``, ``mask_plane_shards``,
``param_specs``, ``train_state_specs`` and ``cache_specs`` for every
shipped reduced config, under the default rules and the "tp" / "fsdp"
presets, on meshes (data=2), (model=2), (data=2, model=2) and (pod=2,
data=16, model=16); JAX's on a ``jax.sharding.AbstractMesh`` of the same
shape, the port's on ``launch.mesh.AbstractMesh`` (both read only the
axis names and sizes). Then ``compile_schedule(policy=)`` against JAX's:
sharded flags, producers and ``explain()`` text equal. Also the
``compat.placements`` conversion and its refusals.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.config import get_arch as j_get_arch
from repro.config import list_archs
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core.schedule import compile_schedule as j_compile
from repro.distributed import sharding as jsharding
from repro.distributed import specs as jspecs
from repro.models.transformer import cache_init as j_cache_init
from repro.models.transformer import model_init as j_model_init
from repro_torch import tree
from repro_torch.compat import P, placements
from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core.schedule import compile_schedule
from repro_torch.distributed import sharding, specs
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import cache_init, model_init

ARCHS = list_archs()
MESHES = [((2,), ("data",)), ((2,), ("model",)),
          ((2, 2), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PRESETS = [None, "tp", "fsdp"]


def _policies(mesh, preset):
    shape, axes = mesh
    rules = sharding.LAYOUT_PRESETS[preset] if preset else None
    jrules = jsharding.LAYOUT_PRESETS[preset] if preset else None
    return (sharding.ShardingPolicy(AbstractMesh(shape, axes), rules),
            jsharding.ShardingPolicy(JAbstractMesh(shape, axes), jrules))


def _norm(spec):
    """A spec as a plain tuple, trailing Nones dropped (JAX's and the
    port's render the same layout)."""
    parts = [tuple(p) if isinstance(p, (list, tuple)) else p for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _jax_spec_leaves(spec_tree):
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(jax.tree_util.keystr(kp), _norm(sp)) for kp, sp in flat[0]]


def _port_spec_leaves(spec_tree):
    return [(path, _norm(sp)) for path, sp in tree.leaves_with_paths(spec_tree)]


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg = j_get_arch(arch, reduced=True)
    jshapes = jax.eval_shape(lambda: j_model_init(jax.random.PRNGKey(0),
                                                  jcfg))
    return jshapes, model_init(get_arch(arch, reduced=True), device="cpu")


@functools.lru_cache(maxsize=None)
def _caches(arch):
    jcfg = j_get_arch(arch, reduced=True)
    jshapes = jax.eval_shape(lambda: j_cache_init(jcfg, 2, 32,
                                                  jax.numpy.float32))
    return jshapes, cache_init(get_arch(arch, reduced=True), 2, 32,
                               torch.float32, device="cpu")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(m[1]))
@pytest.mark.parametrize("preset", PRESETS, ids=str)
def test_policy_spec_and_plane_shards_equal_jax(mesh, preset):
    pol, jpol = _policies(mesh, preset)
    logical = [("batch", "seq", "embed"), ("batch", None, "heads", None),
               ("batch", None, "kv_heads", None), ("batch", None, "vocab"),
               ("batch", "seq", "mlp"), ("expert", None, "mlp"),
               ("batch", None, None, "kv_seq"), ("stack", "fsdp", "qkv")]
    shapes = [(2, 128, 64), (4, 96, 8, 16), (2, 128, 2, 16),
              (32, 64, 256), (16, 128, 96), (8, 64, 96), (2, 2, 4, 32),
              (2, 64, 64)]
    for names, shape in zip(logical, shapes):
        assert _norm(pol.spec(names, shape)) == _norm(
            jpol.spec(names, shape)), (names, shape)
        assert _norm(pol.spec(names)) == _norm(jpol.spec(names)), names
        for nm, dim in zip(names, shape):
            assert pol.mesh_axes_for(nm, dim) == jpol.mesh_axes_for(nm, dim)
    for batch, heads in ((2, 4), (1, 4), (32, 32), (2, 2), (4, 1), (64, 16)):
        assert sharding.mask_plane_shards(pol, batch, heads) == \
            jsharding.mask_plane_shards(jpol, batch, heads)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(m[1]))
@pytest.mark.parametrize("preset", PRESETS, ids=str)
def test_param_state_and_cache_specs_equal_jax(arch, mesh, preset):
    pol, jpol = _policies(mesh, preset)
    jparams, params = _params(arch)
    for fsdp in (False, True):
        got = _port_spec_leaves(specs.param_specs(params, pol, fsdp))
        want = _jax_spec_leaves(jspecs.param_specs(jparams, jpol, fsdp))
        assert got == want, (arch, fsdp)
        state = {"master": params, "opt": {"m": params, "v": params},
                 "step": 0}
        jstate = {"master": jparams, "opt": {"m": jparams, "v": jparams},
                  "step": jax.ShapeDtypeStruct((), np.int32)}
        for zero1 in (False, True):
            got = specs.train_state_specs(state, pol, fsdp, zero1)
            want = jspecs.train_state_specs(jstate, jpol, fsdp, zero1)
            for key in ("master", "opt"):
                assert _port_spec_leaves(got[key]) == \
                    _jax_spec_leaves(want[key]), (key, fsdp, zero1)
            assert _norm(got["step"]) == _norm(want["step"])
    jcaches, caches = _caches(arch)
    cfg, jcfg = get_arch(arch, reduced=True), j_get_arch(arch, reduced=True)
    assert _port_spec_leaves(specs.cache_specs(caches, cfg, pol)) == \
        _jax_spec_leaves(jspecs.cache_specs(jcaches, jcfg, jpol))
    assert specs.choose_fsdp(cfg, pol) == jspecs.choose_fsdp(jcfg, jpol)


SCHED_ARCHS = ["llama2-7b", "yi-6b", "moonshot-v1-16b-a3b", "rwkv6-7b",
               "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", SCHED_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(m[1]))
def test_compile_schedule_policy_equals_jax(arch, mesh):
    pol, jpol = _policies(mesh, None)
    cfg, jcfg = get_arch(arch, reduced=True), j_get_arch(arch, reduced=True)
    for site in ("qkv", "prev_gemm", "ffn_up", "ffn_down"):
        for replay in ("auto", "off"):
            kw = dict(mode="overlap", site=site, p=0.1, seed=3,
                      attn_replay=replay)
            for batch, seq in ((2, 128), (4, 256)):
                got = compile_schedule(cfg, DropoutPlanConfig(**kw), batch,
                                       seq, policy=pol, attn_impl="pallas")
                want = j_compile(jcfg, JPlanConfig(**kw), batch, seq,
                                 policy=jpol, attn_impl="pallas")
                assert got.explain() == want.explain(), (site, batch)
                assert got.sharded == want.sharded
                assert [(a.how, a.host_how, a.sharded, a.emit_how)
                        for a in got.assignments] == \
                    [(a.how, a.host_how, a.sharded, a.emit_how)
                     for a in want.assignments]
                assert got.shard == type(got.shard)(**{
                    f: getattr(want.shard, f)
                    for f in ("batch_shards", "head_shards", "batch_axes",
                              "head_axes", "policy_installed")})


def test_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    assert placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="twice"):
        placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="lacks"):
        placements(P("expert"), mesh)
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)
    # the port's spec is a tree leaf, not a tuple of leaves
    assert tree.leaves({"a": P("data", None), "b": [P()]}) == [
        P("data", None), P()]


def test_production_mesh_needs_its_world_size():
    with pytest.raises(RuntimeError, match="256"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True)
