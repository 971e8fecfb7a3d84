"""The port's decode engine against the JAX package's, the port's paged-KV
allocator and scheduler, and the port's independence from JAX.

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve.py
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.models import model_init as j_model_init
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.config import DropoutPlanConfig, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.schedule import compile_schedule
from repro_torch.serve import (
    OutOfPagesError,
    PackedMaskCache,
    PagePool,
    ServeConfig,
    ServeEngine,
)

ROOT = Path(__file__).resolve().parents[1]
SERVE_KW = dict(max_slots=2, page_size=16, num_pages=16, max_model_len=96,
                prompt_bucket=8)


def _cfg():
    return get_arch("yi-6b", reduced=True)


def _serve(**kw):
    return ServeConfig(**{**SERVE_KW, **kw})


def _requests(engine, n, plen=10, max_new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [engine.make_request(
        rng.integers(0, engine.cfg.vocab_size, plen).tolist(), max_new)
        for _ in range(n)]


def _engine(**kw):
    return ServeEngine(_cfg(), serve=_serve(**kw), init_seed=0,
                       device="cpu")


# ------------------------------------------------------- engine vs JAX

@pytest.mark.parametrize("arch", ["yi-6b", "llama2-7b"])
def test_engine_matches_jax_engine(arch):
    """Same requests and weights through both engines: identical tokens,
    identical mask-cache stats, every (request, layer) plane bitwise."""
    jcfg, cfg = j_get_arch(arch, reduced=True), get_arch(arch, reduced=True)
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    jeng = JServeEngine(jcfg, serve=JServeConfig(**SERVE_KW),
                        params=jparams, init_seed=0)
    teng = ServeEngine(cfg, serve=_serve(), init_seed=0, device="cpu",
                       params=params_from_jax(
                           jax.tree.map(np.asarray, jparams), cfg,
                           device="cpu"))
    jreqs, treqs = _requests(jeng, 3), _requests(teng, 3)
    jeng.run(jreqs)
    rep = teng.run(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(len(r.output) == 6 for r in treqs)
    assert teng.mask_cache.stats() == jeng.mask_cache.stats()
    assert rep.mask_cache["misses"] == 3 * cfg.n_layers
    assert teng.nonfinite_logits == 0
    jplanes = dict(jeng.mask_cache._entries)
    tplanes = dict(teng.mask_cache.items())
    assert sorted(tplanes) == sorted(jplanes)
    for key, plane in tplanes.items():
        np.testing.assert_array_equal(plane.numpy().view(np.uint32),
                                      np.asarray(jplanes[key]))


def test_engine_queue_pressure_never_changes_bits():
    def run(max_slots):
        eng = _engine(max_slots=max_slots)
        reqs = _requests(eng, 4, plen=10, max_new=5)
        eng.run(reqs)
        return [r.output for r in reqs], eng
    out2, eng2 = run(2)
    out1, _ = run(1)
    assert all(len(o) == 5 for o in out2)
    assert out1 == out2
    assert eng2.scheduler.stats()["retired"] == 4
    assert eng2.pool_alloc.pages_in_use == 0


# ---------------------------------------------------------- mask cache

def test_mask_cache_true_lru_and_eviction_counter():
    cfg = _cfg()
    sched = compile_schedule(cfg, DropoutPlanConfig(mode="overlap", p=0.1,
                                                    seed=7), 1, 32)
    shape = (1, cfg.n_heads, 32, 32)
    cache = PackedMaskCache(capacity=2, device="cpu")
    a = cache.get_or_create(sched, 0, 0, shape)
    cache.get_or_create(sched, 0, 1, shape)
    assert cache.get_or_create(sched, 0, 0, shape) is a
    cache.get_or_create(sched, 0, 2, shape)         # evicts (0, 1)
    assert cache.stats()["evictions"] == 1
    assert cache.get_or_create(sched, 0, 0, shape) is a
    misses = cache.misses
    cache.get_or_create(sched, 0, 1, shape)
    assert cache.misses == misses + 1 == cache.snapshot_rng()
    assert cache.stats() == {"hits": 2, "misses": 4, "evictions": 2,
                             "entries": 2}


# ------------------------------------------------------------ paged KV

def test_page_pool_alloc_reclaim_fragmentation():
    pool = PagePool(num_pages=8, page_size=16)
    assert pool.pages_needed(1) == 1
    assert pool.pages_needed(16) == 1
    assert pool.pages_needed(17) == 2
    a = pool.allocate(3)
    b = pool.allocate(3)
    assert pool.pages_in_use == 6 and pool.free_pages == 2
    assert pool.allocate(3) is None
    assert pool.alloc_failures == 1
    pool.free(a)
    c = pool.allocate(5)
    assert c is not None
    assert sorted(c.pages + b.pages) == list(range(8))
    for pos in range(c.capacity):
        assert c.physical_slot(pos) == c.pages[pos // 16] * 16 + pos % 16
    idx = c.physical_index(width=96)
    assert idx.shape == (96,) and idx.dtype == np.int32
    assert list(idx[:c.capacity]) == [c.physical_slot(i)
                                      for i in range(c.capacity)]
    assert all(idx[c.capacity:] == 0)
    with pytest.raises(OutOfPagesError):
        pool.allocate(9)
    pool.free(b)
    pool.free(c)
    assert pool.free_pages == 8
    assert pool.stats()["peak_pages_in_use"] == 8


def test_page_pool_double_free_caught():
    pool = PagePool(num_pages=2, page_size=4)
    a = pool.allocate(1)
    pool.free(a)
    with pytest.raises(AssertionError):
        pool.free(a)


# ----------------------------------------------- scheduler / admission

def test_scheduler_admission_under_queue_pressure():
    eng = _engine(max_slots=2, num_pages=3, max_model_len=64)
    sch = eng.scheduler
    reqs = _requests(eng, 3, plen=20, max_new=12)   # 2 pages each
    for r in reqs:
        sch.submit(r)
    assert sch.admit_next() is reqs[0]
    assert sch.admit_next() is None
    assert eng.pool_alloc.alloc_failures == 1
    assert len(sch.queue) == 2
    sch.retire(reqs[0])
    assert sch.admit_next() is reqs[1]
    assert sch.admit_next() is None
    st = sch.stats()
    assert st["admitted"] == 2 and st["retired"] == 1
    assert st["queued"] == 1 and st["peak_running"] == 1


def test_scheduler_rejects_over_length_request():
    eng = _engine()
    with pytest.raises(ValueError):
        eng.submit(eng.make_request([1] * 90, 20))  # 110 > 96


# ------------------------------------------------------- bucket caches

def test_schedule_bucket_cache_reuse_across_requests():
    """One compile per shape bucket; later same-bucket requests reseed the
    template: distinct masks, shared compilation."""
    eng = _engine()
    r1 = eng.make_request(list(range(10)), 6)
    r2 = eng.make_request(list(range(10)), 6)
    r3 = eng.make_request(list(range(30)), 6)       # different bucket
    for r in (r1, r2, r3):
        eng._admission_schedule(r)
    assert eng.schedule_buckets.stats() == {"hits": 1, "misses": 2,
                                            "entries": 2}
    assert r1.bucket == r2.bucket != r3.bucket
    assert r1.schedule.plan.seed != r2.schedule.plan.seed
    assert r1.schedule.mask_key(0, 0) != r2.schedule.mask_key(0, 0)
    assert dataclasses.replace(r1.schedule, plan=r2.schedule.plan) \
        == r2.schedule


# ---------------------------------------------------- scope and device

def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_engine_defaults_to_cuda():
    """Without ``device=`` the engine runs on the card; on a machine
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        eng = ServeEngine(_cfg(), serve=_serve())
        assert eng.device.type == "cuda"
        assert eng.pools[0]["l0"]["k"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(_cfg(), serve=_serve())


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="speculative"):
        _engine(spec_k=4)
    for plan in (DropoutPlanConfig(mode="overlap", site="auto"),
                 DropoutPlanConfig(mode="overlap", site="prev_gemm")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compile_schedule(_cfg(), plan, 1, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_schedule(_cfg(), DropoutPlanConfig(mode="overlap"), 1, 64,
                         policy=object())
    inert = compile_schedule(_cfg(), DropoutPlanConfig(mode="none"), 1, 64,
                             attn_impl="pallas")
    assert not inert.active
    with pytest.raises(ValueError, match="philox_rounds"):
        DropoutPlanConfig(philox_rounds=4)
