"""Multi-rank harness and rank-side checks for ``tests/test_torch_multirank*``.

``run(check, world, payload, tmp_path)`` spawns ``world`` gloo ranks on the
CPU (``repro_torch.launch.mesh.run_ranks``: ``spawn``, a ``file://``
rendezvous under ``tmp_path``, ``init_process_group`` timeout 60 s), runs
the named group of checks below in each with ``payload`` (numpy arrays and
plain values: the JAX references are computed in the test process, and
no rank imports ``jax``), and returns every rank's results. The parent
joins with a deadline and kills the ranks after it, so a deadlocked
collective fails its test instead of hanging the suite. Not a test module
(no ``test_`` prefix): pytest does not collect it.
"""
from __future__ import annotations

import os

DEADLINE_S = 240.0
INIT_TIMEOUT_S = 60.0


def run(check: str, world: int, payload, tmp_path, deadline_s=DEADLINE_S):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_entry, world, (check, payload), backend="gloo",
                     deadline_s=deadline_s, timeout_s=INIT_TIMEOUT_S,
                     workdir=str(tmp_path))


def _entry(rank, world, check, payload):
    import torch
    torch.set_num_threads(1)
    return CHECKS[check](rank, world, payload)


# --------------------------------------------------------------------------
# helpers (rank side)
# --------------------------------------------------------------------------

def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(tuple(shape), tuple(axes), device="cpu")


def _np(t):
    from repro_torch.distributed.sharding import gather_full
    return gather_full(t).detach().cpu().numpy()


def _local(t):
    return (t.to_local() if hasattr(t, "to_local") else t).cpu().numpy()


def _run_config(cfg, site, replay, batch, seq, steps=10):
    from repro_torch.config.base import (DropoutPlanConfig, OptimizerConfig,
                                         RunConfig, ShapeConfig,
                                         ShardingConfig, StepKind,
                                         TrainConfig)
    return RunConfig(
        model=cfg, shape=ShapeConfig("t", seq, batch, StepKind.TRAIN),
        sharding=ShardingConfig(attn_impl="pallas", remat="block"),
        dropout=DropoutPlanConfig(mode="overlap", site=site, p=0.1, seed=3,
                                  attn_replay=replay),
        train=TrainConfig(optimizer=OptimizerConfig(
            lr=1e-3, warmup_steps=1, total_steps=steps)))


def _producers(mesh_shape, axes, pl):
    """Standalone, fused dense and grouped (E=1) producers under the mesh:
    each rank's local plane and window, and the gathered GEMM output."""
    import torch
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.multirank import _window
    policy = ShardingPolicy(_mesh(mesh_shape, axes))
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", site="qkv",
                                         p=pl["p"], seed=pl["seed"]))
    b, h, s = pl["mask_shape"][:3]
    x, w = torch.from_numpy(pl["x"]), torch.from_numpy(pl["w"])
    out = {"window": _window(policy, b, h)}
    out["standalone"] = _local(producer.standalone_packed_mask(
        plan, b, h, s, s, pl["layer"], pl["step"], policy=policy,
        device="cpu"))
    how, ghow = _hows(policy, x.shape, w.shape, (b, h, s, s))
    y, mask = producer.gemm_with_mask(x, w, plan, (b, h, s, s), pl["layer"],
                                      pl["step"], how=how, policy=policy)
    out["fused"], out["fused_y"] = _local(mask), _np(y)
    out["fused_y_spec"] = str(list(y.placements))
    yg, mg = producer.grouped_gemm_with_mask(
        x[None], w[None], plan, (b, h, s, s), pl["layer"], pl["step"],
        how=ghow, policy=policy)
    out["grouped"], out["grouped_y"] = _local(mg), _np(yg)[0]
    out["hows"] = (how, ghow)
    return out


def _hows(policy, xshape, wshape, mask_shape):
    """The dense and grouped (E=1) hosts' producers on this mesh's local
    grids: the kernel emits the plane, or Region 3 (the standalone
    kernel), as the schedule would plan them."""
    from repro_torch.core import producer
    from repro_torch.kernels.gemm_rng import mask_layout_feasible
    b, h, sq, sk = mask_shape
    (m, k), n = xshape, wshape[1]
    shard = producer.shard_exec(policy, b, h)
    nb, nh = (shard.batch_shards, shard.head_shards) if shard else (1, 1)
    m_loc, n_loc, _ = producer.shard_host_gemm(m, n, k, nb, nh)
    bm, bn, _ = producer.pick_gemm_blocks(m_loc, n_loc, k)
    dense = mask_layout_feasible((m_loc // bm) * (n_loc // bn), b // nb,
                                 h // nh, sq, sk,
                                 mask_block_cols=producer.mask_cols_cap(sq,
                                                                        sk))
    grouped, _ = producer.grouped_layout_feasible(1, m // nb, k, n, b // nb,
                                                  h // nh, sq, sk)
    return (producer.HOW_GEMM if dense else producer.HOW_STANDALONE,
            producer.HOW_GEMM_GROUPED if grouped else producer.HOW_STANDALONE)


def _params(np_tree, cfg):
    from repro_torch.convert import params_from_jax
    return params_from_jax(np_tree, cfg, device="cpu")


# --------------------------------------------------------------------------
# check groups
# --------------------------------------------------------------------------

def check_two_ranks(rank, world, pl):
    """Producers on (data=2) and (model=2); sharded forwards of the reduced
    llama2 and yi over the sites and replay settings on (model=2);
    ``compressed_allreduce`` on (data=2); ``ppermute`` and GPipe over 2
    stages on (pp=2)."""
    import torch
    from repro_torch.compat import P
    from repro_torch.config import get_arch
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import ShardingPolicy, distribute
    from repro_torch.distributed.specs import param_specs, place_tree
    from repro_torch.models import Runtime, forward
    from repro_torch.optim.compression import compressed_allreduce
    from repro_torch.train.loop import place_batch
    out = {"producers": {}}
    for axes in (("data",), ("model",)):
        out["producers"][axes[0]] = _producers((2,), axes, pl["producers"])
    mesh = _mesh((2,), ("model",))
    policy = ShardingPolicy(mesh)
    out["logits"] = {}
    for arch, np_params in pl["models"].items():
        cfg = get_arch(arch, reduced=True)
        params = _params(np_params, cfg)
        dparams = place_tree(params, param_specs(params, policy), mesh)
        x = place_batch(torch.from_numpy(pl["tokens"]), policy)
        for site in ("qkv", "prev_gemm", "ffn_up", "ffn_down"):
            for replay in ("auto", "off"):
                plan = DropoutPlan(DropoutPlanConfig(
                    mode="overlap", site=site, p=0.1, seed=3,
                    attn_replay=replay))
                rt = Runtime(plan=plan, step=0, attn_impl="pallas",
                             policy=policy)
                logits, _ = forward(dparams, cfg, rt, x)
                out["logits"][(arch, site, replay)] = _np(logits)
    # int8-compressed all-reduce over data
    dmesh = _mesh((2,), ("data",))
    g = torch.from_numpy(pl["compress"]["grads"])
    r = torch.from_numpy(pl["compress"]["residuals"])
    got, res = compressed_allreduce(distribute(g, P("data"), dmesh),
                                    distribute(r, P("data"), dmesh), dmesh,
                                    "data")
    out["compress"] = (_np(got), _np(res))
    # GPipe: 2 stages of x -> tanh(x @ w + b)
    pmesh = _mesh((2,), ("pp",))
    stages = {"w": torch.from_numpy(pl["pipe"]["w"]),
              "b": torch.from_numpy(pl["pipe"]["b"])}
    xs = torch.from_numpy(pl["pipe"]["x"])
    y = pipeline_apply(lambda p, a: torch.tanh(a @ p["w"] + p["b"]), stages,
                       xs, pmesh, "pp")
    out["pipe"] = _np(y)
    # ppermute on a ring and a partial permutation, and its transpose
    from repro_torch.compat import ppermute, shard_map
    out["permute"] = {}
    for name, perm in (("ring", ((0, 1), (1, 0))), ("partial", ((0, 1),))):
        xd = distribute(torch.from_numpy(pl["permute"]["x"]), P("pp"),
                        pmesh).requires_grad_()
        wd = distribute(torch.from_numpy(pl["permute"]["w"]), P("pp"), pmesh)
        y = shard_map(lambda a, b, perm=perm: ppermute(a * 2, "pp", perm) * b,
                      mesh=pmesh, in_specs=(P("pp"), P("pp")),
                      out_specs=P("pp"))(xd, wd)
        y.sum().backward()
        out["permute"][name] = (_np(y.detach()), _np(xd.grad))
    return out


def check_training(rank, world, pl):
    """Two train steps of the reduced llama2 under (data=2) and (model=2),
    from the master the parent gives; ``device_batch`` and ``Prefetcher``
    under (data=2); then the middle segment of the elastic 1 -> 2 -> 1 run
    on (model=2)."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.distributed.chaos import remesh_segment
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import place_train_state
    from repro_torch.tree import leaves
    cfg = get_arch("llama2-7b", reduced=True)
    out = {}
    for axes in (("data",), ("model",)):
        policy = ShardingPolicy(_mesh((2,), axes))
        run = _run_config(cfg, "qkv", "auto", *pl["shape"])
        master = _params(pl["master"], cfg)
        state = place_train_state(
            {"master": master, "opt": adamw_init(master), "step": 0},
            policy)
        step = make_train_step(cfg, run, policy=policy)
        losses, norms = [], []
        for x, y in pl["batches"]:
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[axes[0]] = (losses, norms,
                        [_np(t) for t in leaves(state["master"])])
    # device_batch / Prefetcher under (data=2): each rank its own rows
    from repro_torch.data import Prefetcher, device_batch
    policy = ShardingPolicy(_mesh((2,), ("data",)))
    run = _run_config(cfg, "qkv", "auto", *pl["shape"])
    x, y = device_batch(cfg, run.shape, 5, policy=policy, device="cpu")
    pf = Prefetcher(cfg, run.shape, start_step=5, depth=2, policy=policy,
                    device="cpu")
    try:
        step, (px, _) = next(pf)
    finally:
        pf.stop()
    out["batch"] = (_local(x), _local(y), step, _local(px),
                    str(list(x.placements)))
    el = pl["elastic"]
    policy = ShardingPolicy(_mesh((2,), ("model",)))
    run = _run_config(cfg, "qkv", "auto", *pl["shape"], steps=20)
    verdict, losses, state = remesh_segment(
        cfg, run, el["dir"], el["start"], el["stop"], _batch_fn(cfg, run),
        policy=policy)
    out["elastic"] = (verdict, losses)
    return out


def _batch_fn(cfg, run):
    import torch
    from repro_torch.data import batch_for_step

    def fn(step):
        x, y = batch_for_step(cfg, run.shape, step)
        return torch.from_numpy(x), torch.from_numpy(y)
    return fn


def check_four_ranks(rank, world, pl):
    """Producers on (data=2, model=2); the reduced moonshot's MoE layer
    through the three dispatch bodies on (data=2, model=2), hosting the
    next layer's plane; sequence-sharded decode of the reduced yi on
    (model=4)."""
    import torch
    from repro_torch.compat import P
    from repro_torch.config import get_arch
    from repro_torch.config.base import DropoutPlanConfig
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.core.schedule import compile_schedule
    from repro_torch.distributed.sharding import (ShardingPolicy, distribute,
                                                  use_policy)
    from repro_torch.distributed.specs import param_specs, place_tree
    from repro_torch.launch.multirank import _window
    from repro_torch.models.moe import moe_apply
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map
    out = {"producers": _producers((2, 2), ("data", "model"),
                                   pl["producers"])}
    cfg = get_arch("moonshot-v1-16b-a3b", reduced=True)
    mesh = _mesh((2, 2), ("data", "model"))
    mp = pl["moe"]
    x, g = torch.from_numpy(mp["x"]), torch.from_numpy(mp["g"])
    b, s, d = x.shape
    plan = DropoutPlan(DropoutPlanConfig(mode="overlap", site="ffn_up",
                                         p=0.1, seed=3))
    out["moe"] = {}
    for name, rules, seq_dispatch in (
            ("ep", None, False), ("dedup", None, True),
            ("ep_model", {"expert": ("model",)}, True)):
        policy = ShardingPolicy(mesh, rules=rules)
        params = {k: torch.from_numpy(v) for k, v in mp["params"].items()}
        specs = param_specs({"stacks": [{"l0": {"moe": tree_map(
            lambda t: t[None], params)}}]}, policy)["stacks"][0]["l0"]["moe"]
        specs = tree_map(lambda sp: P(*list(sp)[1:]), specs)
        dp = tree_map(lambda t: t.detach().requires_grad_(),
                      place_tree(params, specs, mesh))
        xs = policy.spec(("batch", "seq", "embed"), (b, s, d))
        xd = distribute(x, xs, mesh).detach().requires_grad_()
        # the first MoE layer's emission as the schedule plans it here
        asg = compile_schedule(cfg, plan.cfg, b, s, policy=policy,
                               attn_impl="pallas",
                               moe_seq_dispatch=seq_dispatch).for_layer(
            cfg.moe.first_dense_layers)
        host = producer.FFNHost(
            plan=plan, site="ffn_up", mask_shape=(b, cfg.n_heads, s, s),
            layer_idx=cfg.moe.first_dense_layers + asg.emit_stride, step=0,
            how=asg.emit_how, policy=policy)
        with use_policy(policy):
            if asg.emit_how == producer.HOW_GEMM_GROUPED:
                y, aux, mask = moe_apply(dp, xd, cfg, policy,
                                         seq_dispatch=seq_dispatch,
                                         host=host)
            else:
                y, aux = moe_apply(dp, xd, cfg, policy,
                                   seq_dispatch=seq_dispatch)
                mask = producer.standalone_packed_mask(
                    plan, b, cfg.n_heads, s, s, host.layer_idx, 0,
                    policy=policy, device="cpu")
            (y * distribute(g, xs, mesh)).sum().backward()
        out["moe"][name] = dict(
            y=_np(y.detach()), aux=float(_np(aux.detach())),
            gx=_np(xd.grad), gw={k: _np(v.grad) for k, v in dp.items()},
            plane=_local(mask), window=_window(policy, b, cfg.n_heads),
            layer=host.layer_idx, how=asg.emit_how)
    # sequence-sharded decode: yi's 2 kv-heads do not divide model=4
    ycfg = get_arch("yi-6b", reduced=True)
    dpol = ShardingPolicy(_mesh((4,), ("model",)))
    params = _params(pl["decode"]["params"], ycfg)
    dparams = place_tree(params, param_specs(params, dpol), dpol.mesh)
    prefill = make_prefill_step(ycfg, policy=dpol,
                                capacity=pl["decode"]["capacity"])
    serve = make_serve_step(ycfg, policy=dpol)
    logits, caches = prefill(dparams, torch.from_numpy(pl["decode"]["prompt"]))
    got = [_np(logits)]
    out["cache_placements"] = str(list(caches[0]["l0"]["k"].placements))
    for tok in pl["decode"]["fed"]:
        logits, caches = serve(dparams, torch.from_numpy(tok), caches)
        got.append(_np(logits))
    out["decode"] = got
    # core.attention_decode on a sequence-sharded cache (DTensor reductions)
    from repro_torch.core.attention import attention_decode
    from repro_torch.distributed.sharding import use_policy
    ad = pl["attn_decode"]
    q, k, v = (torch.from_numpy(ad[n]) for n in ("q", "k", "v"))
    seq = P(None, None, "model", None)
    with use_policy(dpol):
        out["attn_decode"] = _np(attention_decode(
            distribute(q, P(), dpol.mesh), distribute(k, seq, dpol.mesh),
            distribute(v, seq, dpol.mesh), ad["len"],
            local_window=ad["window"]))
    return out


CHECKS = {"two_ranks": check_two_ranks, "training": check_training,
          "four_ranks": check_four_ranks}


class one_rank_group:
    """A gloo process group of one rank in this process (a ``file://``
    store under ``path``), for the policy branches that need a live mesh
    but no peers; destroyed on exit."""

    def __init__(self, path):
        self.path = os.path.join(str(path), "one_rank_store")

    def __enter__(self):
        import datetime

        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"file://{self.path}", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False
