"""Sharded training and MoE runs, one process a rank: the workers that
``launch.mesh.run_ranks`` spawns (``chip_smoke.py``'s phase 16 drives
them on the card; each also runs in-process with no mesh, the
single-device reference).

``train_job`` trains a model under a ShardingPolicy on a mesh of the
running process group and returns each step's loss, grad norm and time,
the kernel launches, and a check of every dropout operand the flash
kernels consumed, in the order they consumed them: under premask the
n-th local plane must be bitwise the ``shard_plane_windows`` slice of the
single-device plane of the (step, layer) the n-th call serves (made here
by the plain Philox version over the whole plane), under replay the n-th
seed-salt word must be that (step, layer)'s with the rank's window
offset. ``moe_job`` runs one MoE layer of a model sharded expert-parallel
and holds its output, its input's gradient and its weights' gradients
against the single-device layer on each source's tokens (the dispatch's
per-source capacity) and its hosted plane tile against the plain one.

A job is a dict (JSON-able): arch, layers (None: the config's), reduced,
mesh ([shape], [axes]) or None, device, site, gemm_dtype, compute
("f32" | "bf16"), replay ("auto" | "off"), p, batch, seq, steps, seed,
zero1 (the ZeRO split of the state over 'data', default on).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Tuple

import torch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _model(job):
    from repro_torch.config import get_arch
    cfg = get_arch(job["arch"], reduced=job.get("reduced", False))
    if job.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=job["layers"])
    return cfg


def _run(cfg, job):
    from repro_torch.config.base import (DropoutPlanConfig, OptimizerConfig,
                                         RunConfig, ShapeConfig,
                                         ShardingConfig, StepKind,
                                         TrainConfig)
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("multirank", seq_len=job["seq"],
                          global_batch=job["batch"], kind=StepKind.TRAIN),
        sharding=ShardingConfig(attn_impl="pallas", remat="block"),
        dropout=DropoutPlanConfig(mode="overlap", site=job["site"],
                                  gemm_dtype=job.get("gemm_dtype", "f32"),
                                  p=job.get("p", 0.1),
                                  attn_replay=job.get("replay", "auto"),
                                  seed=job.get("seed", 3)),
        train=TrainConfig(optimizer=OptimizerConfig(
            lr=1e-3, warmup_steps=1, total_steps=10)))


def _policy(job):
    if not job.get("mesh"):
        return None
    import torch.distributed as dist

    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import (make_host_mesh,
                                         stage_gloo_cuda_gathers)
    shape, axes = job["mesh"]
    device = job.get("device", "cuda")
    if device == "cuda" and dist.get_backend() == "gloo":
        stage_gloo_cuda_gathers()         # ranks sharing one card
    mesh = make_host_mesh(tuple(shape), tuple(axes), device=device)
    return ShardingPolicy(mesh, rules=job.get("rules"))


def _window(policy, batch: int, heads: int) -> Tuple[int, int, int]:
    """This rank's (bh_offset, b_loc, h_loc) tile of the plane:
    ``shard_plane_windows``' entry at its flattened (batch, head) shard
    coordinates."""
    from repro_torch.distributed.sharding import mask_plane_shards
    from repro_torch.kernels.philox_common import shard_plane_windows
    if policy is None:
        return 0, batch, heads
    (b_axes, nb), (h_axes, nh) = mask_plane_shards(policy, batch, heads)
    ib = ih = 0
    for a in b_axes:
        ib = ib * policy.sizes[a] + policy.mesh.get_local_rank(a)
    for a in h_axes:
        ih = ih * policy.sizes[a] + policy.mesh.get_local_rank(a)
    return shard_plane_windows(batch, heads, nb, nh)[ib * nh + ih]


def _operand_recorder(log: List[Tuple[str, str]]):
    """(install, restore) of a wrapper of the attention layer's flash entry
    point that logs, a call, the digest of its dropout operand: the local
    plane's bytes under premask, the four seed-salt words and the heads
    count under replay."""
    from repro_torch.kernels import philox_common
    from repro_torch.models import attention
    orig = attention.flash_attention_mosaic

    def wrapped(q, k, v, mask_packed=None, causal=True, local_window=0,
                dropout_p=0.0, mode="none", seed=0, salt=0, rounds=7,
                heads_global=0):
        if mode == "premask":
            log.append((mode, _digest(
                mask_packed.contiguous().cpu().numpy().tobytes())))
        elif mode == "replay":
            words = (philox_common.seed_salt_words(seed, salt)
                     if mask_packed is None else tuple(
                         philox_common.from_int32_bits(mask_packed).tolist()))
            log.append((mode, _digest(repr(
                (words, heads_global or q.shape[1])).encode())))
        return orig(q, k, v, mask_packed, causal, local_window, dropout_p,
                    mode, seed, salt, rounds, heads_global)

    def install():
        attention.flash_attention_mosaic = wrapped

    def restore():
        attention.flash_attention_mosaic = orig
    return install, restore


def expected_operands(cfg, job, window, steps: int, device
                      ) -> List[Tuple[Tuple[int, int, str], Dict[str, str]]]:
    """The dropout operands the flash kernels of a rank with ``window``
    consume over ``steps`` steps, in the order they consume them: each
    step's forward takes the layers in order, then the backward's
    recomputation (remat="block", one attention layer a stack unit) in
    reverse. An entry is ((step, layer, "forward" | "remat"), {mode:
    digest}): the layer's plane, made whole by the plain Philox version
    and sliced to the window, and its replay words with the window's
    offset."""
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.kernels import philox_common
    from repro_torch.kernels.philox import philox_dropout_mask_plain
    run = _run(cfg, job)
    plan = DropoutPlan(run.dropout)
    b, h, s = job["batch"], cfg.n_heads, job["seq"]
    off, b_loc, h_loc = window
    b0, h0 = off // h, off % h
    out = []
    for step in range(steps):
        per_layer = []
        for layer in range(cfg.n_layers):
            seed, salt = plan.step_seed(step), plan.salt(layer)
            plane = philox_dropout_mask_plain(
                b, h, s, s, plan.cfg.p, seed, salt, plan.cfg.philox_rounds,
                device=device)
            tile = plane[b0:b0 + b_loc, h0:h0 + h_loc]
            words = philox_common.seed_salt_words(seed, salt, off)
            per_layer.append({
                "premask": _digest(tile.contiguous().cpu().numpy().tobytes()),
                "replay": _digest(repr((words, h)).encode())})
        out += [((step, layer, "forward"), per_layer[layer])
                for layer in range(cfg.n_layers)]
        if run.sharding.remat == "block":
            out += [((step, layer, "remat"), per_layer[layer])
                    for layer in reversed(range(cfg.n_layers))]
    return out


def check_operands(log: List[Tuple[str, str]], want) -> List[Tuple]:
    """The entries of ``log`` (the (mode, digest) a flash call consumed,
    in call order) that are not the operand ``want`` (``expected_operands``)
    names at their place, as (index, key, mode, digest); a call past
    ``want``'s end, or one ``want`` names that never came, counts too."""
    bad = []
    for i in range(max(len(log), len(want))):
        key, digests = want[i] if i < len(want) else (None, {})
        mode, d = log[i] if i < len(log) else (None, None)
        if d is None or digests.get(mode) != d:
            bad.append((i, key, mode, d))
    return bad


def train_job(rank: int, world: int, job: Dict[str, Any]) -> Dict[str, Any]:
    """``job["steps"]`` training steps of ``job``'s model on its mesh (one
    device with no mesh). Returns {"losses", "grad_norms", "step_s",
    "launches", "operands": (n consumed, n expected, ``check_operands``'
    mismatches), "modes" (each flash call's dropout mode), "window",
    "rank", "job_s"}."""
    from repro_torch.data import device_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import init_train_state, make_train_step
    t_job = time.perf_counter()
    policy = _policy(job)
    device = job.get("device", "cuda")
    cfg = _model(job)
    run = _run(cfg, job)
    compute = _DTYPES[job.get("compute", "f32")]
    state = init_train_state(cfg, seed=job.get("seed", 3),
                             device=None if policy else device,
                             policy=policy, zero1=job.get("zero1", True))
    step_fn = make_train_step(cfg, run, policy=policy,
                              compute_dtype=compute, donate=True)
    log: List[Tuple[str, str]] = []
    install, restore = _operand_recorder(log)
    losses, norms, times = [], [], []
    reset_launch_counts()
    install()
    try:
        for i in range(job["steps"]):
            x, y = device_batch(cfg, run.shape, i, policy=policy,
                                device=None if policy else device)
            _sync(device)
            t0 = time.perf_counter()
            state, m = step_fn(state, x, y)
            _sync(device)
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        restore()
    launches = launch_counts()
    window = _window(policy, job["batch"], cfg.n_heads)
    want = expected_operands(cfg, job, window, job["steps"], device)
    del state
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "launches": launches,
            "operands": (len(log), len(want), check_operands(log, want)),
            "modes": [mode for mode, _ in log], "window": window,
            "rank": rank, "job_s": time.perf_counter() - t_job}


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def moe_job(rank: int, world: int, job: Dict[str, Any]) -> Dict[str, Any]:
    """One MoE layer (the first MoE stack's layer 0 of ``job``'s model, its
    weights from the seed) on a random (B, S, D) input under the mesh,
    hosting the next layer's plane under the expert gate einsum (site
    "ffn_up", the grouped host), then its backward. Returns the output's
    largest difference from the single-device layer applied to each
    source's tokens, the aux losses, the hosted tile's check against the
    plain Philox version, the x gradient's largest difference and each
    weight gradient's ("gw_err": {leaf: largest difference over the larger
    of 1 and the reference's largest entry}) from the single-device
    layer's, summed over the sources."""
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.distributed.sharding import (distribute, gather_full,
                                                  mask_plane_shards,
                                                  use_policy)
    from repro_torch.distributed.specs import param_specs, place_tree
    from repro_torch.kernels.philox import philox_dropout_mask_plain
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.tree import tree_map
    policy = _policy(job)
    device = job.get("device", "cuda")
    cfg = _model(job)
    gen = torch.Generator(device=device)
    gen.manual_seed(job.get("seed", 3))
    p = moe_init(gen, cfg, device=device)
    b, s, d = job["batch"], job["seq"], cfg.d_model
    x = torch.randn((b, s, d), generator=gen, device=device) * 0.5
    g = torch.randn((b, s, d), generator=gen, device=device)
    from repro_torch.core.schedule import compile_schedule
    run = _run(cfg, job)
    plan = DropoutPlan(run.dropout)
    mask_shape = (b, cfg.n_heads, s, s)
    # the first MoE layer's emission, as the schedule plans it on the mesh
    first = cfg.moe.first_dense_layers
    asg = compile_schedule(cfg, run.dropout, b, s, policy=policy,
                           attn_impl="pallas").for_layer(first)
    consumer = first + asg.emit_stride
    host = producer.FFNHost(plan=plan, site="ffn_up", mask_shape=mask_shape,
                            layer_idx=consumer, step=0, how=asg.emit_how,
                            policy=policy)
    nb = mask_plane_shards(policy, b, cfg.n_heads)[0][1]
    # the single-device reference, source by source (per-source capacity)
    y_ref, aux_ref = [], []
    rows = b // nb
    for r in range(nb):
        yr, ar = moe_apply(p, x[r * rows:(r + 1) * rows], cfg)
        y_ref.append(yr.detach())
        aux_ref.append(float(ar))
    y_ref = torch.cat(y_ref)
    specs = param_specs({"stacks": [{"l0": {"moe": tree_map(
        lambda t: t[None], p)}}]}, policy)["stacks"][0]["l0"]["moe"]
    from repro_torch.compat import P
    specs = tree_map(lambda sp: P(*list(sp)[1:]), specs)
    dp = tree_map(lambda t: t.detach().requires_grad_(),
                  place_tree(p, specs, policy.mesh))
    x_spec = policy.spec(("batch", "seq", "embed"), (b, s, d))
    xd = distribute(x, x_spec, policy.mesh).detach().requires_grad_()
    _sync(device)
    t0 = time.perf_counter()
    with use_policy(policy):
        y, aux, mask = moe_apply(dp, xd, cfg, policy, host=host)
        (y * distribute(g, x_spec, policy.mesh)).sum().backward()
    _sync(device)
    step_s = time.perf_counter() - t0
    y_err = float((gather_full(y.detach()) - y_ref).abs().max())
    # the hosted tile against the plain version's slice of the plane
    off, b_loc, h_loc = _window(policy, b, cfg.n_heads)
    want = philox_dropout_mask_plain(
        b, cfg.n_heads, s, s, plan.cfg.p, plan.step_seed(0),
        plan.salt(consumer), plan.cfg.philox_rounds, device=device)
    b0, h0 = off // cfg.n_heads, off % cfg.n_heads
    tile_ok = bool(torch.equal(
        mask.to_local(), want[b0:b0 + b_loc, h0:h0 + h_loc]))
    # the y-path gradients of x and of the router and expert weights
    # against the single-device layer's, summed over the sources
    xr = x.detach().requires_grad_()
    pr = tree_map(lambda t: t.detach().requires_grad_(), p)
    yr = torch.cat([moe_apply(pr, xr[r * rows:(r + 1) * rows], cfg)[0]
                    for r in range(nb)])
    (yr * g).sum().backward()
    gx_err = float((gather_full(xd.grad) - xr.grad).abs().max())
    gw_err = {k: float((gather_full(dp[k].grad) - pr[k].grad).abs().max()
                       / max(float(pr[k].grad.abs().max()), 1.0))
              for k in pr}
    return {"y_err": y_err, "aux": float(gather_full(aux.detach())),
            "aux_ref": sum(aux_ref) / len(aux_ref), "tile_ok": tile_ok,
            "window": (off, b_loc, h_loc), "gx_err": gx_err,
            "gw_err": gw_err, "step_s": step_s, "how": asg.emit_how,
            "rank": rank}


def jobs(rank: int, world: int, items) -> List[Dict[str, Any]]:
    """Each (kind, job) of ``items`` in turn on this rank -- kind "train"
    (``train_job``) or "moe" (``moe_job``) -- in one process group, the
    memory of each freed before the next. Returns their results."""
    import gc
    out = []
    for kind, job in items:
        fn = {"train": train_job, "moe": moe_job}[kind]
        out.append(fn(rank, world, job))
        gc.collect()
        if str(job.get("device", "cuda")).startswith("cuda"):
            torch.cuda.empty_cache()
    return out
