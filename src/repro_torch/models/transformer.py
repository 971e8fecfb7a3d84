"""Model assembly: stacks of layer units, init, the training forward,
prefill, and decode through paged KV pools (dense full-attention stacks).

Parameters mirror the JAX package's pytree: ``params["stacks"][i]`` holds
a stack's repeating unit with every tensor carrying a leading ``count``
dimension; the JAX layer scan becomes a Python loop that indexes it, and
its ``jax.checkpoint`` (remat="block") a ``torch.utils.checkpoint`` of
each unit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import AttentionKind, ModelConfig
from repro_torch.core.overlap import DropoutPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    attn_apply,
    attn_decode_paged,
    attn_init,
    attn_prefill,
)
from repro_torch.models.layers import (
    embed_init,
    ffn_apply,
    ffn_init,
    norm_apply,
    norm_init,
)


@dataclasses.dataclass
class Runtime:
    """Per-call execution context threaded through the model.

    ``step`` is a host int: the plan folds it into the Philox key on the
    host, so no layer reads a value back from the card. ``schedule`` is
    the compiled DropoutSchedule; when None and a plan is set, ``forward``
    compiles one from the plan's site sugar. ``attn_impl="pallas"`` runs
    the CUDA flash kernels."""
    plan: Optional[DropoutPlan] = None
    step: int = 0
    compute_dtype: Any = torch.float32
    chunk_q: int = 1024
    remat: str = "none"            # none | block
    attn_impl: str = "xla"         # xla | pallas
    schedule: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class StackSpec:
    unit: Tuple[Tuple[AttentionKind, str], ...]  # (kind, "dense"|"moe")
    count: int
    base: int                                     # first layer index


def build_stacks(cfg: ModelConfig) -> List[StackSpec]:
    kinds = cfg.layer_kinds()
    n = cfg.n_layers
    first_dense = cfg.moe.first_dense_layers if cfg.moe else 0
    tag = lambda i: ("moe" if (cfg.moe is not None and i >= first_dense)
                     else "dense")
    stacks: List[StackSpec] = []
    start = 0
    if first_dense:
        assert len(cfg.block_pattern) == 1, \
            "first_dense_layers requires a uniform block pattern"
        stacks.append(StackSpec(
            unit=tuple((kinds[i], "dense") for i in range(first_dense)),
            count=1, base=0))
        start = first_dense
    p = len(cfg.block_pattern)
    rem = n - start
    cnt = rem // p
    if cnt:
        unit = tuple((kinds[start + j], tag(start + j)) for j in range(p))
        stacks.append(StackSpec(unit=unit, count=cnt, base=start))
        start += cnt * p
    if start < n:
        unit = tuple((kinds[i], tag(i)) for i in range(start, n))
        stacks.append(StackSpec(unit=unit, count=1, base=start))
    return stacks


def _index(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _layer_init(gen, cfg: ModelConfig, kind: AttentionKind, tag: str,
                count: int, device):
    lead = (count,)
    if kind != AttentionKind.FULL or tag != "dense":
        raise NotImplementedError(
            f"{kind.value}/{tag} layers are not ported yet (ROADMAP: port "
            "queue, LOCAL/MoE/recurrent paging)")
    return {"norm_mix": norm_init(cfg, lead=lead, device=device),
            "norm_ffn": norm_init(cfg, lead=lead, device=device),
            "mix": attn_init(gen, cfg, lead=lead, device=device),
            "ffn": ffn_init(gen, cfg, lead=lead, device=device)}


def model_init(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    the JAX package's shapes and scales (normal / sqrt(d_in) projections,
    0.02 embeddings, unit norms), not its draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {"final_norm": norm_init(cfg, device=dev)}
    if cfg.frontend == "token":
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dev)
    if cfg.frontend != "token" or not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dev).T.contiguous()
    stacks = []
    for spec in build_stacks(cfg):
        stacks.append({f"l{j}": _layer_init(gen, cfg, kind, tag, spec.count,
                                            dev)
                       for j, (kind, tag) in enumerate(spec.unit)})
    params["stacks"] = stacks
    return params


# --------------------------------------------------------------------------
# embed / unembed
# --------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, inputs: torch.Tensor,
                 rt: Runtime) -> torch.Tensor:
    if cfg.frontend == "token":
        # F.embedding's backward sums rows without atomics: bitwise
        # reproducible on the card
        x = F.embedding(inputs.long(), params["embed"])
    else:
        x = inputs                                  # precomputed embeddings
    return x.to(rt.compute_dtype)


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x.to(torch.float32) @ w.to(torch.float32)


# --------------------------------------------------------------------------
# block forward (training)
# --------------------------------------------------------------------------

def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: port queue, carried sites / "
        "LOCAL, MoE and recurrent layers)")


def _mix_forward(p, x, cfg: ModelConfig, rt: Runtime, kind, layer_idx,
                 asg=None):
    if kind not in (AttentionKind.FULL, AttentionKind.LOCAL):
        raise _not_ported(f"{kind.value} mixers")
    return attn_apply(p, x, cfg, kind=kind, plan=rt.plan,
                      layer_idx=layer_idx, step=rt.step, chunk_q=rt.chunk_q,
                      impl=rt.attn_impl, asg=asg)


def _ffn_forward(p, x, cfg: ModelConfig, tag):
    """The dense, un-hosted FFN (no ported schedule hosts a mask there)."""
    if tag != "dense":
        raise _not_ported("MoE FFNs")
    return ffn_apply(p["ffn"], x, cfg)


def block_apply(p, x, cfg: ModelConfig, rt: Runtime, kind, tag, layer_idx,
                asg=None):
    """One pre-norm block: x + mix(norm(x)), then + ffn(norm(x)). ``asg``
    is the block's HostAssignment from the compiled schedule."""
    h = norm_apply(p["norm_mix"], x, cfg)
    x = x + _mix_forward(p["mix"], h, cfg, rt, kind, layer_idx, asg=asg)
    h2 = norm_apply(p["norm_ffn"], x, cfg)
    return x + _ffn_forward(p, h2, cfg, tag)


def forward(params, cfg: ModelConfig, rt: Runtime, inputs
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / eval forward. inputs: tokens (B, S) or embeddings
    (B, S, D). Returns (logits f32 (B, S, V), aux loss).

    Mask production follows the compiled DropoutSchedule (rt.schedule, or
    compiled here from the plan). With remat="block" every stack unit runs
    under ``torch.utils.checkpoint`` and is recomputed in the backward: its
    GEMM+RNG and flash forward launch again there, and the keep bits come
    out the same because the counters are position-based."""
    x = embed_inputs(params, cfg, inputs, rt)
    sched = rt.schedule
    if sched is not None and (sched.batch, sched.seq) != (x.shape[0],
                                                          x.shape[1]):
        sched = None               # stale artifact: recompile for shape
    if sched is None and rt.plan is not None:
        from repro_torch.core import schedule as schedule_mod
        sched = schedule_mod.compile_schedule(
            cfg, rt.plan.cfg, x.shape[0], x.shape[1],
            attn_impl=rt.attn_impl)
    active = sched is not None and sched.active
    if active and sched.carried:
        raise _not_ported("carried-site schedules")
    for spec, stack_params in zip(build_stacks(cfg), params["stacks"]):
        unit_len = len(spec.unit)
        unit_asgs = tuple(sched.for_layer(spec.base + j) if active else None
                          for j in range(unit_len))
        for pos in range(spec.count):
            up = _index(stack_params, pos)

            def unit_apply(x, _up=up, _pos=pos, _spec=spec, _ul=unit_len,
                           _asgs=unit_asgs):
                for j, (kind, tag) in enumerate(_spec.unit):
                    x = block_apply(_up[f"l{j}"], x, cfg, rt, kind, tag,
                                    _spec.base + _pos * _ul + j,
                                    asg=_asgs[j])
                return x

            if rt.remat == "block":
                x = checkpoint(unit_apply, x, use_reentrant=False)
            else:
                x = unit_apply(x)
    x = norm_apply(params["final_norm"], x, cfg)
    # the aux (router) loss of MoE stacks; the dense stacks ported so far
    # have none
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, cfg, x), aux


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _layer_prefill(p, x, cfg, rt: Runtime, kind, tag, layer_idx, capacity):
    h = norm_apply(p["norm_mix"], x, cfg)
    y, cache = attn_prefill(p["mix"], h, cfg, kind=kind, plan=None,
                            layer_idx=layer_idx, step=rt.step,
                            chunk_q=rt.chunk_q, capacity=capacity)
    x = x + y
    h2 = norm_apply(p["norm_ffn"], x, cfg)
    return x + ffn_apply(p["ffn"], h2, cfg), cache


def prefill(params, cfg: ModelConfig, rt: Runtime, inputs,
            capacity: int = 0, last_pos: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[Any]]:
    """Returns (logits (B,1,V) at ``last_pos`` or the last position,
    caches): per stack, per unit position, {"k","v": (count,B,KV,cap,hd),
    "len": (count,)}."""
    x = embed_inputs(params, cfg, inputs, rt)
    caches = []
    for spec, stack_params in zip(build_stacks(cfg), params["stacks"]):
        unit_len = len(spec.unit)
        per_layer: Dict[str, List[Dict[str, torch.Tensor]]] = {
            f"l{j}": [] for j in range(unit_len)}
        for pos in range(spec.count):
            for j, (kind, tag) in enumerate(spec.unit):
                lp = _index(stack_params[f"l{j}"], pos)
                x, c = _layer_prefill(lp, x, cfg, rt, kind, tag,
                                      spec.base + pos * unit_len + j,
                                      capacity)
                per_layer[f"l{j}"].append(c)
        caches.append({key: {f: torch.stack([c[f] for c in cs])
                             for f in ("k", "v", "len")}
                       for key, cs in per_layer.items()})
    x = norm_apply(params["final_norm"], x, cfg)
    x_last = x[:, -1:, :] if last_pos is None else \
        x[:, int(last_pos):int(last_pos) + 1, :]
    return unembed(params, cfg, x_last), caches


# --------------------------------------------------------------------------
# paged decode (serve engine)
# --------------------------------------------------------------------------

def paged_supported_reason(cfg: ModelConfig) -> Optional[str]:
    """None when the paged decode path covers this arch, else why not."""
    if cfg.frontend != "token":
        return f"frontend {cfg.frontend!r} is a stub (no token ids)"
    bad = {k.value for k in cfg.layer_kinds()
           if k != AttentionKind.FULL}
    if bad:
        return f"non-FULL layer kinds {sorted(bad)} not paged yet"
    if cfg.moe is not None:
        return "MoE decode dispatch not paged yet"
    return None


def paged_pools_init(cfg: ModelConfig, n_phys_slots: int, dtype,
                     device: DeviceLike = None
                     ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Physical KV page pools, stacked to match params['stacks']: one
    (count, KV, n_phys_slots, head_dim) k/v pair per attention layer."""
    reason = paged_supported_reason(cfg)
    assert reason is None, reason
    dev = resolve_device(device)
    pools = []
    for spec in build_stacks(cfg):
        shape = (spec.count, cfg.n_kv_heads, n_phys_slots, cfg.head_dim)
        pools.append({f"l{j}": {"k": torch.zeros(shape, dtype=dtype,
                                                 device=dev),
                                "v": torch.zeros(shape, dtype=dtype,
                                                 device=dev)}
                      for j in range(len(spec.unit))})
    return pools


def decode_step_paged(params, cfg: ModelConfig, rt: Runtime, tokens,
                      pools, phys_idx, positions, keep_rows=None,
                      p_drop: float = 0.0):
    """G tokens for every request slot through the paged KV pools.

    tokens (B, G) ids; phys_idx (B, CAP) logical->physical map; positions
    (B, G). ``keep_rows`` — optional per-stack mirror of ``pools`` with
    (count, B, H, G, CAP) bool decode-dropout keep rows per layer.
    Returns (logits (B, G, V), updates) where updates mirrors ``pools``
    with the fresh (count, B, KV, G, hd) k/v columns (written by
    ``paged_kv_write``)."""
    x = embed_inputs(params, cfg, tokens, rt)
    all_updates = []
    for si, (spec, stack_params, stack_pools) in enumerate(
            zip(build_stacks(cfg), params["stacks"], pools)):
        stack_keep = keep_rows[si] if keep_rows is not None else None
        cols: Dict[str, Dict[str, List[torch.Tensor]]] = {
            f"l{j}": {"k": [], "v": []} for j in range(len(spec.unit))}
        for pos in range(spec.count):
            for j, _ in enumerate(spec.unit):
                key = f"l{j}"
                lp = _index(stack_params[key], pos)
                h = norm_apply(lp["norm_mix"], x, cfg)
                y, k_new, v_new = attn_decode_paged(
                    lp["mix"], h, cfg, stack_pools[key]["k"][pos],
                    stack_pools[key]["v"][pos], phys_idx, positions,
                    keep=None if stack_keep is None else stack_keep[key][pos],
                    p_drop=p_drop)
                x = x + y
                h2 = norm_apply(lp["norm_ffn"], x, cfg)
                x = x + ffn_apply(lp["ffn"], h2, cfg)
                cols[key]["k"].append(k_new)
                cols[key]["v"].append(v_new)
        all_updates.append({key: {f: torch.stack(c[f]) for f in ("k", "v")}
                            for key, c in cols.items()})
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed(params, cfg, x), all_updates


def paged_kv_write(pools, updates, slots: torch.Tensor):
    """Write the fresh token columns into the physical pools at their
    per-token physical slots (B, G). Updates ``pools`` in place (the JAX
    version returns new arrays) and returns it."""
    flat = slots.reshape(-1).long()
    for stack_pools, ups in zip(pools, updates):
        for key, pool in stack_pools.items():
            u = ups[key]
            count, b, kv, g, hd = u["k"].shape
            for f in ("k", "v"):
                vals = u[f].permute(0, 2, 1, 3, 4).reshape(count, kv, b * g,
                                                           hd)
                pool[f][:, :, flat, :] = vals.to(pool[f].dtype)
    return pools
