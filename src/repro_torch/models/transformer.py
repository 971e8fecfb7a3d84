"""Model assembly: stacks of layer units, init, the training forward
(dense, MoE, RWKV-hybrid and Griffin stacks of full-attention, local-
attention, WKV and RG-LRU layers), serving through contiguous caches for
every layer kind (``cache_init``, ``prefill``, ``decode_step``), and decode
through paged KV pools (dense full-attention stacks).

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

from repro_torch.config.base import AttentionKind, FFNKind, ModelConfig
from repro_torch.core.overlap import DropoutPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import constrain, use_policy
from repro_torch.models.attention import (
    attn_apply,
    attn_cache_init,
    attn_decode,
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
    token_shift,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rglru import (
    rglru_apply,
    rglru_cache_init,
    rglru_decode,
    rglru_init,
    rglru_prefill,
)
from repro_torch.models.rwkv import (
    rwkv_apply,
    rwkv_cache_init,
    rwkv_decode,
    rwkv_init,
    rwkv_prefill,
)


@dataclasses.dataclass
class Runtime:
    """Per-call execution context threaded through the model.

    ``step`` is a host int: the plan folds it into the Philox key on the
    host, so no layer reads a value back from the card. ``schedule`` is
    the compiled DropoutSchedule; when None and a plan is set, ``forward``
    compiles one from the plan's site sugar. ``attn_impl="pallas"`` runs
    the CUDA flash kernels. ``probs_dtype`` is the tensor-op attention's
    probability dtype (bf16 for ``attn_probs_bf16``). ``policy`` is the
    ShardingPolicy the call runs under: the parameters and inputs are then
    DTensors on its mesh, the producers and kernels run shard-local."""
    plan: Optional[DropoutPlan] = None
    step: int = 0
    compute_dtype: Any = torch.float32
    probs_dtype: Any = torch.float32
    chunk_q: int = 1024
    remat: str = "none"            # none | block
    attn_impl: str = "xla"         # xla | pallas
    schedule: Optional[Any] = None
    policy: Optional[Any] = None
    moe_seq_dispatch: bool = False


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
    p = {"norm_mix": norm_init(cfg, lead=lead, device=device),
         "norm_ffn": norm_init(cfg, lead=lead, device=device)}
    if kind in (AttentionKind.FULL, AttentionKind.LOCAL):
        p["mix"] = attn_init(gen, cfg, lead=lead, device=device)
    elif kind == AttentionKind.RECURRENT:
        p["mix"] = rglru_init(gen, cfg, lead=lead, device=device)
    else:
        p["mix"] = rwkv_init(gen, cfg, lead=lead, device=device)
    if tag == "moe":
        m = cfg.moe
        p["moe"] = moe_init(gen, cfg, lead=lead, device=device)
        if m.n_shared_experts:
            p["shared"] = ffn_init(gen, cfg,
                                   d_ff=m.n_shared_experts * m.d_ff_expert,
                                   lead=lead, device=device)
        if m.dense_residual:
            p["dense_res"] = ffn_init(
                gen, cfg, d_ff=m.dense_residual_ff or m.d_ff_expert,
                lead=lead, device=device)
    else:
        p["ffn"] = ffn_init(gen, cfg, lead=lead, device=device)
    return p


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

def _lookup(ids: torch.Tensor, table: torch.Tensor, policy):
    """Embedding rows of ``ids``. Under a policy the lookup runs in a
    shard_map body over the batch shards and, where the table's vocab dim
    is split, vocab-parallel: each rank looks up the ids in its slice of
    the vocab, zeros the others, and the rows are summed over the vocab
    axes (one non-zero a row: exact). DTensor's own embedding strategy
    shards the table over any free axis and leaves a masked partial whose
    backward it cannot redistribute."""
    if policy is None:
        return F.embedding(ids, table)
    from repro_torch.compat import P, axis_index, psum, shard_map
    b_ax = policy.mesh_axes_for("batch", ids.shape[0])
    v_ax = _vocab_axes(policy, table.shape[0], b_ax)
    rest = (None,) * (ids.ndim - 1)

    def body(ids_, tab_):
        if v_ax is None:
            return F.embedding(ids_, tab_)
        local = ids_ - axis_index(v_ax) * tab_.shape[0]
        inside = (local >= 0) & (local < tab_.shape[0])
        rows = F.embedding(torch.where(inside, local, 0), tab_)
        return psum(rows * inside[..., None].to(rows.dtype), v_ax)

    return shard_map(body, mesh=policy.mesh,
                     in_specs=(P(b_ax, *rest), P(v_ax, None)),
                     out_specs=P(b_ax, *rest, None))(ids, table)


def _vocab_axes(policy, vocab: int, b_ax):
    """The mesh axes a vocab dim splits over beside the batch's, or None."""
    v = policy.mesh_axes_for("vocab", vocab)
    b = set(() if b_ax is None else (b_ax,) if isinstance(b_ax, str)
            else b_ax)
    v = tuple(a for a in ((v,) if isinstance(v, str) else (v or ()))
              if a not in b)
    return None if not v else (v[0] if len(v) == 1 else v)


def embed_inputs(params, cfg: ModelConfig, inputs: torch.Tensor,
                 rt: Runtime) -> torch.Tensor:
    if cfg.frontend == "token":
        # F.embedding's backward sums rows without atomics: bitwise
        # reproducible on the card
        x = _lookup(inputs.long(), params["embed"], rt.policy)
    else:
        x = inputs                                  # precomputed embeddings
    x = x.to(rt.compute_dtype)
    return constrain(x, "batch", "seq", "embed") if x.ndim == 3 else x


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return constrain(x.to(torch.float32) @ w.to(torch.float32), "batch",
                     None, "vocab")


# --------------------------------------------------------------------------
# block forward (training)
# --------------------------------------------------------------------------

def _mix_forward(p, x, cfg: ModelConfig, rt: Runtime, kind, layer_idx,
                 mask_in=None, emit_next: bool = False, asg=None):
    """Returns (y, next plane or None). LOCAL layers run attention with
    their window (``attn_apply`` reads it from ``kind``); recurrent and WKV
    mixers take no plane (``block_apply`` carries it past them)."""
    if kind == AttentionKind.WKV:
        return rwkv_apply(p, x, cfg), None
    if kind == AttentionKind.RECURRENT:
        return rglru_apply(p, x, cfg), None
    y = attn_apply(p, x, cfg, kind=kind, plan=rt.plan, layer_idx=layer_idx,
                   step=rt.step, chunk_q=rt.chunk_q,
                   probs_dtype=rt.probs_dtype,
                   impl=rt.attn_impl, mask_in=mask_in, emit_next=emit_next,
                   asg=asg, policy=rt.policy)
    return y if emit_next else (y, None)


def _ffn_forward(p, x, cfg: ModelConfig, rt: Runtime, tag, layer_idx=0,
                 asg=None, mask_shape=None, dtype=None):
    """Returns (y, aux loss or None, next plane or None). When the schedule
    gives this block an FFN emission (asg.emit_site "ffn_up" /
    "ffn_down"), the FFN hosts the NEXT attention layer's mask producer
    under one of its GEMMs: the dense fused kernel, or the grouped kernel
    for MoE expert and RWKV channel-mix FFNs; a block whose grouped shape
    cannot host was planned standalone (or tensor-op), and that producer
    keeps the carry alive -- the same bits. ``dtype`` as in ``ffn_apply``:
    the compute dtype when ``x`` is the f32 norm output of a model without
    MoE layers, which each GEMM then casts on its own."""
    from repro_torch.core import producer
    dt = dtype or x.dtype
    if cfg.ffn == FFNKind.RWKV_CHANNEL:
        x = x.to(dt)               # read with its shift, as one operand
    mask_next = None
    host = None
    if (asg is not None and mask_shape is not None
            and asg.emit_site in ("ffn_up", "ffn_down")):
        host = producer.FFNHost(
            plan=rt.plan, site=asg.emit_site, mask_shape=mask_shape,
            layer_idx=layer_idx + asg.emit_stride, step=rt.step,
            how=asg.emit_how, policy=rt.policy)
    if tag == "moe":
        if host is not None and host.how == producer.HOW_GEMM_GROUPED:
            y, aux, mask_next = moe_apply(p["moe"], x, cfg, rt.policy,
                                          seq_dispatch=rt.moe_seq_dispatch,
                                          host=host)
        else:
            y, aux = moe_apply(p["moe"], x, cfg, rt.policy,
                               seq_dispatch=rt.moe_seq_dispatch)
            if host is not None:
                b, h_, sq, sk = mask_shape
                mask_next = producer.standalone_packed_mask(
                    rt.plan, b, h_, sq, sk, host.layer_idx, rt.step,
                    use_kernel=host.how == producer.HOW_STANDALONE,
                    policy=rt.policy, device=x.device)
        if "shared" in p:
            y = y + ffn_apply(p["shared"], x, cfg)
        if "dense_res" in p:
            y = y + ffn_apply(p["dense_res"], x, cfg)
        return y, aux, mask_next
    shifted = token_shift(x) if cfg.ffn == FFNKind.RWKV_CHANNEL else None
    if host is not None:
        y, mask_next = ffn_apply(p["ffn"], x, cfg, shifted=shifted,
                                 host=host, dtype=dt)
        return y, None, mask_next
    return ffn_apply(p["ffn"], x, cfg, shifted=shifted, dtype=dt), None, None


def _residual_norm(p_norm, x: torch.Tensor, y: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + y rounded to x's dtype, norm(x + y) in f32). The residual
    stream keeps the rounded sum; the norm reads the sum before that
    rounding and its output stays f32 until each FFN GEMM casts its own
    operand (``ffn_apply(dtype=)``). That is the JAX package's block as
    XLA compiles it: its excess precision keeps the f32 add that feeds the
    norm's upcast, and the f32 sum of the GEMMs' cotangents that feeds the
    norm's backward, dropping the source's bf16 round trips. At f32 this
    is the plain x + y and norm(x + y), bitwise. Models without MoE layers
    only (``block_apply``)."""
    s = x.to(torch.float32) + y.to(torch.float32)
    return s.to(x.dtype), norm_apply(p_norm, s, cfg)


def block_apply(p, x, cfg: ModelConfig, rt: Runtime, kind, tag, layer_idx,
                asg=None, mask_in=None, emit: bool = False, x32=None):
    """One pre-norm block: x + mix(norm(x)), then + ffn(norm(x)). Returns
    (x, aux loss or None, next plane or None, the unrounded f32 output or
    None). ``x32`` is the previous block's unrounded f32 output inside one
    stack unit: the first norm reads it, as JAX's compiled scan body does
    between the blocks of a unit (the residual ``x`` stays rounded; across
    units the scan carry rounds it; models without MoE layers only, and at
    f32 it is ``x`` itself). ``asg`` is the block's
    HostAssignment from the compiled schedule; with ``emit`` (a
    carried-site schedule) the block consumes ``mask_in`` and emits the
    next attention layer's plane under its out-projection ("prev_gemm") or
    FFN GEMM ("ffn_up" / "ffn_down"). Mixer-only blocks (RWKV time-mix,
    Griffin's RG-LRU) pass the carry through untouched: the plane the last
    attention block emitted (for layer ``layer_idx + asg.emit_stride``, the
    next attention layer) rides past them."""
    is_attn = kind in (AttentionKind.FULL, AttentionKind.LOCAL)
    ffn_hosts = (emit and is_attn and asg is not None
                 and asg.emit_site in ("ffn_up", "ffn_down"))
    h = (norm_apply(p["norm_mix"], x, cfg) if x32 is None
         else norm_apply(p["norm_mix"], x32, cfg).to(x.dtype))
    y, mask_next = _mix_forward(
        p["mix"], h, cfg, rt, kind, layer_idx, mask_in=mask_in,
        emit_next=emit and is_attn and not ffn_hosts, asg=asg)
    if cfg.moe is None:
        x, h2 = _residual_norm(p["norm_ffn"], x, y, cfg)
    else:
        # a model with MoE layers rounds the sum as JAX's source does, in
        # every block: the unrounded sum carries the card's one-ulp GEMM
        # differences into the routers' top-k, and its bf16 runs on the
        # card leave the CPU's (scripts/probe_bf16_card_vs_cpu.py); in its
        # dense blocks alone the unrounded sum moves its routers off JAX's
        x = x + y
        h2 = norm_apply(p["norm_ffn"], x, cfg)
    if ffn_hosts:
        b, s = x.shape[0], x.shape[1]
        f, aux, mask_next = _ffn_forward(
            p, h2, cfg, rt, tag, layer_idx=layer_idx, asg=asg,
            mask_shape=(b, cfg.n_heads, s, s), dtype=x.dtype)
    else:
        f, aux, _ = _ffn_forward(p, h2, cfg, rt, tag, dtype=x.dtype)
    if emit and not is_attn:
        mask_next = mask_in        # the carry rides through mixer-only blocks
    if mask_next is not None and asg is not None:
        from repro_torch.core import producer
        if asg.how == producer.HOW_REPLAY:
            # replay-planned consumers never read a plane: a retained
            # GEMM-hosted emission ran for the RNG-under-GEMM overlap only
            mask_next = None
    if cfg.moe is not None:
        return x + f, aux, mask_next, None
    out32 = x.to(torch.float32) + f.to(torch.float32)
    return out32.to(x.dtype), aux, mask_next, out32


def _add_aux(total, aux):
    """Sum of aux losses, None standing for 0."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def forward(params, cfg: ModelConfig, rt: Runtime, inputs
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / eval forward (``_forward``) under ``rt.policy``: its
    ``constrain`` annotations pin the layouts there, and are no-ops
    without one."""
    with use_policy(rt.policy):
        return _forward(params, cfg, rt, inputs)


def _forward(params, cfg: ModelConfig, rt: Runtime, inputs
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / eval forward. inputs: tokens (B, S) or embeddings
    (B, S, D). Returns (logits f32 (B, S, V), aux loss: the MoE layers'
    router loss, summed).

    Mask production follows the compiled DropoutSchedule (rt.schedule, or
    compiled here from the plan). With a carried site ("prev_gemm" /
    "ffn_up" / "ffn_down") the layer loop also carries a packed plane: the
    next attention layer's mask is made under the current block's
    out-projection or FFN up / down GEMM, and the first consumer's comes
    from the standalone producer (the bootstrap) -- unless consumption is
    replay, which reads no plane (the GEMM-hosted emissions still run, and
    their planes are dropped). The last attention layer's emission has no
    consumer and is dropped, as in the JAX package, whose scan compiles one
    body for every layer. With remat="block" every stack unit runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward: its
    GEMM+RNG hosts and flash forward launch again there, and the keep bits
    come out the same because the counters are position-based."""
    x = embed_inputs(params, cfg, inputs, rt)
    sched = rt.schedule
    if sched is not None and (sched.batch, sched.seq) != (x.shape[0],
                                                          x.shape[1]):
        sched = None               # stale artifact: recompile for shape
    if sched is None and rt.plan is not None:
        from repro_torch.core import schedule as schedule_mod
        sched = schedule_mod.compile_schedule(
            cfg, rt.plan.cfg, x.shape[0], x.shape[1], policy=rt.policy,
            attn_impl=rt.attn_impl, moe_seq_dispatch=rt.moe_seq_dispatch)
    if (sched is not None and sched.shard.policy_installed
            and rt.policy is None):
        raise ValueError("a schedule planned for a sharded mesh runs under "
                         "its policy (Runtime.policy)")
    active = sched is not None and sched.active
    carry_mask = active and sched.carried
    mask_buf = None
    aux_total = None
    if carry_mask and not sched.replay:
        from repro_torch.core import producer
        basg = sched.for_layer(sched.first_consumer)
        b, s = x.shape[0], x.shape[1]
        mask_buf = producer.standalone_packed_mask(
            rt.plan, b, cfg.n_heads, s, s, sched.first_consumer, rt.step,
            use_kernel=basg.how == producer.HOW_STANDALONE,
            policy=rt.policy if basg.sharded else None, device=x.device)
    for spec, stack_params in zip(build_stacks(cfg), params["stacks"]):
        unit_len = len(spec.unit)
        unit_asgs = tuple(sched.for_layer(spec.base + j) if active else None
                          for j in range(unit_len))
        for pos in range(spec.count):
            up = _index(stack_params, pos)

            def unit_apply(x, mask, _up=up, _pos=pos, _spec=spec,
                           _ul=unit_len, _asgs=unit_asgs):
                aux = x32 = None
                for j, (kind, tag) in enumerate(_spec.unit):
                    x, a, mask, x32 = block_apply(
                        _up[f"l{j}"], x, cfg, rt, kind, tag,
                        _spec.base + _pos * _ul + j, asg=_asgs[j],
                        mask_in=mask, emit=carry_mask, x32=x32)
                    aux = _add_aux(aux, a)
                return x, aux, mask

            if rt.remat == "block":
                x, a, mask_buf = checkpoint(unit_apply, x, mask_buf,
                                            use_reentrant=False)
            else:
                x, a, mask_buf = unit_apply(x, mask_buf)
            aux_total = _add_aux(aux_total, a)
    x = norm_apply(params["final_norm"], x, cfg)
    if aux_total is None:          # no MoE layer: no router loss
        from repro_torch.distributed.sharding import replicate_like
        aux_total = replicate_like(
            torch.zeros((), dtype=torch.float32, device=x.device), x)
    return unembed(params, cfg, x), aux_total


# --------------------------------------------------------------------------
# caches / prefill / decode
# --------------------------------------------------------------------------
#
# A layer's cache is a dict of tensors: attention {"k", "v", "len"} (int8
# caches add "k_scale", "v_scale"), RG-LRU {"h", "conv", "len"}, WKV {"s",
# "shift_tm", "shift_cm", "len"}; a stack's caches carry a leading
# ``count`` dimension, as its parameters do. The lengths are int32 tensors
# on the host: a decode step reads its position there, never from the card.

_ATTN_KINDS = (AttentionKind.FULL, AttentionKind.LOCAL)


def _layer_cache_init(cfg, kind, batch, max_len, dtype, kv_bits, device):
    if kind in _ATTN_KINDS:
        return attn_cache_init(cfg, kind, batch, max_len, dtype, kv_bits,
                               device=device)
    if kind == AttentionKind.RECURRENT:
        return rglru_cache_init(cfg, batch, dtype, device=device)
    return rwkv_cache_init(cfg, batch, dtype, device=device)


def _stack_fields(per_pos: List[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    """One stacked cache from a layer's caches at each unit position."""
    return {f: torch.stack([c[f] for c in per_pos]) for f in per_pos[0]}


def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
               prefilled_len: int = 0, kv_bits: int = 16,
               device: DeviceLike = None) -> List[Any]:
    """Zero caches for decode on ``device`` (the card unless asked),
    stacked to match params["stacks"]. With ``prefilled_len`` > 0 the
    caches advertise that many valid positions (a decode cell built
    without a prefill)."""
    dev = resolve_device(device)
    caches = []
    for spec in build_stacks(cfg):
        unit = {}
        for j, (kind, _) in enumerate(spec.unit):
            c = _layer_cache_init(cfg, kind, batch, max_len, dtype, kv_bits,
                                  dev)
            if prefilled_len:
                c["len"] = torch.tensor(prefilled_len, dtype=torch.int32)
            unit[f"l{j}"] = _stack_fields([c] * spec.count)
        caches.append(unit)
    return caches


def _layer_prefill(p, x, cfg, rt: Runtime, kind, tag, layer_idx, capacity):
    h = norm_apply(p["norm_mix"], x, cfg)
    if kind in _ATTN_KINDS:
        y, cache = attn_prefill(p["mix"], h, cfg, kind=kind, plan=None,
                                layer_idx=layer_idx, step=rt.step,
                                chunk_q=rt.chunk_q, capacity=capacity)
    elif kind == AttentionKind.RECURRENT:
        y, cache = rglru_prefill(p["mix"], h, cfg)
    else:
        y, cache = rwkv_prefill(p["mix"], h, cfg)
    x = x + y
    h2 = norm_apply(p["norm_ffn"], x, cfg)
    if kind == AttentionKind.WKV:
        cache["shift_cm"] = h2[:, -1, :]
    f, _, _ = _ffn_forward(p, h2, cfg, rt, tag)
    return x + f, cache


def prefill(params, cfg: ModelConfig, rt: Runtime, inputs,
            capacity: int = 0, last_pos: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[Any]]:
    """``_prefill`` under ``rt.policy``."""
    with use_policy(rt.policy):
        return _prefill(params, cfg, rt, inputs, capacity, last_pos)


def _prefill(params, cfg: ModelConfig, rt: Runtime, inputs,
             capacity: int = 0, last_pos: Optional[int] = None
             ) -> Tuple[torch.Tensor, List[Any]]:
    """Returns (logits (B,1,V) at ``last_pos`` or the last position,
    caches): per stack, per unit position, the layer's cache fields
    stacked over ``count`` (FULL k / v (count,B,KV,cap,hd) with cap =
    max(capacity, S))."""
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
        caches.append({key: _stack_fields(cs)
                       for key, cs in per_layer.items()})
    x = norm_apply(params["final_norm"], x, cfg)
    x_last = x[:, -1:, :] if last_pos is None else \
        x[:, int(last_pos):int(last_pos) + 1, :]
    return unembed(params, cfg, x_last), caches


def _layer_decode(p, x1, cache, cfg, rt: Runtime, kind, tag):
    """The cache is READ-ONLY here. Returns (x, update): an attention
    layer's update is its token column ({"k_tok", "v_tok", "len"}, written
    by ``_apply_cache_updates``); a recurrent or WKV layer's is its whole
    (small) new state."""
    h = norm_apply(p["norm_mix"], x1, cfg)
    if kind in _ATTN_KINDS:
        y, update = attn_decode(p["mix"], h, cache, cfg, kind=kind)
    elif kind == AttentionKind.RECURRENT:
        y, update = rglru_decode(p["mix"], h, cache, cfg)
    else:
        y, update = rwkv_decode(p["mix"], h, cache, cfg)
    x1 = x1 + y
    h2 = norm_apply(p["norm_ffn"], x1, cfg)
    shifted_cm = None
    if kind == AttentionKind.WKV:
        shifted_cm = cache["shift_cm"]
        update = dict(update)
        update["shift_cm"] = h2[:, 0, :]
    if tag == "moe":
        f, _, _ = _ffn_forward(p, h2, cfg, rt, tag)
    else:
        sh = (shifted_cm[:, None, :].to(h2.dtype)
              if cfg.ffn == FFNKind.RWKV_CHANNEL else None)
        f = ffn_apply(p["ffn"], h2, cfg, shifted=sh)
    return x1 + f, update


def _token_column_write(cache_arr, tok, slot: int) -> None:
    """cache_arr[:, :, :, slot] = tok[:, :, :, 0], in place. A DTensor
    cache is written shard-locally (the JAX package's
    ``_token_column_write``): the column comes to the cache's layout with
    its sequence dim whole, and only the rank whose slice of a
    sequence-sharded cache holds ``slot`` writes it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache_arr, DTensor):
        cache_arr[:, :, :, slot] = tok[:, :, :, 0].to(cache_arr.dtype)
        return
    mesh = cache_arr.device_mesh
    pls = list(cache_arr.placements)
    col = tok if isinstance(tok, DTensor) else DTensor.from_local(
        tok, mesh, [Replicate()] * mesh.ndim, run_check=False)
    col = col.redistribute(mesh, [Replicate() if p == Shard(3) else p
                                  for p in pls]).to_local()
    local = cache_arr.to_local()
    seq_dims = [d for d, p in enumerate(pls) if p == Shard(3)]
    off, n_loc = 0, cache_arr.shape[3]
    if seq_dims:                  # kv_seq maps to one mesh axis
        n_loc //= mesh.size(seq_dims[0])
        off = mesh.get_local_rank(seq_dims[0]) * n_loc
    if off <= slot < off + n_loc:
        local[:, :, :, slot - off] = col[:, :, :, 0].to(local.dtype)


def _apply_cache_updates(spec: StackSpec, stack_cache, updates):
    """Merge a stack's per-layer decode updates into its caches: one
    token-column write for each attention cache and field, in place, at
    slot ``pos % size`` for a LOCAL ring and ``pos`` for FULL (O(layers x
    token) writes, not O(cache)); a recurrent / WKV layer's new state
    replaces its old. Returns the stack's caches."""
    new_stack = {}
    for j, (kind, _) in enumerate(spec.unit):
        key = f"l{j}"
        cache, upd = stack_cache[key], _stack_fields(updates[key])
        if kind not in _ATTN_KINDS:
            new_stack[key] = upd                 # the full small state
            continue
        size = cache["k"].shape[3]               # (count, B, KV, size, D)
        pos = int(cache["len"][0])               # equal across the stack
        slot = pos % size if kind == AttentionKind.LOCAL else pos
        for f in ("k", "v", "k_scale", "v_scale"):
            if f in cache:
                _token_column_write(cache[f], upd[f + "_tok"], slot)
        cache["len"] = upd["len"]
        new_stack[key] = cache
    return new_stack


def decode_step(params, cfg: ModelConfig, rt: Runtime, inputs, caches
                ) -> Tuple[torch.Tensor, List[Any]]:
    """``_decode_step`` under ``rt.policy``."""
    with use_policy(rt.policy):
        return _decode_step(params, cfg, rt, inputs, caches)


def _decode_step(params, cfg: ModelConfig, rt: Runtime, inputs, caches
                 ) -> Tuple[torch.Tensor, List[Any]]:
    """One token for every sequence. inputs (B, 1) tokens or (B, 1, D)
    embeddings. Returns (logits (B, 1, V), the caches): the attention
    caches take the token column in place (the JAX version returns new
    arrays), so the caller reads only the returned caches afterwards."""
    x = embed_inputs(params, cfg, inputs, rt)
    new_caches = []
    for spec, stack_params, stack_cache in zip(
            build_stacks(cfg), params["stacks"], caches):
        updates: Dict[str, List[Dict[str, torch.Tensor]]] = {
            f"l{j}": [] for j in range(len(spec.unit))}
        for pos in range(spec.count):
            for j, (kind, tag) in enumerate(spec.unit):
                key = f"l{j}"
                x, u = _layer_decode(_index(stack_params[key], pos), x,
                                     _index(stack_cache[key], pos), cfg, rt,
                                     kind, tag)
                updates[key].append(u)
        new_caches.append(_apply_cache_updates(spec, stack_cache, updates))
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed(params, cfg, x), new_caches


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
