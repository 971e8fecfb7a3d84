"""GQA attention block: projections, rope, qk-norm, the training forward
with the dropout plan (``attn_apply``), prefill with cache construction,
decode against a contiguous cache (``attn_decode``: FULL caches and LOCAL
ring caches, 16-bit or int8 with per-(token, head) scales) and decode
against a paged KV pool.

This is where the paper's topology lives: with site "qkv" the packed
dropout plane is made under the QKV projection by the fused GEMM+RNG
kernel and consumed by flash attention -- read from the plane (premask),
or re-derived from the same counters in the kernels (replay, with the
plane discarded). With site "prev_gemm" the NEXT attention layer's plane
is made under this layer's out-projection and carried to it. In fused
mode (the paper's baseline) no plane exists: the flash kernels draw the
keep bits from the counters inside attention, as the tensor-op attention
draws them inside each q-chunk.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.config.base import (
    CARRIED_DROPOUT_SITES,
    AttentionKind,
    ModelConfig,
)
from repro_torch.core import producer
from repro_torch.core.attention import _NEG, attention_xla
from repro_torch.core.overlap import DropoutPlan
from repro_torch.distributed.sharding import constrain, current_policy
from repro_torch.kernels.flash_attention import (
    flash_attention_mosaic,
    kernel_shape_unsupported_reason,
)
from repro_torch.models.layers import apply_rope, dense_init, rms_head_norm


def attn_init(gen: torch.Generator, cfg: ModelConfig,
              lead: Tuple[int, ...] = (), device=None) -> Dict[str, Any]:
    d, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "w_q": dense_init(gen, d, nq * hd, lead=lead, device=device),
        "w_k": dense_init(gen, d, nkv * hd, lead=lead, device=device),
        "w_v": dense_init(gen, d, nkv * hd, lead=lead, device=device),
        "w_o": dense_init(gen, nq * hd, d, lead=lead, device=device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros(lead + (nq * hd,), device=device)
        p["b_k"] = torch.zeros(lead + (nkv * hd,), device=device)
        p["b_v"] = torch.zeros(lead + (nkv * hd,), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), device=device)
        p["k_norm"] = torch.ones(lead + (hd,), device=device)
    return p


def _split_heads(t, b: int, s: int, n: int, hd: int, logical: str):
    """(B, S, n*hd) -> (B, S, n, hd), constrained to ("batch", None,
    ``logical``, None). Under a policy the flat projection is first put in
    that layout (its last dim split where the heads split): DTensor cannot
    view a dim split mid-head into heads."""
    policy = current_policy()
    if policy is not None and hasattr(t, "device_mesh"):
        from repro_torch.compat import P, placements
        sp = policy.spec(("batch", None, logical, None), (b, s, n, hd))
        t = t.redistribute(policy.mesh,
                           placements(P(sp[0], sp[1], sp[2]), policy.mesh))
    return constrain(t.reshape(b, s, n, hd), "batch", None, logical, None)


def _finish_qkv(p, q, k, v, b, s, cfg: ModelConfig, positions):
    """Post-GEMM half of the projection: bias, head split, qk-norm, rope.
    q/k/v arrive as (B, S, dim)."""
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = q.dtype
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)
        k = k + p["b_k"].to(dt)
        v = v + p["b_v"].to(dt)
    q = _split_heads(q, b, s, nq, hd, "heads").transpose(1, 2)
    k = _split_heads(k, b, s, nkv, hd, "kv_heads").transpose(1, 2)
    v = _split_heads(v, b, s, nkv, hd, "kv_heads").transpose(1, 2)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """x (B, S, D) -> q (B,H,S,hd), k/v (B,KV,S,hd)."""
    b, s, _ = x.shape
    dt = x.dtype
    q = x @ p["w_q"].to(dt)
    k = x @ p["w_k"].to(dt)
    v = x @ p["w_v"].to(dt)
    return _finish_qkv(p, q, k, v, b, s, cfg, positions)


def _project_qkv_fused(p, x, cfg: ModelConfig, positions, plan, layer_idx,
                       step, how, policy=None):
    """Fused QKV projection: one concatenated GEMM with this layer's packed
    dropout plane made under it (the paper's ``qkv+RNG`` site) by ``how``,
    the schedule's planned producer (shard-local under ``policy``).
    Returns (q, k, v, plane)."""
    b, s, d = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    w_qkv = torch.cat([p["w_q"].to(dt), p["w_k"].to(dt), p["w_v"].to(dt)],
                      dim=1)
    y2d, packed = producer.gemm_with_mask(
        x.reshape(b * s, d), w_qkv, plan, (b, nq, s, s), layer_idx, step,
        how=how, policy=policy)
    y = y2d.reshape(b, s, -1)
    q = y[..., :nq * hd]
    k = y[..., nq * hd:(nq + nkv) * hd]
    v = y[..., (nq + nkv) * hd:]
    q, k, v = _finish_qkv(p, q, k, v, b, s, cfg, positions)
    return q, k, v, packed


def attn_apply(p, x, cfg: ModelConfig, *, kind: AttentionKind,
               plan: Optional[DropoutPlan], layer_idx, step,
               chunk_q: int = 1024, probs_dtype=torch.float32,
               impl: str = "xla",
               mask_in=None, emit_next: bool = False, asg=None,
               policy=None):
    """Training forward of one attention layer over the full sequence;
    x (B, S, D) -> (B, S, D).

    ``asg`` -- this layer's HostAssignment from the compiled schedule --
    names the mask producer: site "xla" makes the bits with tensor ops
    next to the plain QKV projection, site "qkv" under the fused QKV
    GEMM+RNG kernel. Under a carried site (or the "standalone" bootstrap)
    ``mask_in`` carries this layer's plane, made under the previous
    attention block's host GEMM; without one (a direct call) the
    standalone producer makes the same bits here. With ``emit_next`` and
    ``asg.emit_site == "prev_gemm"`` the NEXT attention layer's plane
    (layer ``layer_idx + asg.emit_stride``) is made under this layer's
    out-projection; "ffn_up" / "ffn_down" emissions happen in the FFN half
    (models/transformer.py), so the carry passes through here. With
    ``asg.how == "replay"`` the flash kernels re-derive the bits from the
    counters and a retained qkv host's plane is discarded.
    ``impl="pallas"`` (the JAX knob's name) runs the CUDA flash kernels,
    and raises where they cannot take the call; ``"xla"`` runs the
    chunked tensor-op attention. Direct calls may omit ``asg``: a
    single-layer assignment is compiled on the spot. Under a sharding
    ``policy`` the producers run shard-local and the attention runs in a
    shard_map body over the (batch, heads) shards (``_attn_pallas_sharded``;
    the tensor-op attention where ``_pallas_ok`` refuses the mesh, as in
    JAX: heads split but kv-heads do not). Returns y, or
    (y, next plane) when ``emit_next``. A fused-mode plan makes no plane
    and takes no producer: the keep bits are drawn inside attention, by
    the flash kernels under ``impl="pallas"`` (mode "fused"; the JAX
    package's ``_pallas_ok`` sends such a layer to the tensor-op attention
    instead, ROADMAP queue 3) and per q-chunk under ``impl="xla"``."""
    b, s, _ = x.shape
    if impl == "pallas":
        reason = _flash_unsupported_reason(plan, s, cfg.head_dim, x.dtype)
        if reason is not None:
            raise NotImplementedError(f"attn_impl='pallas': {reason}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    local = cfg.local_window if kind == AttentionKind.LOCAL else 0
    overlap = plan is not None and plan.enabled and plan.overlapped
    if overlap and asg is None:
        from repro_torch.core import schedule as schedule_mod
        asg = schedule_mod.inline_assignment(cfg, plan, b, s,
                                             policy=policy, attn_impl=impl)
    site = asg.site if overlap else "xla"
    replay = overlap and asg.how == producer.HOW_REPLAY
    if replay and impl != "pallas":
        raise ValueError("a replay assignment needs the flash kernels "
                         f"(attn_impl='pallas'), got attn_impl={impl!r}")

    packed = None
    if replay:
        if site == "qkv" and asg.host_how:
            # the RNG still runs under the GEMM; its plane is discarded
            q, k, v, _discarded = _project_qkv_fused(
                p, x, cfg, positions, plan, layer_idx, step,
                how=asg.host_how, policy=policy)
        else:
            q, k, v = _project_qkv(p, x, cfg, positions)
    elif overlap and site == "qkv":
        q, k, v, packed = _project_qkv_fused(
            p, x, cfg, positions, plan, layer_idx, step, how=asg.how,
            policy=policy)
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
        if overlap and (site in CARRIED_DROPOUT_SITES
                        or site == "standalone"):
            packed = mask_in
            if packed is None:
                # bootstrap or a direct call without a carry: the
                # standalone producer makes the same bits in-layer
                packed = producer.standalone_packed_mask(
                    plan, b, cfg.n_heads, s, s, layer_idx, step,
                    use_kernel=asg.how == producer.HOW_STANDALONE,
                    policy=policy if asg.sharded else None,
                    device=x.device)
        elif overlap:
            packed = plan.precompute_mask(b, cfg.n_heads, s, s, layer_idx,
                                          step, device=x.device)

    if impl == "pallas" and _pallas_ok(policy, cfg):
        out = _attn_pallas_sharded(q, k, v, packed, plan, local, layer_idx,
                                   step, replay=replay, policy=policy)
    elif policy is not None:
        out = _attn_xla_sharded(q, k, v, packed, plan, local, layer_idx,
                                step, chunk_q, probs_dtype, policy)
    else:
        out = attention_xla(
            q, k, v, causal=True, local_window=local, plan=plan,
            layer_idx=layer_idx, step=step, packed_mask=packed,
            chunk_q=chunk_q, probs_dtype=probs_dtype)
    out = constrain(out.transpose(1, 2).reshape(b, s, -1), "batch", None,
                    "heads")
    w_o = p["w_o"].to(x.dtype)
    if emit_next and overlap and asg.emit_site == "prev_gemm":
        # the next attention layer's plane under this out-projection (the
        # paper's "previous GEMM layers" site)
        y2d, mask_next = producer.gemm_with_mask(
            out.reshape(b * s, -1), w_o, plan, (b, cfg.n_heads, s, s),
            layer_idx + asg.emit_stride, step, how=asg.emit_how,
            policy=policy)
        return y2d.reshape(b, s, -1), mask_next
    y = out @ w_o
    return (y, mask_in) if emit_next else y


def _flash_unsupported_reason(plan, s: int, head_dim: int,
                              dtype=torch.float32) -> Optional[str]:
    """Why the flash kernels cannot run this layer, None when they can.
    The CUDA kernels' own limits, where the JAX package's ``_pallas_ok``
    has its TPU grid's (s % 128), and refuses fused-mode plans, and hands
    such a layer to the tensor-op attention: in the port,
    ``attn_impl="pallas"`` always means the kernels, fused mode included
    (they draw the keep bits from the counters). The kernels make the
    32-bit scheme only: a fused plan with ``philox_bits=8`` (the XLA-only
    scheme) cannot run in them."""
    if (plan is not None and plan.enabled and not plan.overlapped
            and plan.cfg.philox_bits != 32):
        return (f"fused-mode dropout with philox_bits="
                f"{plan.cfg.philox_bits} draws the XLA-only scheme, which "
                "the flash kernels do not make")
    return kernel_shape_unsupported_reason(s, s, head_dim, dtype)


def _pallas_ok(policy, cfg: ModelConfig) -> bool:
    """The policy clause of the JAX package's ``_pallas_ok``: the flash
    kernels need shard-local full kv, so a mesh that splits the heads
    must split the kv-heads too. Its other clauses are the TPU grid's
    (``_flash_unsupported_reason`` holds the CUDA kernels' own)."""
    if policy is None:
        return True
    h_ax = policy.mesh_axes_for("heads", cfg.n_heads)
    kv_ax = policy.mesh_axes_for("kv_heads", cfg.n_kv_heads)
    return h_ax is None or kv_ax is not None


def _attn_specs(policy, q, k):
    from repro_torch.compat import P
    b_ax = policy.mesh_axes_for("batch", q.shape[0])
    qs = P(b_ax, policy.mesh_axes_for("heads", q.shape[1]), None, None)
    kvs = P(b_ax, policy.mesh_axes_for("kv_heads", k.shape[1]), None, None)
    return qs, kvs


def _attn_pallas_sharded(q, k, v, packed, plan, local, layer_idx, step,
                         replay: bool = False, policy=None):
    """The flash kernels: on one device, or under ``policy`` in a shard_map
    body over the (batch, heads) shards, each rank on its local q / k / v
    and its tile of the plane. ``replay`` selects mode "replay": the only
    dropout operand is the seed-salt word, and under a policy each rank
    folds its tile's global (b, h) offset into it
    (``producer.shard_mask_tile``), so shard-local replay is the global
    plane's slice exactly. A fused-mode plan runs mode "fused": the
    kernels take the step seed and the layer salt and draw the bits
    themselves (one device only: its counters carry no tile offset)."""
    from repro_torch.kernels.philox_common import seed_salt_smem
    p_drop = plan.cfg.p if (plan is not None and plan.enabled) else 0.0
    seed, salt = 0, 0
    if replay and p_drop > 0.0:
        mode = "replay"
    elif packed is not None and p_drop > 0.0:
        mode = "premask"
    elif p_drop > 0.0 and not plan.overlapped:
        mode = "fused"
        seed, salt = plan.step_seed(step), plan.salt(layer_idx)
    else:
        mode = "none"
    rounds = plan.cfg.philox_rounds if plan is not None else 7
    if mode == "replay":
        # the kernels take the seed-salt word's four words by value, made
        # here from the step seed and the layer salt
        seed, salt = plan.step_seed(step), plan.salt(layer_idx)
    if policy is None:
        operand = packed if mode == "premask" else None
        return flash_attention_mosaic(q, k, v, operand, True, local, p_drop,
                                      mode, seed, salt, rounds)
    if mode == "fused":
        raise NotImplementedError(
            "fused-mode dropout under a sharding policy: the flash kernels' "
            "fused draw has no tile offset (plan mode='overlap' instead)")
    from repro_torch.compat import shard_map
    bsz, n_heads, sq = q.shape[0], q.shape[1], q.shape[2]
    sk = k.shape[2]
    qs, kvs = _attn_specs(policy, q, k)
    shard = producer.shard_exec(policy, bsz, n_heads)

    def body(q_, k_, v_, m_=None):
        if mode != "replay":
            return flash_attention_mosaic(q_, k_, v_, m_, True, local,
                                          p_drop, mode, 0, 0, rounds)
        _shape, hg, off = producer.shard_mask_tile(shard, bsz, n_heads, sq,
                                                   sk)
        with _disable_current_modes():
            # a host constant of the call, also under a fake-tensor trace
            word = seed_salt_smem(seed, salt, off)
        return flash_attention_mosaic(q_, k_, v_, word, True, local, p_drop,
                                      mode, 0, 0, rounds, hg or n_heads)

    if mode == "premask":
        return shard_map(body, mesh=policy.mesh, in_specs=(qs, kvs, kvs, qs),
                         out_specs=qs)(q, k, v, packed)
    return shard_map(body, mesh=policy.mesh, in_specs=(qs, kvs, kvs),
                     out_specs=qs)(q, k, v)


def _attn_xla_sharded(q, k, v, packed, plan, local, layer_idx, step,
                      chunk_q, probs_dtype, policy):
    """The tensor-op attention under a policy, in a shard_map body over the
    batch shards (the heads stay whole: this is the path of a mesh whose
    heads split but whose kv-heads do not). The plane comes in whole and
    each rank reads its rows; a fused-mode plan's bits are made first, by
    the tensor-op producer, the same bits."""
    from repro_torch.compat import P, shard_map
    b, h, s = q.shape[0], q.shape[1], q.shape[2]
    enabled = plan is not None and plan.enabled
    if enabled and packed is None:
        from repro_torch.core import dropout_rng
        packed = dropout_rng.packed_mask(
            b, h, s, k.shape[2], plan.cfg.p, plan.step_seed(step),
            plan.salt(layer_idx), plan.cfg.philox_rounds,
            plan.cfg.philox_bits, device=q.device)
    b_ax = policy.mesh_axes_for("batch", b)
    spec = P(b_ax, None, None, None)

    def body(q_, k_, v_, m_=None):
        return attention_xla(q_, k_, v_, causal=True, local_window=local,
                             plan=plan if enabled else None,
                             layer_idx=layer_idx, step=step, packed_mask=m_,
                             chunk_q=chunk_q, probs_dtype=probs_dtype)

    if enabled:
        return shard_map(body, mesh=policy.mesh,
                         in_specs=(spec, spec, spec, spec),
                         out_specs=spec)(q, k, v, packed)
    return shard_map(body, mesh=policy.mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(q, k, v)


def attn_cache_init(cfg: ModelConfig, kind: AttentionKind, batch: int,
                    max_len: int, dtype, kv_bits: int = 16,
                    device=None) -> Dict[str, torch.Tensor]:
    """Zero cache of one attention layer. A LOCAL layer keeps a ring of
    ``min(max_len, local_window)`` slots, a FULL one ``max_len``.
    ``kv_bits=8`` stores int8 keys and values with f32 scales per (token,
    head). ``len`` is a host int32 scalar: the decode step reads the
    position on the host and never from the card."""
    size = (min(max_len, cfg.local_window)
            if kind == AttentionKind.LOCAL else max_len)
    shape = (batch, cfg.n_kv_heads, size, cfg.head_dim)
    length = torch.tensor(0, dtype=torch.int32)
    if kv_bits == 8:
        def scale():
            return torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                               device=device)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": scale(), "v_scale": scale(), "len": length}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": length}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, KV, S, D) -> (int8 values, f32 scales (B, KV, S, 1)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def attn_prefill(p, x, cfg: ModelConfig, *, kind: AttentionKind,
                 plan=None, layer_idx=0, step=0, chunk_q: int = 1024,
                 capacity: int = 0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: full-sequence attention + cache construction. ``capacity``
    reserves decode room in FULL caches (>= s + new tokens). A LOCAL
    layer attends within its window and keeps its last ``local_window``
    keys as a ring, slot = position % window (zero-padded while the prompt
    is shorter than the window)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    local = cfg.local_window if kind == AttentionKind.LOCAL else 0
    policy = current_policy()
    if policy is not None:
        out = _attn_xla_sharded(q, k, v, None, None, local, layer_idx, step,
                                chunk_q, torch.float32, policy)
    else:
        out = attention_xla(q, k, v, causal=True, local_window=local,
                            plan=None, chunk_q=chunk_q)
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = out @ p["w_o"].to(x.dtype)
    if kind == AttentionKind.LOCAL and s >= local:
        # ring layout: roll the last-w tail by s so that
        # cache[(s - w + i) % w] = key(s - w + i)
        k_cache = torch.roll(k[:, :, -local:], s % local, dims=2)
        v_cache = torch.roll(v[:, :, -local:], s % local, dims=2)
    else:
        size = local if kind == AttentionKind.LOCAL else max(capacity, s)
        pad = (0, 0, 0, size - s)
        k_cache = torch.nn.functional.pad(k, pad)
        v_cache = torch.nn.functional.pad(v, pad)
    # kv-heads on 'model' when they divide, else the cache sequence
    # (flash-decoding)
    kv_ax = ("kv_heads", None)
    if policy is not None and policy.mesh_axes_for(
            "kv_heads", cfg.n_kv_heads) is None:
        kv_ax = (None, "kv_seq")
    cache = {"k": constrain(k_cache, "batch", kv_ax[0], kv_ax[1], None),
             "v": constrain(v_cache, "batch", kv_ax[0], kv_ax[1], None),
             "len": torch.tensor(s, dtype=torch.int32)}
    return y, cache


def attn_decode(p, x1, cache, cfg: ModelConfig, *, kind: AttentionKind
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode, the cache READ-ONLY. x1 (B, 1, D).

    Returns (y, update) with update = {"k_tok", "v_tok", "len"} (and the
    int8 cache's "k_scale_tok" / "v_scale_tok"): the caller writes the
    token column into the stacked cache once for all layers
    (``models.transformer._apply_cache_updates``)."""
    b = x1.shape[0]
    pos = int(cache["len"])
    positions = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    q, k, v = _project_qkv(p, x1, cfg, positions)  # (B,H,1,hd) / (B,KV,1,hd)
    size = cache["k"].shape[2]
    out = attention_decode_appended(
        q, cache["k"], cache["v"], k, v, pos, size,
        kind == AttentionKind.LOCAL, k_scale=cache.get("k_scale"),
        v_scale=cache.get("v_scale"))
    y = out.transpose(1, 2).reshape(b, 1, -1) @ p["w_o"].to(x1.dtype)
    length = torch.tensor(pos + 1, dtype=torch.int32)
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return y, {"k_tok": kq, "v_tok": vq, "k_scale_tok": ks,
                   "v_scale_tok": vs, "len": length}
    return y, {"k_tok": k.to(cache["k"].dtype),
               "v_tok": v.to(cache["v"].dtype), "len": length}


def _decode_scores_partial(qg, k_chunk, v_chunk, slot_offset: int,
                           n_slots: int, pos: int, size: int,
                           is_local: bool, scale: float,
                           k_scale=None, v_scale=None):
    """Unnormalized partial softmax of qg (b, kv, g, d) over one cache
    chunk. A LOCAL ring's valid slots are those below min(pos, size),
    less the slot ``pos % size`` once the ring is full (its key leaves the
    window as the current token enters). Returns (m, l (b, kv, g, 1),
    num (b, kv, g, d)), f32."""
    if k_scale is not None:  # int8 cache: dequantize the tile
        k_chunk = k_chunk.to(torch.float32) * k_scale
        v_chunk = (v_chunk.to(torch.float32) * v_scale).to(qg.dtype)
    f32 = torch.float32
    scores = torch.einsum("bkgd,bksd->bkgs", qg.to(f32),
                          k_chunk.to(qg.dtype).to(f32)) * scale
    slot_ids = slot_offset + torch.arange(n_slots, device=qg.device)
    if is_local:
        valid = slot_ids < min(pos, size)
        if pos >= size:
            valid = valid & (slot_ids != pos % size)
    else:
        valid = slot_ids < pos
    scores = scores.masked_fill(~valid, _NEG)
    m = torch.amax(scores, dim=-1, keepdim=True)
    pr = torch.exp(scores - m).masked_fill(~valid, 0.0)
    l = torch.sum(pr, dim=-1, keepdim=True)
    num = torch.einsum("bkgs,bksd->bkgd", pr.to(v_chunk.dtype),
                       v_chunk).to(f32)
    return m, l, num


def attention_decode_appended(q, k_cache, v_cache, k_new, v_new, pos: int,
                              size: int, is_local: bool, k_scale=None,
                              v_scale=None, policy=None):
    """Decode attention over the read-only cache plus the current token,
    whose key and value are folded in as a virtual slot: the softmax over
    cache ++ self. q (B, H, 1, D); caches (B, KV, size, D). Under a
    sharding policy (``policy``, else the installed one) it runs in a
    shard_map body: when the cache's sequence dim is split over 'model'
    (kv-heads that do not divide it), as flash-decoding -- each rank's
    unnormalized partial softmax over its cache slice, the (m, l, num)
    triples combined with a max and two sums over the axis."""
    policy = policy if policy is not None else current_policy()
    if policy is None:
        return _decode_appended(q, k_cache, v_cache, k_new, v_new, pos,
                                size, is_local, k_scale, v_scale)
    from repro_torch.compat import P, axis_index, pmax, psum, shard_map
    b, h, kv = q.shape[0], q.shape[1], k_cache.shape[1]
    batch_ax = policy.mesh_axes_for("batch", b)
    kv_ax = policy.mesh_axes_for("kv_heads", kv)
    seq_ax = (policy.mesh_axes_for("kv_seq", size) if kv_ax is None
              else None)
    quant = k_scale is not None
    if not quant:
        # stand-in scales keep one body signature for both cache kinds
        k_scale = v_scale = torch.ones(k_cache.shape[:3] + (1,),
                                       dtype=torch.float32, device=q.device)
    if seq_ax is None:
        qs = P(batch_ax, kv_ax, None, None)

        def body(q_, kc, vc, kn, vn, ks, vs):
            return _decode_appended(q_, kc, vc, kn, vn, pos, size, is_local,
                                    ks if quant else None,
                                    vs if quant else None)

        return shard_map(body, mesh=policy.mesh,
                         in_specs=(qs,) * 7, out_specs=qs)(
            q, k_cache, v_cache, k_new, v_new, k_scale, v_scale)
    seq_name = seq_ax if isinstance(seq_ax, str) else seq_ax[0]
    rep = P(batch_ax, None, None, None)
    cache_spec = P(batch_ax, None, seq_name, None)
    d = q.shape[3]
    scale = 1.0 / (d ** 0.5)

    def fbody(q_, kc, vc, kn, vn, ks, vs):
        n_loc = kc.shape[2]
        qg = q_.reshape(q_.shape[0], kv, h // kv, d)
        m_loc, l_loc, num_loc = _decode_scores_partial(
            qg, kc, vc, axis_index(seq_name) * n_loc, n_loc, pos, size,
            is_local, scale, ks if quant else None, vs if quant else None)
        m_g = pmax(m_loc, seq_name)
        corr = torch.exp(m_loc - m_g)
        l_g = psum(l_loc * corr, seq_name)
        num_g = psum(num_loc * corr, seq_name)
        return _fold_self(q_, qg, kn, vn, m_g, l_g, num_g, scale)

    return shard_map(fbody, mesh=policy.mesh,
                     in_specs=(rep, cache_spec, cache_spec, rep, rep,
                               cache_spec, cache_spec), out_specs=rep)(
        q, k_cache, v_cache, k_new, v_new, k_scale, v_scale)


def _fold_self(q, qg, k_new, v_new, m, l, num, scale: float):
    """Fold the current token into a cache's (m, l, num): the softmax over
    cache ++ self, normalized."""
    b, h, _, d = q.shape
    f32 = torch.float32
    s_self = torch.einsum("bkgd,bkxd->bkgx", qg.to(f32),
                          k_new[:, :, 0:1].to(q.dtype).to(f32)) * scale
    m_all = torch.maximum(m, s_self)
    num = (num * torch.exp(m - m_all)
           + torch.exp(s_self - m_all) * v_new[:, :, 0:1].to(f32))
    den = l * torch.exp(m - m_all) + torch.exp(s_self - m_all)
    return (num / den).to(q.dtype).reshape(b, h, 1, d)


def _decode_appended(q, k_cache, v_cache, k_new, v_new, pos: int, size: int,
                     is_local: bool, k_scale=None, v_scale=None):
    """``attention_decode_appended`` on one device (or one rank's whole
    cache sequence)."""
    b, h, _, d = q.shape
    kv = k_cache.shape[1]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, kv, h // kv, d)
    m, l, num = _decode_scores_partial(qg, k_cache, v_cache, 0, size, pos,
                                       size, is_local, scale, k_scale,
                                       v_scale)
    return _fold_self(q, qg, k_new, v_new, m, l, num, scale)


def attn_decode_paged(p, x, cfg: ModelConfig, pool_k, pool_v, phys_idx,
                      positions, *, keep: Optional[torch.Tensor] = None,
                      p_drop: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token decode against a paged KV pool: keys/values are
    gathered through the request page table.

    x (B, G, D); pool_k/pool_v (KV, S_phys, hd); phys_idx (B, CAP) maps
    each slot's logical position to its physical pool slot; positions
    (B, G) absolute positions; keep (B, H, G, CAP) bool — optional decode
    dropout keep rows, applied after the softmax. Validity is
    k_pos <= q_pos. Returns (y (B, G, D), k_new, v_new (B, KV, G, hd));
    the caller writes the fresh columns into the pool."""
    b, g, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    kv, hd = k_new.shape[1], k_new.shape[3]
    cap = phys_idx.shape[1]
    # gather the logical view through the page table: (B, KV, CAP, hd), a
    # fresh tensor, so the G new tokens are placed at their logical
    # positions in place
    k_all = pool_k[:, phys_idx].permute(1, 0, 2, 3)
    v_all = pool_v[:, phys_idx].permute(1, 0, 2, 3)
    bi = torch.arange(b, device=x.device)[:, None]
    pos_c = positions.clamp(0, cap - 1).long()
    k_all[bi, :, pos_c, :] = k_new.transpose(1, 2).to(k_all.dtype)
    v_all[bi, :, pos_c, :] = v_new.transpose(1, 2).to(v_all.dtype)
    grp = cfg.n_heads // kv
    if grp > 1:
        k_all = torch.repeat_interleave(k_all, grp, dim=1)
        v_all = torch.repeat_interleave(v_all, grp, dim=1)
    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bhgd,bhkd->bhgk", q,
                          k_all.to(q.dtype)).to(torch.float32) * scale
    k_ids = torch.arange(cap, device=x.device).reshape(1, 1, 1, cap)
    valid = k_ids <= positions.long()[:, None, :, None]
    scores = scores.masked_fill(~valid, _NEG)
    m = torch.amax(scores, dim=-1, keepdim=True)
    pr = torch.exp(scores - m).masked_fill(~valid, 0.0)
    pr = pr / torch.sum(pr, dim=-1, keepdim=True)
    if keep is not None:
        pr = pr.masked_fill(~keep, 0.0) / (1.0 - p_drop)
    out = torch.einsum("bhgk,bhkd->bhgd", pr.to(v_all.dtype), v_all)
    y = out.transpose(1, 2).reshape(b, g, -1) @ p["w_o"].to(x.dtype)
    return y, k_new, v_new
