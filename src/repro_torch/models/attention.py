"""GQA attention block: projections, rope, qk-norm, the training forward
with the dropout plan (``attn_apply``), prefill with cache construction,
and decode against a paged KV pool.

This is where the paper's topology lives: with site "qkv" the packed
dropout plane is made under the QKV projection by the fused GEMM+RNG
kernel and consumed by flash attention -- read from the plane (premask),
or re-derived from the same counters in the kernels (replay, with the
plane discarded).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import AttentionKind, ModelConfig
from repro_torch.core import producer
from repro_torch.core.attention import _NEG, attention_xla
from repro_torch.core.overlap import DropoutPlan
from repro_torch.kernels.flash_attention import (
    flash_attention_mosaic,
    kernel_shape_unsupported_reason,
)
from repro_torch.kernels.philox_common import seed_salt_smem
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


def _finish_qkv(p, q, k, v, b, s, cfg: ModelConfig, positions):
    """Post-GEMM half of the projection: bias, head split, qk-norm, rope.
    q/k/v arrive as (B, S, dim)."""
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = q.dtype
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)
        k = k + p["b_k"].to(dt)
        v = v + p["b_v"].to(dt)
    q = q.reshape(b, s, nq, hd).transpose(1, 2)
    k = k.reshape(b, s, nkv, hd).transpose(1, 2)
    v = v.reshape(b, s, nkv, hd).transpose(1, 2)
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
                       step, how):
    """Fused QKV projection: one concatenated GEMM with this layer's packed
    dropout plane made under it (the paper's ``qkv+RNG`` site) by ``how``,
    the schedule's planned producer. Returns (q, k, v, plane)."""
    b, s, d = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    w_qkv = torch.cat([p["w_q"].to(dt), p["w_k"].to(dt), p["w_v"].to(dt)],
                      dim=1)
    y2d, packed = producer.gemm_with_mask(
        x.reshape(b * s, d), w_qkv, plan, (b, nq, s, s), layer_idx, step,
        how=how)
    y = y2d.reshape(b, s, -1)
    q = y[..., :nq * hd]
    k = y[..., nq * hd:(nq + nkv) * hd]
    v = y[..., (nq + nkv) * hd:]
    q, k, v = _finish_qkv(p, q, k, v, b, s, cfg, positions)
    return q, k, v, packed


def attn_apply(p, x, cfg: ModelConfig, *, kind: AttentionKind,
               plan: Optional[DropoutPlan], layer_idx, step,
               chunk_q: int = 1024, probs_dtype=None, impl: str = "xla",
               asg=None):
    """Training forward of one attention layer over the full sequence;
    x (B, S, D) -> (B, S, D).

    ``asg`` -- this layer's HostAssignment from the compiled schedule --
    names the mask producer: site "xla" makes the bits with tensor ops
    next to the plain QKV projection, site "qkv" under the fused QKV
    GEMM+RNG kernel. With ``asg.how == "replay"`` the flash kernels
    re-derive the bits from the counters and a retained qkv host's plane
    is discarded. ``impl="pallas"`` (the JAX knob's name) runs the CUDA
    flash kernels, and raises where they cannot take the call; ``"xla"``
    runs the chunked tensor-op attention. Direct calls may omit ``asg``: a
    single-layer assignment is compiled on the spot. Carried sites and
    sharding policies are not ported (the schedule compiler refuses
    them)."""
    b, s, _ = x.shape
    if impl == "pallas":
        reason = _flash_unsupported_reason(plan, s, cfg.head_dim)
        if reason is not None:
            raise NotImplementedError(f"attn_impl='pallas': {reason}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    local = cfg.local_window if kind == AttentionKind.LOCAL else 0
    overlap = plan is not None and plan.enabled and plan.overlapped
    if overlap and asg is None:
        from repro_torch.core import schedule as schedule_mod
        asg = schedule_mod.inline_assignment(cfg, plan, b, s,
                                             attn_impl=impl)
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
                how=asg.host_how)
        else:
            q, k, v = _project_qkv(p, x, cfg, positions)
    elif overlap and site == "qkv":
        q, k, v, packed = _project_qkv_fused(
            p, x, cfg, positions, plan, layer_idx, step, how=asg.how)
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
        if overlap:
            packed = plan.precompute_mask(b, cfg.n_heads, s, s, layer_idx,
                                          step, device=x.device)

    if impl == "pallas":
        out = _attn_pallas_sharded(
            q, k, v, packed, plan, local,
            replay_key=(layer_idx, step) if replay else None)
    else:
        out = attention_xla(
            q, k, v, causal=True, local_window=local, plan=plan,
            layer_idx=layer_idx, step=step, packed_mask=packed,
            chunk_q=chunk_q, probs_dtype=probs_dtype or torch.float32)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["w_o"].to(x.dtype)


def _flash_unsupported_reason(plan, s: int, head_dim: int) -> Optional[str]:
    """Why the flash kernels cannot run this layer, None when they can.
    The CUDA kernels' own limits, where the JAX package's ``_pallas_ok``
    has its TPU grid's (s % 128) and hands such a layer to the tensor-op
    attention: in the port, ``attn_impl="pallas"`` always means the
    kernels. Fused-mode (in-attention RNG) training is not ported on
    either attention path."""
    if plan is not None and plan.enabled and not plan.overlapped:
        return (f"dropout mode={plan.cfg.mode!r} is not ported yet "
                "(ROADMAP: port queue, fused-mode dropout)")
    return kernel_shape_unsupported_reason(s, s, head_dim)


def _attn_pallas_sharded(q, k, v, packed, plan, local, replay_key=None):
    """The flash kernels on one device (the no-policy branch of the JAX
    function). ``replay_key`` = (layer_idx, step) selects mode "replay":
    the only dropout operand is the (4,) seed-salt word."""
    p_drop = plan.cfg.p if (plan is not None and plan.enabled) else 0.0
    if replay_key is not None and p_drop > 0.0:
        mode = "replay"
    elif packed is not None and p_drop > 0.0:
        mode = "premask"
    else:
        mode = "none"
    rounds = plan.cfg.philox_rounds if plan is not None else 7
    if mode == "replay":
        layer_idx, step = replay_key
        operand = seed_salt_smem(plan.step_seed(step), plan.salt(layer_idx))
    else:
        operand = packed if mode == "premask" else None
    return flash_attention_mosaic(q, k, v, operand, True, local, p_drop,
                                  mode, 0, 0, rounds)


def attn_prefill(p, x, cfg: ModelConfig, *, kind: AttentionKind,
                 plan=None, layer_idx=0, step=0, chunk_q: int = 1024,
                 capacity: int = 0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: full-sequence attention + cache construction. ``capacity``
    reserves decode room in the cache (>= s + new tokens)."""
    if kind != AttentionKind.FULL:
        raise NotImplementedError(
            "LOCAL-attention prefill caches are not ported yet (ROADMAP: "
            "port queue, LOCAL paging)")
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attention_xla(q, k, v, causal=True, plan=None, chunk_q=chunk_q)
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = out @ p["w_o"].to(x.dtype)
    cap = max(capacity, s)
    pad = (0, 0, 0, cap - s)
    cache = {"k": torch.nn.functional.pad(k, pad),
             "v": torch.nn.functional.pad(v, pad),
             "len": torch.tensor(s, dtype=torch.int32)}
    return y, cache


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
