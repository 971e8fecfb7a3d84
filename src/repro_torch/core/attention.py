"""Attention cores.

``attention_xla`` — q-chunked attention in plain tensor ops (memory
    O(chunk * SK)); the prefill path and the training path under
    ``attn_impl="xla"``. In overlap mode it consumes packed keep bits made
    by a producer; in fused mode (the paper's baseline) each chunk draws
    its own keep bits (``DropoutPlan.chunk_keep_mask``): the same counters,
    so the same bits.
``attention_decode`` — one query token against a KV cache of which the
    first ``cache_len`` entries are valid (no dropout at inference).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dropout_rng
from repro_torch.core.overlap import DropoutPlan
from repro_torch.distributed.sharding import constrain, replicate_like

_NEG = -1e30


def _chunk_attend(qc, k, v, q_start, sk, causal, local_window, scale,
                  keep_mask, dropout_p, probs_dtype=torch.float32):
    """One q-chunk: qc (B,H,cq,D) vs k,v (B,H,SK,D) (kv pre-repeated).
    Query row i sits at position q_start + i, keys at 0..SK-1. The scores
    are f32 sums of the inputs' products (JAX's preferred_element_type);
    the probabilities are cast to ``probs_dtype`` after the softmax and
    dropped and rescaled in it, as the JAX package does for
    ``attn_probs_bf16``."""
    f32 = torch.float32
    scores = torch.einsum("bhqd,bhkd->bhqk", qc.to(f32), k.to(f32)) * scale
    cq = qc.shape[2]
    if causal or local_window:
        dev = qc.device
        q_pos = q_start + torch.arange(cq, device=dev).reshape(cq, 1)
        k_pos = torch.arange(sk, device=dev).reshape(1, sk)
        valid = None
        if causal:
            valid = k_pos <= q_pos
        if local_window:
            local_ok = k_pos > q_pos - local_window
            valid = local_ok if valid is None else valid & local_ok
        scores = scores.masked_fill(~valid, _NEG)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = (p / denom).to(probs_dtype)
    if keep_mask is not None:
        p = p.masked_fill(~keep_mask, 0.0) / torch.tensor(1.0 - dropout_p,
                                                          dtype=probs_dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, local_window: int = 0,
                  plan: Optional[DropoutPlan] = None,
                  layer_idx=0, step=0,
                  packed_mask: Optional[torch.Tensor] = None,
                  chunk_q: int = 1024,
                  scale: Optional[float] = None,
                  probs_dtype=torch.float32) -> torch.Tensor:
    """q (B,H,SQ,D); k,v (B,KV,SK,D); H % KV == 0. Returns (B,H,SQ,D).

    With an enabled ``plan``, ``packed_mask`` carries the producer's
    packed keep bits (overlap mode); without one (fused mode) the bits
    are drawn inside each chunk, a padded last chunk's rows included."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dropped = plan is not None and plan.enabled
    p_drop = plan.cfg.p if dropped else 0.0
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=1)
        v = torch.repeat_interleave(v, g, dim=1)
    cq = min(chunk_q, sq)
    pad = (-sq) % cq
    if pad:
        # padded query rows produce garbage rows that are sliced off below
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        if dropped and packed_mask is not None:
            # keep the last chunk's mask rows aligned with its queries
            packed_mask = torch.nn.functional.pad(packed_mask,
                                                  (0, 0, 0, pad // 32))
    n_chunks = (sq + pad) // cq
    outs = []
    for ci in range(n_chunks):
        q_start = ci * cq
        qc = q[:, :, q_start:q_start + cq]
        keep = None
        if dropped and packed_mask is not None:
            pm = packed_mask[:, :, ci * (cq // 32):(ci + 1) * (cq // 32)]
            keep = dropout_rng.unpack_block(pm, cq)
        elif dropped:
            keep = plan.chunk_keep_mask(b, h, q_start, cq, sk, layer_idx,
                                        step, device=q.device)
        outs.append(_chunk_attend(qc, k, v, q_start, sk, causal,
                                  local_window, scale, keep, p_drop,
                                  probs_dtype))
    out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=2)
    return out[:, :, :sq] if pad else out


def attention_decode(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     local_window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode: q1 (B, H, 1, D) against caches (B, KV, S, D) of
    which ``cache_len`` entries are valid (the last ``local_window`` of
    them, when given). The scores sum in f32; the probabilities are cast
    to the cache's dtype for the value product, as in the JAX package.
    Under a sharding policy the caches may be DTensors with the sequence
    dim sharded ("kv_seq"): the softmax reductions then become small
    collectives (flash-decoding), as GSPMD makes them in JAX."""
    b, h, _, d = q1.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    qg = q1.reshape(b, kv, h // kv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.to(f32),
                          k_cache.to(f32)) * scale
    pos = torch.arange(s, device=q1.device)
    valid = pos < cache_len
    if local_window:
        valid = valid & (pos >= cache_len - local_window)
    scores = scores.masked_fill(~replicate_like(valid, scores), _NEG)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype), v_cache)
    out = constrain(out, "batch", "kv_heads", None, None)
    return out.reshape(b, h, 1, d)
