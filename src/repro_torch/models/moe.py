"""Mixture-of-Experts FFN: capacity-based top-k routing (GShard) with
per-source capacity C = ceil(T * k * cf / E), position-in-expert by a
cumulative count over (token, slot) order, overflow dropped -- the JAX
package's ``models/moe.py`` on one device.

Only the single-device dispatch body (JAX's ``_dispatch_combine`` without
its collectives) is ported. The expert-parallel layouts
(``_dispatch_combine_dedup``, ``_dispatch_combine_ep_model``) are made of
all-to-all / all-gather / reduce-scatter collectives and need a mesh:
``moe_apply`` with a sharding policy raises (ROADMAP: port queue item 13,
multi-device). Shared experts (DeepSeek) and the Arctic dense residual run
as ordinary dense FFNs in ``models/transformer.py``.

With a grouped ``FFNHost`` the gate (site "ffn_up") or down (site
"ffn_down") expert einsum runs through the grouped GEMM+RNG kernel and the
next attention layer's packed plane comes back with the output. The
emission indexes the (b, h, q, k) Philox counter space, never token
identity, so routing, capacity overflow and the expert permutation cannot
reach the bits.

On the card the dispatch scatter (``index_add``) and the combine gather's
backward (``index_select``'s, an ``index_add`` too) accumulate with
atomics. Every kept destination row receives exactly one non-zero
contribution (dropped slots add zeros to row 0), so the sums are exact in
any order and a step is bitwise reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig, MoEConfig
from repro_torch.core.producer import (grouped_einsum, grouped_gemm_seeded,
                                       moe_expert_capacity)
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class _GroupedHostCtx:
    """Which expert GEMM hosts the dropout-mask producer (site "ffn_up" =
    the gate projection, "ffn_down" = the down projection), the mask
    shape (B, H, SQ, SK) and the schedule's planned producer ``how``; the
    step seed and layer salt ride in beside it."""
    plan: Any
    site: str
    mask_shape: Tuple[int, int, int, int]
    how: str


def _expert_ffn(recv, w_gate, w_up, w_down, dt,
                hs: Optional[_GroupedHostCtx] = None, seed=None, salt=None):
    """The expert SwiGLU einsums on recv (E, C, D). With ``hs`` the gate
    ("ffn_up") or down ("ffn_down") product runs through the grouped
    GEMM+RNG producer and the packed plane comes back with the output.
    Returns (out (E, C, D), plane or None)."""
    mask = None
    if hs is not None and hs.site == "ffn_up":
        h_g, mask = grouped_gemm_seeded(
            recv, w_gate.to(dt), hs.plan, hs.mask_shape, seed, salt, hs.how)
    else:
        h_g = grouped_einsum(recv, w_gate.to(dt))
    h_u = grouped_einsum(recv, w_up.to(dt))
    h = F.silu(h_g.to(torch.float32)).to(dt) * h_u
    if hs is not None and hs.site == "ffn_down":
        out, mask = grouped_gemm_seeded(
            h, w_down.to(dt), hs.plan, hs.mask_shape, seed, salt, hs.how)
    else:
        out = grouped_einsum(h, w_down.to(dt))
    return out, mask


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = (), device=None) -> Dict[str, Any]:
    """The JAX package's shapes and scales: router (D, E) at 0.02, expert
    gate / up (E, D, F) at 1/sqrt(D), down (E, F, D) at 1/sqrt(F)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts

    def normal(shape, scale):
        w = torch.randn(lead + shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(scale)

    return {
        "router": dense_init(gen, d, e, scale=0.02, lead=lead,
                             device=device),
        "w_gate": normal((e, d, f), 1.0 / np.sqrt(d)),
        "w_up": normal((e, d, f), 1.0 / np.sqrt(d)),
        "w_down": normal((e, f, d), 1.0 / np.sqrt(f)),
    }


def _route(x2d, router_w, moe: MoEConfig):
    """Top-k routing of x2d (T, D): (probs (T, E) f32, gate (T, k)
    renormalised, expert idx (T, k)). The top k are taken with JAX's tie
    rule (``jax.lax.top_k``: of equal values the lower index first), by a
    stable descending sort: at bf16 the router logits are bf16 values, so
    two experts of one token tie often, and ``torch.topk`` orders ties in
    no stated way."""
    logits = (x2d @ router_w.to(x2d.dtype)).to(torch.float32)   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :moe.top_k], idx[:, :moe.top_k]         # (T, k)
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def _destinations(idx, e: int, cap: int):
    """Each (token, slot)'s row in the (E * cap, D) expert buffer: (one-hot
    (E, T*k) int64, keep (T*k,), dest (T*k,)). The position in an expert
    is a cumulative count over (token, slot) order, the one-hot laid out
    (E, T*k) so the count runs along its inner dimension (a scatter, not
    F.one_hot, which reads the indices' range back to the host); slots past
    the capacity are dropped (dest 0, keep False)."""
    flat_idx = idx.reshape(-1)
    onehot = torch.zeros((e, flat_idx.numel()), dtype=torch.int64,
                         device=idx.device).scatter_(0, flat_idx[None], 1)
    pos = (onehot.cumsum(dim=1) - 1).gather(0, flat_idx[None])[0]
    keep = pos < cap
    dest = torch.where(keep, flat_idx * cap + pos, torch.zeros_like(pos))
    return onehot, keep, dest


def _dispatch_combine(x2d, router_w, w_gate, w_up, w_down, seed=None,
                      salt=None, *, moe: MoEConfig,
                      hs: Optional[_GroupedHostCtx] = None):
    """x2d (T, D) -> (y (T, D), aux loss), plus the packed plane when ``hs``
    hosts a grouped emission (``seed`` / ``salt`` its counters)."""
    t, d = x2d.shape
    e = moe.n_experts
    k = moe.top_k
    dt = x2d.dtype

    probs, gate, idx = _route(x2d, router_w, moe)
    cap = moe_expert_capacity(moe, t)
    flat_gate = gate.reshape(t * k)
    onehot, keep, dest = _destinations(idx, e, cap)

    # aux load-balance loss (GShard): E * sum_e f_e * P_e
    keep_f = keep[None].to(torch.float32)
    f_e = torch.mean(onehot.to(torch.float32) * keep_f, dim=1) * k
    p_e = torch.mean(probs, dim=0)
    aux = e * torch.sum(f_e * p_e) / k

    # scatter tokens into the (E * cap, D) expert buffer; each token row
    # repeated k times by a broadcast (its backward is a plain sum)
    x_rep = x2d[:, None, :].expand(t, k, d).reshape(t * k, d)
    upd = torch.where(keep[:, None], x_rep, torch.zeros_like(x_rep))
    send = torch.zeros((e * cap, d), dtype=dt, device=x2d.device)
    recv = send.index_add(0, dest, upd).reshape(e, cap, d)

    out, mask = _expert_ffn(recv, w_gate, w_up, w_down, dt, hs, seed, salt)

    # combine on the source rows (index_select: its backward is the
    # index_add the module note describes)
    flat_out = out.reshape(e * cap, d).index_select(0, dest)    # (T*k, D)
    flat_out = torch.where(keep[:, None], flat_out,
                           torch.zeros_like(flat_out))
    y = (flat_out.to(torch.float32) * flat_gate[:, None]).reshape(
        t, k, d).sum(dim=1).to(dt)
    if hs is not None:
        return y, aux, mask
    return y, aux


def moe_apply(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              policy=None, host=None):
    """x (B, S, D) -> (y (B, S, D), aux scalar).

    ``host`` (a core/producer.FFNHost with a grouped ``how``) asks the
    expert FFN to host the dropout-mask producer under its gate ("ffn_up")
    or down ("ffn_down") expert einsum; the return value then grows a third
    element, the packed plane (B, H, SQ//32, SK)."""
    if policy is not None:
        raise NotImplementedError(
            "expert-parallel MoE dispatch under a sharding policy is not "
            "ported yet (ROADMAP: port queue item 13, multi-device)")
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    hs = None
    rng = ()
    if host is not None:
        hs = _GroupedHostCtx(plan=host.plan, site=host.site,
                             mask_shape=host.mask_shape, how=host.how)
        rng = (host.plan.step_seed(host.step),
               host.plan.salt(host.layer_idx))
    out = _dispatch_combine(x2d, params["router"], params["w_gate"],
                            params["w_up"], params["w_down"], *rng,
                            moe=cfg.moe, hs=hs)
    if hs is not None:
        y, aux, mask = out
        return y.reshape(b, s, d), aux, mask
    y, aux = out
    return y.reshape(b, s, d), aux
