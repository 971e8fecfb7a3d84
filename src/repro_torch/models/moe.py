"""Mixture-of-Experts FFN: capacity-based top-k routing (GShard) with
per-source capacity C = ceil(T * k * cf / E), position-in-expert by a
cumulative count over (token, slot) order, overflow dropped -- the JAX
package's ``models/moe.py``.

Under a sharding policy ``moe_apply`` runs one of JAX's three dispatch
bodies in a shard_map over the mesh: ``_dispatch_combine`` (experts on
'data' -- EP groups are DP groups -- with all_to_all dispatch and
combine, each expert's hidden dim on 'model' with a psum after the down
projection), ``_dispatch_combine_dedup`` (tokens already split over
'model': one all-gather of the expert inputs and a reduce-scatter of the
outputs) and ``_dispatch_combine_ep_model`` (experts on 'model', their
weights FSDP'd over 'data'). Without a policy the first runs without its
collectives. Shared experts (DeepSeek) and the Arctic dense residual run
as ordinary dense FFNs in ``models/transformer.py``.

With a grouped ``FFNHost`` the gate (site "ffn_up") or down (site
"ffn_down") expert einsum runs through the grouped GEMM+RNG kernel and the
next attention layer's packed plane comes back with the output. The
emission indexes the (b, h, q, k) Philox counter space, never token
identity, so routing, capacity overflow and the expert permutation cannot
reach the bits. Under a policy the emission runs in the dispatch body
itself, each rank its (b_loc, h_loc) tile of the plane.

On the card the dispatch scatter (``index_add``) and the combine gather's
backward (``index_select``'s, an ``index_add`` too) accumulate with
atomics. Every kept destination row receives exactly one non-zero
contribution (dropped slots add zeros to row 0), so the sums are exact in
any order and a step is bitwise reproducible.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import (P, all_gather, all_to_all, placements,
                                pmean, psum, psum_scatter, shard_map)
from repro_torch.config.base import ModelConfig, MoEConfig
from repro_torch.core.producer import (grouped_einsum, grouped_gemm_seeded,
                                       moe_expert_capacity, shard_exec,
                                       shard_mask_tile)
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class _GroupedHostCtx:
    """Which expert GEMM hosts the dropout-mask producer (site "ffn_up" =
    the gate projection, "ffn_down" = the down projection), the mask
    shape (B, H, SQ, SK), the schedule's planned producer ``how`` and the
    shard-local context (``producer.ShardExec``, None on one device or when
    no mesh axis splits the plane); the step seed and layer salt ride in
    beside it."""
    plan: Any
    site: str
    mask_shape: Tuple[int, int, int, int]
    how: str
    shard: Any = None


def _expert_ffn(recv, w_gate, w_up, w_down, dt,
                hs: Optional[_GroupedHostCtx] = None, seed=None, salt=None):
    """The expert SwiGLU einsums on recv (E, C, D). With ``hs`` the gate
    ("ffn_up") or down ("ffn_down") product runs through the grouped
    GEMM+RNG producer and the packed plane comes back with the output.
    Inside a dispatch body the plane is this rank's tile. Returns (out (E,
    C, D), plane or None)."""
    mask = None
    tile = None
    if hs is not None:
        local_shape, hg, off = shard_mask_tile(hs.shard, *hs.mask_shape)
        tile = dict(heads_global=hg, bh_offset=off)
    if hs is not None and hs.site == "ffn_up":
        h_g, mask = grouped_gemm_seeded(
            recv, w_gate.to(dt), hs.plan, local_shape, seed, salt, hs.how,
            **tile)
    else:
        h_g = grouped_einsum(recv, w_gate.to(dt))
    h_u = grouped_einsum(recv, w_up.to(dt))
    h = F.silu(h_g.to(torch.float32)).to(dt) * h_u
    if hs is not None and hs.site == "ffn_down":
        out, mask = grouped_gemm_seeded(
            h, w_down.to(dt), hs.plan, local_shape, seed, salt, hs.how,
            **tile)
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


def _dispatch(x2d, router_w, moe: MoEConfig):
    """Route x2d (T, D) and scatter it into the (E, cap, D) send buffer.
    Returns (send, keep, dest, flat_gate, aux): the aux load-balance loss
    (GShard: E * sum_e f_e * P_e) of these tokens."""
    t, d = x2d.shape
    e = moe.n_experts
    k = moe.top_k
    probs, gate, idx = _route(x2d, router_w, moe)
    cap = moe_expert_capacity(moe, t)
    onehot, keep, dest = _destinations(idx, e, cap)
    keep_f = keep[None].to(torch.float32)
    f_e = torch.mean(onehot.to(torch.float32) * keep_f, dim=1) * k
    p_e = torch.mean(probs, dim=0)
    aux = e * torch.sum(f_e * p_e) / k
    # each token row repeated k times by a broadcast (its backward is a
    # plain sum)
    x_rep = x2d[:, None, :].expand(t, k, d).reshape(t * k, d)
    upd = torch.where(keep[:, None], x_rep, torch.zeros_like(x_rep))
    send = torch.zeros((e * cap, d), dtype=x2d.dtype, device=x2d.device)
    send = send.index_add(0, dest, upd).reshape(e, cap, d)
    return send, keep, dest, gate.reshape(t * k), aux


def _combine(back, keep, dest, flat_gate, t: int, k: int):
    """Gather each (token, slot)'s expert output from back (E, cap, D) and
    sum a token's k slots by their gates (index_select: its backward is
    the index_add the module note describes)."""
    d = back.shape[2]
    flat_out = back.reshape(-1, d).index_select(0, dest)        # (T*k, D)
    flat_out = torch.where(keep[:, None], flat_out,
                           torch.zeros_like(flat_out))
    return (flat_out.to(torch.float32) * flat_gate[:, None]).reshape(
        t, k, d).sum(dim=1).to(back.dtype)


def _dispatch_combine(x2d, router_w, w_gate, w_up, w_down, seed=None,
                      salt=None, *, moe: MoEConfig,
                      ep_axis: Optional[str] = None,
                      tp_axis: Optional[str] = None,
                      dp_axes: Tuple[str, ...] = (),
                      hs: Optional[_GroupedHostCtx] = None):
    """The dispatch body: x2d (T_loc, D), expert weights the local shards
    (E_loc, D, F_loc). Experts on ``ep_axis`` (all_to_all dispatch and
    combine), their hidden dim on ``tp_axis`` (a psum after the down
    projection); without axes, the single-device body. Returns (y (T_loc,
    D), aux loss), plus this rank's packed-plane tile when ``hs`` hosts a
    grouped emission (``seed`` / ``salt`` its counters)."""
    t = x2d.shape[0]
    dt = x2d.dtype
    send, keep, dest, flat_gate, aux = _dispatch(x2d, router_w, moe)
    # (E, cap, D) -> (E_loc, n_src * cap, D)
    recv = all_to_all(send, ep_axis, 0, 1) if ep_axis else send
    out, mask = _expert_ffn(recv, w_gate, w_up, w_down, dt, hs, seed, salt)
    if tp_axis is not None:
        out = psum(out, tp_axis)
    back = all_to_all(out, ep_axis, 1, 0) if ep_axis else out
    y = _combine(back, keep, dest, flat_gate, t, moe.top_k)
    if dp_axes:
        aux = pmean(aux, dp_axes)
    if hs is not None:
        return y, aux, mask
    return y, aux


def _dispatch_combine_dedup(x2d, router_w, w_gate, w_up, w_down, seed=None,
                            salt=None, *, moe: MoEConfig, ep_axis: str,
                            tp_axis: str, dp_axes: Tuple[str, ...],
                            hs: Optional[_GroupedHostCtx] = None):
    """Tokens arrive already split over the tp axis (the residual stream
    is sequence-sharded there), so the EP all_to_all carries each token
    once instead of once per TP shard; the TP shards then all-gather the
    expert inputs along the capacity axis and reduce-scatter the expert
    outputs back to their own token chunk."""
    t = x2d.shape[0]                       # t = T / (dp * tp)
    dt = x2d.dtype
    send, keep, dest, flat_gate, aux = _dispatch(x2d, router_w, moe)
    recv = all_to_all(send, ep_axis, 0, 1)       # (E_loc, nsrc*cap, D)
    full = all_gather(recv, tp_axis, 1)
    out, mask = _expert_ffn(full, w_gate, w_up, w_down, dt, hs, seed, salt)
    # sum the TP partials and keep only this shard's token chunk
    own = psum_scatter(out, tp_axis, 1)
    back = all_to_all(own, ep_axis, 1, 0)        # (E, cap, D)
    y = _combine(back, keep, dest, flat_gate, t, moe.top_k)
    aux = pmean(aux, dp_axes + (tp_axis,))
    if hs is not None:
        return y, aux, mask
    return y, aux


def _dispatch_combine_ep_model(x2d, router_w, w_gate, w_up, w_down,
                               seed=None, salt=None, *, moe: MoEConfig,
                               ep_axis: str, fsdp_axis: str,
                               dp_axes: Tuple[str, ...],
                               hs: Optional[_GroupedHostCtx] = None):
    """Experts on 'model' (= ``ep_axis`` here), their weights FSDP'd over
    'data' (= ``fsdp_axis``) and gathered per layer, tokens chunked over
    (data x model): the dispatch all_to_all runs over 'model' within each
    data row and no expert-input gather exists."""
    t = x2d.shape[0]                       # t = T / (dp * model)
    dt = x2d.dtype
    send, keep, dest, flat_gate, aux = _dispatch(x2d, router_w, moe)
    recv = all_to_all(send, ep_axis, 0, 1)       # (E_loc, nchunk*cap, D)
    wg = all_gather(w_gate, fsdp_axis, 1)
    wu = all_gather(w_up, fsdp_axis, 1)
    wd = all_gather(w_down, fsdp_axis, 2)
    out, mask = _expert_ffn(recv, wg, wu, wd, dt, hs, seed, salt)
    back = all_to_all(out, ep_axis, 1, 0)        # (E, cap, D)
    y = _combine(back, keep, dest, flat_gate, t, moe.top_k)
    aux = pmean(aux, dp_axes + (ep_axis,))
    if hs is not None:
        return y, aux, mask
    return y, aux


def moe_apply(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              policy=None, seq_dispatch: bool = False, host=None):
    """x (B, S, D) -> (y (B, S, D), aux scalar).

    ``host`` (a core/producer.FFNHost with a grouped ``how``) asks the
    expert FFN to host the dropout-mask producer under its gate ("ffn_up")
    or down ("ffn_down") expert einsum; the return value then grows a third
    element, the packed plane (B, H, SQ//32, SK), made shard-local in the
    same body the dispatch runs in under a ``policy``. ``seq_dispatch``
    selects the deduplicated layouts where the mesh allows them."""
    b, s, d = x.shape
    moe = cfg.moe
    # pin the boundary layout (JAX: without it GSPMD may propagate the
    # flat token sharding back through the reshape)
    x = constrain(x, "batch", "seq", "embed")
    x2d = x.reshape(b * s, d)
    hs = None
    rng = ()
    mask_spec = None
    if host is not None:
        mb, mh, _msq, _msk = host.mask_shape
        shard = shard_exec(policy, mb, mh)
        hs = _GroupedHostCtx(plan=host.plan, site=host.site,
                             mask_shape=host.mask_shape, how=host.how,
                             shard=shard)
        rng = (host.plan.step_seed(host.step),
               host.plan.salt(host.layer_idx))
        mask_spec = (P(None, None, None, None) if shard is None
                     else P(shard.b_spec, shard.h_spec, None, None))
    weights = (params["router"], params["w_gate"], params["w_up"],
               params["w_down"])
    if policy is None:
        out = _dispatch_combine(x2d, *weights, *rng, moe=moe, hs=hs)
        if hs is not None:
            y, aux, mask = out
            return y.reshape(b, s, d), aux, mask
        y, aux = out
        return y.reshape(b, s, d), aux

    names = set(policy.axis_names)
    sizes = policy.sizes
    ep = "data" if "data" in names else None
    tp = "model" if "model" in names else None
    dp = tuple(a for a in ("pod", "data") if a in names)
    # capacity / expert divisibility guards
    if ep is not None and moe.n_experts % sizes[ep] != 0:
        ep = None
    if tp is not None and moe.d_ff_expert % sizes[tp] != 0:
        tp = None
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    ew_spec = P(ep, None, tp)
    ew2_spec = P(ep, tp, None)
    rng_specs = (None, None) if hs is not None else ()

    def _run(body, tok_spec, in_specs):
        out_specs = ((tok_spec, P()) if hs is None
                     else (tok_spec, P(), mask_spec))
        out = shard_map(body, mesh=policy.mesh,
                        in_specs=in_specs + rng_specs,
                        out_specs=out_specs)(x2d, *weights, *rng)
        y2d = out[0]
        if isinstance(tok_spec[0], tuple):
            # tokens over several axes: back to the batch layout first
            # (DTensor's view of one dim split over two mesh axes into
            # (batch, seq) yields wrong local shapes)
            y2d = y2d.redistribute(policy.mesh, placements(
                P(dp_spec, None), policy.mesh))
        y = constrain(y2d.reshape(b, s, d), "batch", "seq", "embed")
        return (y,) + tuple(out[1:])

    ep_model = policy.mesh_axes_for("expert", moe.n_experts) == "model"
    if (seq_dispatch and ep_model and tp is not None
            and moe.n_experts % sizes[tp] == 0
            and (b * s) % (sizes[tp] * n_dp) == 0 and "data" in names
            and cfg.d_model % sizes["data"] == 0):
        tok_spec = P(dp + (tp,), None)
        body = functools.partial(_dispatch_combine_ep_model, moe=moe,
                                 ep_axis=tp, fsdp_axis="data", dp_axes=dp,
                                 hs=hs)
        return _run(body, tok_spec,
                    (tok_spec, P(None, None), P(tp, "data", None),
                     P(tp, "data", None), P(tp, None, "data")))
    if (seq_dispatch and not ep_model and ep is not None
            and tp is not None and (b * s) % (sizes[tp] * n_dp) == 0):
        tok_spec = P(dp + (tp,), None)
        body = functools.partial(_dispatch_combine_dedup, moe=moe,
                                 ep_axis=ep, tp_axis=tp, dp_axes=dp, hs=hs)
        return _run(body, tok_spec,
                    (tok_spec, P(None, None), ew_spec, ew_spec, ew2_spec))
    tok_spec = P(dp_spec, None)
    body = functools.partial(_dispatch_combine, moe=moe, ep_axis=ep,
                             tp_axis=tp, dp_axes=dp, hs=hs)
    return _run(body, tok_spec,
                (tok_spec, P(None, None), ew_spec, ew_spec, ew2_spec))
