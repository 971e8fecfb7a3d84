"""Shared layer primitives (functional, parameters in plain dicts).

Weights keep the JAX package's layout, ``(d_in, d_out)`` used as
``x @ w``, so converted JAX parameters are a plain copy. ``lead`` prepends
stack dimensions (a scanned stack of ``count`` layers stores its weights
as one ``(count, ...)`` tensor).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.config.base import FFNKind, ModelConfig, NormKind


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, lead: Tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(0.02)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, d: Optional[int] = None,
              lead: Tuple[int, ...] = (), device=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones(lead + (d,), device=device)}
    if cfg.norm == NormKind.LAYERNORM:
        p["bias"] = torch.zeros(lead + (d,), device=device)
    return p


def norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == NormKind.LAYERNORM:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """qk-norm: RMS over head_dim. x (..., head_dim)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------
# rope
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """f32 inverse frequencies, computed in numpy exactly as the JAX
    package computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32)
                            / head_dim))


_ROPE_FREQS: dict = {}


def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` resident on ``device`` (copied there once). Made
    outside any dispatch mode, so a fake-tensor trace
    (``analysis.dataflow``) takes it as a constant and keeps nothing of
    its own here."""
    key = (head_dim, theta, device)
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        with _disable_current_modes():
            freqs = torch.from_numpy(np.asarray(
                rope_freqs(head_dim, theta), np.float32)).to(device)
        _ROPE_FREQS[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, n, S, D_head); positions (S,) or (B, S)."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        ang = (pos[:, None] * freqs[None, :])[None, None]   # (1,1,S,d/2)
    else:
        ang = (pos[:, :, None] * freqs)[:, None]            # (B,1,S,d/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    # host-made angles meet a sharded activation as replicated values
    from repro_torch.distributed.sharding import replicate_like
    sin, cos = replicate_like(sin, x), replicate_like(cos, x)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, lead: Tuple[int, ...] = (),
             device=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU):
        return {"w_gate": dense_init(gen, d, f, lead=lead, device=device),
                "w_up": dense_init(gen, d, f, lead=lead, device=device),
                "w_down": dense_init(gen, f, d, lead=lead, device=device)}
    if cfg.ffn == FFNKind.RWKV_CHANNEL:
        return {"w_key": dense_init(gen, d, f, lead=lead, device=device),
                "w_value": dense_init(gen, f, d, lead=lead, device=device),
                "w_recept": dense_init(gen, d, d, lead=lead, device=device),
                "mix_k": torch.full(lead + (d,), 0.5, device=device),
                "mix_r": torch.full(lead + (d,), 0.5, device=device)}
    return {"w_up": dense_init(gen, d, f, lead=lead, device=device),
            "w_down": dense_init(gen, f, d, lead=lead, device=device),
            "b_up": torch.zeros(lead + (f,), device=device),
            "b_down": torch.zeros(lead + (d,), device=device)}


def _ffn_act(cfg: ModelConfig):
    return (F.silu if cfg.ffn == FFNKind.SWIGLU
            else lambda t: F.gelu(t, approximate="tanh"))


def _channel_mix_inputs(p, x: torch.Tensor, shifted: torch.Tensor):
    """The RWKV channel-mix token-shift interpolations (xk, xr)."""
    if shifted is None:
        raise ValueError("the RWKV channel-mix FFN needs the token-shifted "
                         "input")
    dt = x.dtype
    xk = x + (shifted - x) * p["mix_k"].to(dt)
    xr = x + (shifted - x) * p["mix_r"].to(dt)
    return xk, xr


def _relu_sq(k: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(k.to(torch.float32))).to(k.dtype)


def _receptance(p, xr: torch.Tensor) -> torch.Tensor:
    dt = xr.dtype
    return torch.sigmoid((xr @ p["w_recept"].to(dt)).to(torch.float32)
                         ).to(dt)


def ffn_apply(p, x: torch.Tensor, cfg: ModelConfig,
              shifted: Optional[torch.Tensor] = None, host=None,
              dtype=None):
    """x (..., d_model) through the SwiGLU / GeGLU / GELU FFN, or the RWKV
    channel-mix FFN, whose ``shifted`` is the token-shifted input.

    ``host`` (a core/producer.FFNHost) asks this FFN to host a dropout
    mask producer under one of its GEMMs: "ffn_up" under the gate+up
    projection (one concatenated GEMM for gated FFNs, the block's largest;
    the key projection of channel-mix), "ffn_down" under the down (value)
    projection. With a host the return value is (y, packed plane); the bits
    are those of every other producer site.

    ``dtype`` is the compute dtype where ``x`` comes in f32 (a norm's output
    before its rounding, ``models.transformer._residual_norm``): the gate
    and up GEMMs then cast their operands each on its own, so their
    cotangents meet in f32, unrounded, as they do in the JAX package's
    compiled block. The value is the same as with ``x`` rounded first."""
    dt = dtype or x.dtype
    if host is not None:
        return _ffn_apply_hosted(p, x, cfg, host, shifted, dt)
    if cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU):
        g = x.to(dt) @ p["w_gate"].to(dt)
        u = x.to(dt) @ p["w_up"].to(dt)
        act = _ffn_act(cfg)(g.to(torch.float32))
        return (act.to(dt) * u) @ p["w_down"].to(dt)
    x = x.to(dt)
    if cfg.ffn == FFNKind.RWKV_CHANNEL:
        xk, xr = _channel_mix_inputs(p, x, shifted)
        k = _relu_sq(xk @ p["w_key"].to(dt))
        return _receptance(p, xr) * (k @ p["w_value"].to(dt))
    h = x @ p["w_up"].to(dt) + p["b_up"].to(dt)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


def _ffn_apply_hosted(p, x: torch.Tensor, cfg: ModelConfig, host,
                      shifted: Optional[torch.Tensor], dt):
    """The FFN with the mask producer hosted under its up or down GEMM
    (producer.gemm_with_mask, the schedule's planned ``host.how``). RWKV
    channel-mix hosts through the grouped kernel as its E=1 case ("ffn_up"
    = the key projection, "ffn_down" = the value projection) when the
    schedule planned it; otherwise the standalone producer keeps the carry
    alive -- same bits either way. Returns (y, packed plane)."""
    from repro_torch.core import producer
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])

    def host_gemm(a2d, w):
        return producer.gemm_with_mask(
            a2d, w.to(dt), host.plan, host.mask_shape, host.layer_idx,
            host.step, how=host.how, policy=host.policy)

    if cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU):
        act = _ffn_act(cfg)
        f = p["w_gate"].shape[1]
        if host.site == "ffn_up":
            # one concatenated gate+up GEMM: the block's largest host
            w_gu = torch.cat([p["w_gate"], p["w_up"]], dim=1)
            gu, mask = host_gemm(x2d.to(dt), w_gu)
            g, u = gu[:, :f], gu[:, f:]
            h = act(g.to(torch.float32)).to(dt) * u
            y2d = h @ p["w_down"].to(dt)
        else:
            g = x2d.to(dt) @ p["w_gate"].to(dt)
            u = x2d.to(dt) @ p["w_up"].to(dt)
            h = act(g.to(torch.float32)).to(dt) * u
            y2d, mask = host_gemm(h, p["w_down"])
        return y2d.reshape(*lead, -1), mask
    x, x2d = x.to(dt), x2d.to(dt)
    if cfg.ffn == FFNKind.GELU:
        if host.site == "ffn_up":
            h2d, mask = host_gemm(x2d, p["w_up"])
            h = h2d + p["b_up"].to(dt)
            h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
            y2d = h @ p["w_down"].to(dt)
        else:
            h = x2d @ p["w_up"].to(dt) + p["b_up"].to(dt)
            h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
            y2d, mask = host_gemm(h, p["w_down"])
        return (y2d + p["b_down"].to(dt)).reshape(*lead, -1), mask
    if (cfg.ffn == FFNKind.RWKV_CHANNEL
            and host.how == producer.HOW_GEMM_GROUPED):
        # the key / value GEMM's grid walks the mask blocks as an expert
        # grid of one would
        xk, xr = _channel_mix_inputs(p, x, shifted)
        f = p["w_key"].shape[1]

        def grouped(a2d, w):
            y3, mask = producer.grouped_gemm_with_mask(
                a2d[None], w.to(dt)[None], host.plan, host.mask_shape,
                host.layer_idx, host.step, how=host.how, policy=host.policy)
            return y3[0], mask

        xk2d = xk.reshape(-1, xk.shape[-1])
        if host.site == "ffn_up":
            k2d, mask = grouped(xk2d, p["w_key"])
        else:
            k2d = xk2d @ p["w_key"].to(dt)
        k = _relu_sq(k2d).reshape(*lead, f)
        r = _receptance(p, xr)
        if host.site == "ffn_down":
            v2d, mask = grouped(k.reshape(-1, f), p["w_value"])
            v = v2d.reshape(*lead, -1)
        else:
            v = k @ p["w_value"].to(dt)
        return r * v, mask
    # no hostable GEMM under the planned producer: the standalone producer
    # keeps the carry alive, same bits
    b, h_, sq, sk = host.mask_shape
    mask = producer.standalone_packed_mask(
        host.plan, b, h_, sq, sk, host.layer_idx, host.step,
        use_kernel=host.how == producer.HOW_STANDALONE, policy=host.policy,
        device=x.device)
    return ffn_apply(p, x, cfg, shifted=shifted), mask


# --------------------------------------------------------------------------
# token shift (RWKV)
# --------------------------------------------------------------------------

def token_shift(x: torch.Tensor,
                last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one: out[t] = x[t-1]; out[0] = last or
    0. x (B, S, D); last (B, D)."""
    if x.shape[1] == 1:
        return (torch.zeros_like(x[:, :1]) if last is None
                else last[:, None, :].to(x.dtype))
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if last is not None:
        shifted = torch.cat([last[:, None, :].to(x.dtype), shifted[:, 1:]],
                            dim=1)
    return shifted
