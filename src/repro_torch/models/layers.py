"""Shared layer primitives (functional, parameters in plain dicts).

Weights keep the JAX package's layout, ``(d_in, d_out)`` used as
``x @ w``, so converted JAX parameters are a plain copy. ``lead`` prepends
stack dimensions (a scanned stack of ``count`` layers stores its weights
as one ``(count, ...)`` tensor).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` resident on ``device`` (copied there once)."""
    return torch.from_numpy(np.asarray(rope_freqs(head_dim, theta),
                                       np.float32)).to(device)


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
    if cfg.ffn == FFNKind.GELU:
        return {"w_up": dense_init(gen, d, f, lead=lead, device=device),
                "w_down": dense_init(gen, f, d, lead=lead, device=device),
                "b_up": torch.zeros(lead + (f,), device=device),
                "b_down": torch.zeros(lead + (d,), device=device)}
    raise NotImplementedError(
        f"ffn={cfg.ffn.value!r} is not ported yet (ROADMAP: port queue, "
        "recurrent paging)")


def ffn_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (..., d_model) through the un-hosted SwiGLU / GeGLU / GELU FFN."""
    dt = x.dtype
    if cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        gf = g.to(torch.float32)
        act = (F.silu(gf) if cfg.ffn == FFNKind.SWIGLU
               else F.gelu(gf, approximate="tanh"))
        return (act.to(dt) * u) @ p["w_down"].to(dt)
    if cfg.ffn == FFNKind.GELU:
        h = x @ p["w_up"].to(dt) + p["b_up"].to(dt)
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
        return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
    raise NotImplementedError(
        f"ffn={cfg.ffn.value!r} is not ported yet (ROADMAP: port queue)")
