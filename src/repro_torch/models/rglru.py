"""RG-LRU recurrent block (Griffin / RecurrentGemma): the JAX package's
``models/rglru.py``, the training forward and the serving path.

Block: x -> [linear -> causal conv1d(4) -> RG-LRU] o [linear -> GeLU]
         -> linear out.

RG-LRU (per channel):
    r_t = sigmoid(W_a c_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_i c_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * c_t)

The JAX package evaluates the diagonal linear recurrence with
``jax.lax.associative_scan`` outside any Pallas kernel, so the port is
plain torch: a log-depth scan over T in tensor ops (``_scan_recurrence``,
ceil(log2 T) steps, not a loop over the tokens). Its f32 sums run in
another order than JAX's odd-even scan: the states agree to a few f32
ulps of the largest term (tests/test_torch_rglru.py states the limit).
No attention-score matrix exists, so attention dropout does not apply to
these layers; the Griffin pattern's local-attention layers do use it.
Serving keeps O(1) state a sequence (``rglru_cache_init``): the f32
recurrent state ``h`` (B, R), the conv's last 3 inputs (B, 3, R) and the
host-side length; ``rglru_prefill`` runs the scan and fills it,
``rglru_decode`` takes one step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import dense_init

_C = 8.0
_CONV_W = 4


def rglru_init(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = (), device=None) -> Dict[str, Any]:
    """The JAX package's shapes and scales (recurrent width = d_model;
    Lambda so that the decays a spread over (0.9, 0.999))."""
    d = cfg.d_model
    r = cfg.d_model

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, lead=lead, device=device)

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    lam = torch.rand(lead + (r,), generator=gen, device=device,
                     dtype=torch.float32) * (0.1 - 0.001) + 0.001
    lam = torch.log(torch.exp(-torch.log(lam) / _C) - 1.0)  # inv. softplus
    conv_w = torch.randn(lead + (_CONV_W, r), generator=gen, device=device,
                         dtype=torch.float32).mul_(0.1)
    return {
        "w_x": dense(d, r),
        "w_gate": dense(d, r),
        "w_out": dense(r, d),
        "conv_w": conv_w,
        "conv_b": zeros((r,)),
        "w_a": dense(r, r),
        "b_a": zeros((r,)),
        "w_i": dense(r, r),
        "b_i": zeros((r,)),
        "lambda": lam,
    }


def _causal_conv(p, u: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width 4 over u (B, T, R), in u's dtype:
    tap i multiplies the input 3 - i steps back. ``tail`` (B, 3, R)
    carries the 3 inputs before u (a decode step's cache); without it they
    are zeros."""
    dt = u.dtype
    w = p["conv_w"].to(dt)
    if tail is None:
        full = F.pad(u, (0, 0, _CONV_W - 1, 0))      # (B, T + 3, R)
    else:
        full = torch.cat([tail.to(dt), u], dim=1)
    t = u.shape[1]
    out = sum(full[:, i:i + t, :] * w[i] for i in range(_CONV_W))
    return out + p["conv_b"].to(dt)


def _gates(p, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log a, i * c), both f32, from the conv output c (B, T, R): the gate
    GEMMs run in c's dtype, and each adds its bias in f32 before the
    sigmoid. That is JAX's function as XLA compiles it: its source adds
    the bias in c's dtype and casts the sum to f32, and the compiled
    program drops that rounding (excess precision; at f32 both are the
    same sum)."""
    dt = c.dtype
    f32 = torch.float32
    r_gate = torch.sigmoid((c @ p["w_a"].to(dt)).to(f32)
                           + p["b_a"].to(dt).to(f32))
    i_gate = torch.sigmoid((c @ p["w_i"].to(dt)).to(f32)
                           + p["b_i"].to(dt).to(f32))
    lam = p["lambda"].to(f32)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_C * softplus * r_gate
    return log_a, i_gate * c.to(f32)


def _scan_recurrence(log_a: torch.Tensor, gated: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) gated_t for log_a, gated (B, T,
    R) f32; h0 (B, R) f32 folds in as a virtual first step. A log-depth
    (Hillis-Steele) scan: step j folds in the element 2^j back, so after
    ceil(log2 T) steps every h_t holds its whole prefix. sqrt(max(1 - a^2,
    0)) is JAX's form, gradient included (infinite where a = 1 exactly,
    which a sigmoid gate times a positive softplus never reaches)."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a),
                                 torch.zeros_like(log_a))) * gated
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None, :], b], dim=1)
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        if 2 * off < t:          # the last step's products go unused
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b[:, 1:] if h0 is not None else b


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training forward. x (B, T, D) -> (B, T, D) in x's dtype; the gates,
    the recurrence and the GeLU branch in f32, as JAX computes them."""
    dt = x.dtype
    u = x @ p["w_x"].to(dt)
    gate = F.gelu((x @ p["w_gate"].to(dt)).to(torch.float32),
                  approximate="tanh")
    c = _causal_conv(p, u)
    log_a, gated = _gates(p, c)
    h = _scan_recurrence(log_a, gated)
    out = (h * gate).to(dt)
    return out @ p["w_out"].to(dt)


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """Zero decode state: ``h`` f32 (B, R), ``conv`` (B, 3, R) in
    ``dtype``, ``len`` a host int32 scalar."""
    r = cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, r), dtype=dtype,
                            device=device),
        "len": torch.tensor(0, dtype=torch.int32),
    }


def rglru_prefill(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward over the prompt x (B, T, D), keeping the last
    state and the conv's last 3 inputs (zero-padded in front when
    T < 3)."""
    dt = x.dtype
    b, t, _ = x.shape
    u = x @ p["w_x"].to(dt)
    gate = F.gelu((x @ p["w_gate"].to(dt)).to(torch.float32),
                  approximate="tanh")
    c = _causal_conv(p, u)
    log_a, gated = _gates(p, c)
    h = _scan_recurrence(log_a, gated)
    out = (h * gate).to(dt) @ p["w_out"].to(dt)
    tail = u[:, -(_CONV_W - 1):, :]
    if t < _CONV_W - 1:
        tail = F.pad(tail, (0, 0, _CONV_W - 1 - t, 0))
    cache = {"h": h[:, -1, :], "conv": tail,
             "len": torch.tensor(t, dtype=torch.int32)}
    return out, cache


def rglru_decode(p, x1: torch.Tensor, cache, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x1 (B, 1, D): h = a h + sqrt(max(1 - a^2, 0)) (i c).
    Returns (y (B, 1, D), the new state); ``cache`` is read only."""
    dt = x1.dtype
    u = x1 @ p["w_x"].to(dt)                          # (B, 1, R)
    gate = F.gelu((x1 @ p["w_gate"].to(dt)).to(torch.float32),
                  approximate="tanh")
    c = _causal_conv(p, u, tail=cache["conv"])
    log_a, gated = _gates(p, c)
    a = torch.exp(log_a[:, 0])
    b_term = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * gated[:, 0]
    h = a * cache["h"] + b_term                       # (B, R)
    out = (h[:, None, :] * gate).to(dt) @ p["w_out"].to(dt)
    new_cache = {
        "h": h,
        "conv": torch.cat([cache["conv"][:, 1:], u.to(cache["conv"].dtype)],
                          dim=1),
        "len": cache["len"] + 1,
    }
    return out, new_cache
