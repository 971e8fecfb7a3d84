"""RWKV6 (Finch) time-mix with data-dependent decay: the JAX package's
``models/rwkv.py``, the training forward and the serving path.

Recurrence (per head, K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

The training forward evaluates it in chunks of L tokens: within a chunk the
pairwise decay exp(cum[t-1] - cum[s]) <= 1 is computed directly, and the
state crosses chunks in a Python loop (JAX's ``lax.scan``). No Pallas kernel
runs here in JAX, so the port is plain torch. Attention dropout does not
apply (no score matrix). Serving keeps O(1) state a sequence
(``rwkv_cache_init``): the f32 WKV state (B, H, K, V), the last inputs of
the time-mix and of the channel-mix FFN (their token shifts) and the
host-side length. ``rwkv_prefill`` runs the chunked form over the prompt,
``rwkv_decode`` the one-step recurrence (``wkv_step``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import dense_init, token_shift

_LORA = 32
_CHUNK = 16
_MIXES = ("w", "k", "v", "r", "g")


def rwkv_init(gen: torch.Generator, cfg: ModelConfig,
              lead: Tuple[int, ...] = (), device=None) -> Dict[str, Any]:
    """The JAX package's shapes and scales."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = cfg.rwkv_head_dim
    if h * hd != d:
        raise ValueError(f"n_heads {h} x rwkv_head_dim {hd} != d_model {d}")

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=device)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, scale=scale, lead=lead,
                          device=device)

    u = torch.randn(lead + (h, hd), generator=gen, device=device,
                    dtype=torch.float32).mul_(0.1)
    p: Dict[str, Any] = {
        "mu_x": full((d,), 0.5),
        "w0": full((d,), -0.6),          # decay ~ exp(-exp(-0.6))
        "u": u,
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
        "w_g": dense(d, d), "w_o": dense(d, d),
        "ln_x_scale": full((h, hd), 1.0),
        "ln_x_bias": full((h, hd), 0.0),
    }
    for c in _MIXES:
        p[f"mu_{c}"] = full((d,), 0.5)
        p[f"lora_a_{c}"] = dense(d, _LORA, scale=0.01)
        p[f"lora_b_{c}"] = dense(_LORA, d, scale=0.01)
    return p


def _mix_inputs(p, x: torch.Tensor, shifted: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Token-shift interpolation with LoRA modulation (rwkv6 style)."""
    dt = x.dtype
    xx = shifted - x
    xxx = x + xx * p["mu_x"].to(dt)
    outs = {}
    for c in _MIXES:
        lora = torch.tanh(xxx @ p[f"lora_a_{c}"].to(dt)) @ \
            p[f"lora_b_{c}"].to(dt)
        outs[c] = x + xx * (p[f"mu_{c}"].to(dt) + lora)
    return outs


def _project(p, mixed, b: int, t: int, h: int, hd: int):
    dt = mixed["r"].dtype
    r = (mixed["r"] @ p["w_r"].to(dt)).reshape(b, t, h, hd)
    k = (mixed["k"] @ p["w_k"].to(dt)).reshape(b, t, h, hd)
    v = (mixed["v"] @ p["w_v"].to(dt)).reshape(b, t, h, hd)
    g = F.silu((mixed["g"] @ p["w_g"].to(dt)).to(torch.float32)).to(dt)
    logw = -torch.exp(
        p["w0"].to(torch.float32)
        + (mixed["w"] @ p["lora_a_w"].to(dt)
           @ p["lora_b_w"].to(dt)).to(torch.float32))
    return r, k, v, g, logw.reshape(b, t, h, hd)


def _group_norm(p, o: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm on the wkv output. o (B, T, H, hd)."""
    of = o.to(torch.float32)
    mean = of.mean(dim=-1, keepdim=True)
    var = of.var(dim=-1, unbiased=False, keepdim=True)
    return ((of - mean) * torch.rsqrt(var + eps) * p["ln_x_scale"]
            + p["ln_x_bias"])


def wkv_chunked(r, k, v, logw, u, s0, chunk: int = _CHUNK):
    """r, k, v, logw (B, H, T, K) f32; u (H, K); s0 (B, H, K, V). Returns
    (o (B, H, T, V), the final state)."""
    b, h, t, kk = r.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), -1)
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)
    s = s0
    outs = []
    for c0 in range(0, t, chunk):
        rr, kc, vv, ww = (a[:, :, c0:c0 + chunk] for a in (r, k, v, logw))
        cum = torch.cumsum(ww, dim=2)               # decay through t
        cum_in = cum - ww                           # decay through t-1
        # the state (inter-chunk) contribution
        o_state = torch.einsum("bhlk,bhkv->bhlv", rr * torch.exp(cum_in), s)
        # intra-chunk pairs: E[t, s, k] = exp(cum_in[t] - cum[s]), s < t
        ee = torch.exp(cum_in[:, :, :, None, :] - cum[:, :, None, :, :])
        a = torch.einsum("bhtk,bhsk,bhtsk->bhts", rr, kc, ee) * tri
        # the diagonal bonus term diag(u)
        a_diag = torch.sum(rr * u[None, :, None, :] * kc, dim=-1)
        a = a + a_diag[..., None] * eye
        outs.append(o_state + torch.einsum("bhts,bhsv->bhtv", a, vv))
        # the state update
        decay_all = torch.exp(cum[:, :, -1:, :])    # (B, H, 1, K)
        kd = kc * torch.exp(cum[:, :, -1:, :] - cum)
        s = (s * decay_all[:, :, 0, :, None]
             + torch.einsum("bhsk,bhsv->bhkv", kd, vv))
    return torch.cat(outs, dim=2), s


def wkv_step(r1, k1, v1, logw1, u, s):
    """One decode step. r1, k1, v1, logw1 (B, H, K) f32; u (H, K); s (B, H,
    K, V). Returns (o (B, H, V), the new state)."""
    bonus = s + (u[None] * k1)[..., None] * v1[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r1, bonus)
    s_new = s * torch.exp(logw1)[..., None] + k1[..., None] * v1[..., None, :]
    return o, s_new


def _time_mix(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked time-mix over x (B, T, D) from a zero state. Returns
    (y (B, T, D), the final state (B, H, K, V) f32)."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.rwkv_head_dim
    shifted = token_shift(x)
    mixed = _mix_inputs(p, x, shifted)
    r, k, v, g, logw = _project(p, mixed, b, t, h, hd)
    pad = (-t) % _CHUNK

    def to_bhtk(a):
        # zero pads are state-neutral: k = v = 0 adds nothing, logw = 0
        # decays by 1
        a = a.permute(0, 2, 1, 3).to(torch.float32)
        return F.pad(a, (0, 0, 0, pad)) if pad else a

    s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    o, s_fin = wkv_chunked(to_bhtk(r), to_bhtk(k), to_bhtk(v), to_bhtk(logw),
                           p["u"].to(torch.float32), s0)
    o = o[:, :, :t].permute(0, 2, 1, 3)             # (B, T, H, hd)
    o = _group_norm(p, o).to(x.dtype) * g.reshape(b, t, h, hd)
    return o.reshape(b, t, d) @ p["w_o"].to(x.dtype), s_fin


def rwkv_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training forward. x (B, T, D)."""
    return _time_mix(p, x, cfg)[0]


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    """Zero decode state: ``s`` f32 (B, H, K, V), the time-mix and
    channel-mix shifts (B, D) in ``dtype``, ``len`` a host int32 scalar."""
    h, hd = cfg.n_heads, cfg.rwkv_head_dim

    def shift():
        return torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)

    return {
        "s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        "shift_tm": shift(),
        "shift_cm": shift(),
        "len": torch.tensor(0, dtype=torch.int32),
    }


def rwkv_prefill(p, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The time-mix over the prompt x (B, T, D), any T: the chunked form
    pads T to a multiple of the 16-token chunk with state-neutral zeros.
    The caller (the block) stores the channel-mix shift ``shift_cm``."""
    b, t, d = x.shape
    y, s_fin = _time_mix(p, x, cfg)
    cache = {"s": s_fin, "shift_tm": x[:, -1, :],
             "shift_cm": torch.zeros((b, d), dtype=x.dtype, device=x.device),
             "len": torch.tensor(t, dtype=torch.int32)}
    return y, cache


def rwkv_decode(p, x1: torch.Tensor, cache, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x1 (B, 1, D) against the cached state (read only).
    Returns (y (B, 1, D), the new state)."""
    b, _, d = x1.shape
    h, hd = cfg.n_heads, cfg.rwkv_head_dim
    shifted = cache["shift_tm"][:, None, :].to(x1.dtype)
    mixed = _mix_inputs(p, x1, shifted)
    r, k, v, g, logw = _project(p, mixed, b, 1, h, hd)

    def sq(a):                                       # (B,1,H,hd) -> (B,H,hd)
        return a[:, 0].to(torch.float32)

    o, s_new = wkv_step(sq(r), sq(k), sq(v), sq(logw),
                        p["u"].to(torch.float32), cache["s"])
    o = _group_norm(p, o.reshape(b, 1, h, hd)).to(x1.dtype)
    o = o * g.reshape(b, 1, h, hd)
    y = o.reshape(b, 1, d) @ p["w_o"].to(x1.dtype)
    new_cache = dict(cache)
    new_cache["s"] = s_new
    new_cache["shift_tm"] = x1[:, 0, :]
    new_cache["len"] = cache["len"] + 1
    return y, new_cache
