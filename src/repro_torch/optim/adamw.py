"""AdamW with global-norm clipping and LR schedules on f32 master
parameters, functional over parameter trees as in the JAX package: each
update returns new tensors and leaves its inputs as they were.

Weight decay follows the JAX package's rule verbatim: a leaf decays
unless its ``keystr`` path contains one of ``_NO_DECAY_TOKENS``. The
token "u" matches ``w_up`` and ``unembed`` too, so those do not decay,
while ``w_gate``, ``w_down``, ``w_q`` .. ``w_o`` and ``embed`` do.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.config.base import OptimizerConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map, \
    unflatten_like

_NO_DECAY_TOKENS = ("norm", "bias", "scale", "mu_", "lambda", "w0", "u")


def schedule_lr(cfg: OptimizerConfig, step: int) -> float:
    """The learning rate at ``step``, in f32 arithmetic as JAX computes
    it (warm-up, then cosine / linear / constant)."""
    f32 = np.float32
    step = f32(step)
    warm = min(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    span = f32(max(cfg.total_steps - cfg.warmup_steps, 1))
    t = np.clip((step - f32(cfg.warmup_steps)) / span, f32(0.0), f32(1.0))
    if cfg.schedule == "constant":
        decay = f32(1.0)
    elif cfg.schedule == "linear":
        decay = f32(1.0) - f32(0.9) * t
    else:  # cosine
        decay = f32(0.1) + f32(0.45) * (f32(1.0) + np.cos(f32(np.pi) * t))
    return float(f32(cfg.lr) * warm * decay)


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32,
                              device=a.device), p)
    return {"m": zeros(params), "v": zeros(params)}


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _decay_mask(path: str) -> bool:
    lower = path.lower()
    return not any(tok in lower for tok in _NO_DECAY_TOKENS)


def adamw_update(grads, opt_state, master, cfg: OptimizerConfig, step: int,
                 compute_dtype=None):
    """One AdamW step on f32 master params. Returns (new_master,
    new_params_compute, new_opt_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = schedule_lr(cfg, step)
    t = np.float32(step) + np.float32(1.0)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    gl = leaves(grads)
    ms = leaves(opt_state["m"])
    vs = leaves(opt_state["v"])
    new_m, new_v, new_p = [], [], []
    for (path, p), g, m, v in zip(leaves_with_paths(master), gl, ms, vs):
        g = g.to(torch.float32)
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p
        new_m.append(m_new)
        new_v.append(v_new)
        new_p.append(p - lr * delta)
    new_master = unflatten_like(master, new_p)
    opt = {"m": unflatten_like(master, new_m),
           "v": unflatten_like(master, new_v)}
    if compute_dtype is not None and compute_dtype != torch.float32:
        new_params = tree_map(lambda a: a.to(compute_dtype), new_master)
    else:
        new_params = new_master
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_master, new_params, opt, metrics
