"""AdamW with global-norm clipping and LR schedules on f32 master
parameters, functional over parameter trees as in the JAX package: each
update returns new tensors and leaves its inputs as they were. The train
step that takes a donated state uses ``_adamw_update(in_place=True)``.

Weight decay follows the JAX package's rule verbatim: a leaf decays
unless its ``keystr`` path contains one of ``_NO_DECAY_TOKENS``. The
token "u" matches ``w_up`` and ``unembed`` too, so those do not decay,
while ``w_gate``, ``w_down``, ``w_q`` .. ``w_o`` and ``embed`` do.
"""
from __future__ import annotations

from typing import Any, Dict

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
    # zeros_like keeps a DTensor's layout (a sharded master's moments are
    # sharded as it is)
    zeros = lambda p: tree_map(
        lambda a: torch.zeros_like(a, dtype=torch.float32), p)
    return {"m": zeros(params), "v": zeros(params)}


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _decay_mask(path: str) -> bool:
    lower = path.lower()
    return not any(tok in lower for tok in _NO_DECAY_TOKENS)


def adamw_update(grads, opt_state, master, cfg: OptimizerConfig, step: int,
                 compute_dtype=None):
    """One AdamW step on f32 master params, the gradients clipped to
    ``cfg.grad_clip`` by their global norm. Returns (new_master,
    new_params_compute, new_opt_state, metrics)."""
    return _adamw_update(grads, opt_state, master, cfg, step, compute_dtype,
                         in_place=False)


def _adamw_update(grads, opt_state, master, cfg: OptimizerConfig,
                  step: int, compute_dtype, in_place: bool):
    """``adamw_update``, the gradients clipped leaf by leaf (no clipped
    copy of the whole tree). ``in_place`` writes the new moments and
    parameters into ``opt_state`` and ``master`` and returns those trees:
    the caller donates the old state, as a JAX step donates its buffers.
    The arithmetic is the same, so the result is bitwise the functional
    update's, without a second copy of the parameters and moments on the
    device."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    t = np.float32(step) + np.float32(1.0)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    gl = leaves(grads)
    ms = leaves(opt_state["m"])
    vs = leaves(opt_state["v"])
    new_m, new_v, new_p = [], [], []
    for (path, p), g, m, v in zip(leaves_with_paths(master), gl, ms, vs):
        g = (g * scale).to(torch.float32)
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p
        p_new = p - lr * delta
        if in_place:
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_(p_new)
        else:
            new_m.append(m_new)
            new_v.append(v_new)
            new_p.append(p_new)
    if in_place:
        new_master, opt = master, opt_state
    else:
        new_master = unflatten_like(master, new_p)
        opt = {"m": unflatten_like(master, new_m),
               "v": unflatten_like(master, new_v)}
    if compute_dtype is not None and compute_dtype != torch.float32:
        new_params = tree_map(lambda a: a.to(compute_dtype), new_master)
    else:
        new_params = new_master
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_master, new_params, opt, metrics
