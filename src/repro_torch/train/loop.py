"""Train and eval step functions.

TrainState (a dict):
    master -- f32 master parameters (a parameter tree)
    opt    -- {"m", "v"} AdamW moments (f32, same tree)
    step   -- host int: the dropout plan folds it into the Philox key on
              the host, so a step never reads a value back from the card

``make_train_step`` compiles the dropout schedule once, then each call runs
the forward (``models.forward``), the cross entropy, the backward (autograd
through the kernels' Functions, remat per unit with remat="block") and
AdamW. It is functional: it returns a new state and leaves the old one as
it was. The checkpointing ``TrainRunner`` and the dropout contract of the
JAX package's ``launch/train.py`` are not ported yet (ROADMAP).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict

import torch

from repro_torch.config.base import ModelConfig, RunConfig
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.device import DeviceLike
from repro_torch.models import Runtime, forward, model_init
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import leaves, unflatten_like

AUX_WEIGHT = 0.01

log = logging.getLogger("repro_torch.train")


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded random parameters (``model_init``) on ``device`` (the card
    unless asked), zero moments, step 0."""
    params = model_init(cfg, seed=seed, device=device)
    return {"master": params, "opt": adamw_init(params), "step": 0}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross entropy; logits f32 (B, S, V), labels (B, S)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked)


def _validate_dropout_plan(run: RunConfig) -> None:
    """The producer-site knob only makes sense for decoupled RNG."""
    d = run.dropout
    if d.site != "xla" and d.mode == "fused":
        raise ValueError(
            f"site={d.site!r} requires mode='overlap' (fused mode has no "
            "producer-GEMM site)")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: port queue)")


def _check_ported(run: RunConfig, policy, compute_dtype) -> None:
    if policy is not None:
        raise _not_ported("training under a sharding policy")
    if compute_dtype != torch.float32:
        raise _not_ported(f"compute_dtype={compute_dtype} (bf16 flash)")
    if run.sharding.attn_probs_bf16:
        raise _not_ported("attn_probs_bf16")


def _log_schedule(context: str, sched) -> None:
    for site, how, gemm_dtype, note in sched.records():
        log.info("%s: dropout mask producer site=%s how=%s "
                 "gemm_dtype=%s%s", context, site, how, gemm_dtype,
                 f" ({note})" if note else "")
    log.info("%s:\n%s", context, sched.explain())


def compile_run_schedule(cfg: ModelConfig, run: RunConfig, policy=None):
    """The train step's DropoutSchedule for one RunConfig, compiled for the
    per-microbatch shape the forward sees."""
    if policy is not None:
        raise _not_ported("training under a sharding policy")
    micro = run.train.microbatch
    b_eff = run.shape.global_batch // micro if micro and micro > 1 \
        else run.shape.global_batch
    return compile_schedule(cfg, run.dropout, b_eff, run.shape.seq_len,
                            attn_impl=run.sharding.attn_impl,
                            moe_seq_dispatch=run.sharding.moe_seq_dispatch)


def make_grad_fn(cfg: ModelConfig, run: RunConfig, policy=None,
                 compute_dtype=torch.float32, sched=None) -> Callable:
    """grad_fn(master, x, y, step) -> (loss, (ce, aux), grads): the loss of
    one batch and its gradient tree with respect to ``master``."""
    _validate_dropout_plan(run)
    _check_ported(run, policy, compute_dtype)
    plan = DropoutPlan(run.dropout)
    if sched is None:
        sched = compile_run_schedule(cfg, run)

    def grad_fn(master, x, y, step: int):
        flat = [t.detach().requires_grad_() for t in leaves(master)]
        params = unflatten_like(master, flat)
        rt = Runtime(plan=plan, step=int(step), compute_dtype=compute_dtype,
                     remat=run.sharding.remat,
                     attn_impl=run.sharding.attn_impl, schedule=sched)
        logits, aux = forward(params, cfg, rt, x)
        ce = cross_entropy(logits, y)
        loss = ce + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, flat)
        return (loss.detach(), (ce.detach(), aux.detach()),
                unflatten_like(master, list(grads)))

    return grad_fn


def make_train_step(cfg: ModelConfig, run: RunConfig, policy=None,
                    compute_dtype=torch.float32) -> Callable:
    """train_step(state, x, y) -> (new_state, metrics). x, y are tensors
    on the parameters' device. ``run.train.microbatch > 1`` accumulates
    gradients over that many equal slices of the batch."""
    _validate_dropout_plan(run)
    _check_ported(run, policy, compute_dtype)
    micro = run.train.microbatch
    sched = compile_run_schedule(cfg, run)
    _log_schedule(f"train_step[site={run.dropout.site}]", sched)
    grad_fn = make_grad_fn(cfg, run, policy, compute_dtype, sched)

    def train_step(state, x, y):
        step = int(state["step"])
        if micro and micro > 1:
            bsz = x.shape[0]
            if bsz % micro:
                raise ValueError(f"batch {bsz} does not split into "
                                 f"{micro} microbatches")
            mb = bsz // micro
            gsum, lsum = None, torch.zeros(3, device=x.device)
            for i in range(micro):
                loss, (ce, aux), g = grad_fn(
                    state["master"], x[i * mb:(i + 1) * mb],
                    y[i * mb:(i + 1) * mb], step)
                gl = leaves(g)
                gsum = gl if gsum is None else [a + b for a, b in
                                                zip(gsum, gl)]
                lsum = lsum + torch.stack([loss, ce, aux])
            grads = unflatten_like(state["master"],
                                   [g / micro for g in gsum])
            loss, ce, aux = lsum[0] / micro, lsum[1] / micro, lsum[2] / micro
        else:
            loss, (ce, aux), grads = grad_fn(state["master"], x, y, step)
        master, _, opt, om = adamw_update(
            grads, state["opt"], state["master"], run.train.optimizer, step,
            compute_dtype)
        new_state = {"master": master, "opt": opt, "step": step + 1}
        return new_state, {"loss": loss, "ce": ce, "aux": aux, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, run: RunConfig, policy=None,
                   compute_dtype=torch.float32) -> Callable:
    """eval_step(master, x, y) -> mean cross entropy, without dropout."""
    _check_ported(run, policy, compute_dtype)

    @torch.no_grad()
    def eval_step(master, x, y):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype)
        logits, _ = forward(master, cfg, rt, x)
        return cross_entropy(logits, y)

    return eval_step
