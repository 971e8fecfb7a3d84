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
it was, unless the caller donates the state (``donate=True``: updated in
place). Mixed precision as in the JAX package: each step casts the f32
master to ``compute_dtype`` (f32 or bf16) under autograd, so the gradients
come back f32 on the master and AdamW runs in f32. The checkpointed,
crash-recovering launcher around it is ``launch/train.py`` (the
``TrainRunner`` of ``distributed/fault.py``, the dropout contract of
``checkpoint/contract.py``).

``make_prefill_step`` / ``make_serve_step`` wrap ``models.prefill`` and
``models.decode_step`` (the contiguous caches of every layer kind) with
no dropout plan, at step 0 and the caller's compute dtype.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict

import torch

from repro_torch.config.base import ModelConfig, RunConfig
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.device import DeviceLike
from repro_torch.models import (
    Runtime,
    decode_step,
    forward,
    model_init,
    prefill,
)
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import _adamw_update
from repro_torch.tree import leaves, tree_map, unflatten_like

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


_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_ported(policy, compute_dtype, what: str = "training") -> None:
    if policy is not None:
        raise _not_ported(f"{what} under a sharding policy")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype}; the step computes "
                         f"in one of {_COMPUTE_DTYPES}")


def _probs_dtype(run: RunConfig):
    """The tensor-op attention's probability dtype: bf16 under
    ``attn_probs_bf16``, else f32."""
    return torch.bfloat16 if run.sharding.attn_probs_bf16 else torch.float32


def _cast(master, compute_dtype):
    """The step's parameters: the master tree cast to ``compute_dtype``
    (differentiable; no copy at f32)."""
    return tree_map(lambda t: t.to(compute_dtype), master)


def _log_schedule(context: str, sched) -> None:
    for site, how, gemm_dtype, note in sched.records():
        log.info("%s: dropout mask producer site=%s how=%s "
                 "gemm_dtype=%s%s", context, site, how, gemm_dtype,
                 f" ({note})" if note else "")
    log.info("%s:\n%s", context, sched.explain())


def compile_run_schedule(cfg: ModelConfig, run: RunConfig, policy=None,
                         verify: bool = False):
    """The train step's DropoutSchedule for one RunConfig, compiled for the
    per-microbatch shape the forward sees; ``verify`` proves it through
    the counter layer first (``compile_schedule(verify=True)``)."""
    if policy is not None:
        raise _not_ported("training under a sharding policy")
    micro = run.train.microbatch
    b_eff = run.shape.global_batch // micro if micro and micro > 1 \
        else run.shape.global_batch
    return compile_schedule(cfg, run.dropout, b_eff, run.shape.seq_len,
                            attn_impl=run.sharding.attn_impl,
                            moe_seq_dispatch=run.sharding.moe_seq_dispatch,
                            verify=verify)


def make_grad_fn(cfg: ModelConfig, run: RunConfig, policy=None,
                 compute_dtype=torch.float32, sched=None) -> Callable:
    """grad_fn(master, x, y, step) -> (loss, (ce, aux), grads): the loss of
    one batch and its gradient tree (f32) with respect to ``master``, the
    forward run on the master cast to ``compute_dtype``."""
    _validate_dropout_plan(run)
    _check_ported(policy, compute_dtype)
    plan = DropoutPlan(run.dropout)
    if sched is None:
        sched = compile_run_schedule(cfg, run)

    def grad_fn(master, x, y, step: int):
        flat = [t.detach().requires_grad_() for t in leaves(master)]
        params = _cast(unflatten_like(master, flat), compute_dtype)
        rt = Runtime(plan=plan, step=int(step), compute_dtype=compute_dtype,
                     probs_dtype=_probs_dtype(run),
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
                    compute_dtype=torch.float32,
                    donate: bool = False) -> Callable:
    """train_step(state, x, y) -> (new_state, metrics). x, y are tensors
    on the parameters' device. ``run.train.microbatch > 1`` accumulates
    gradients over that many equal slices of the batch. ``donate`` updates
    the state's parameters and moments in place (bitwise the functional
    update) and returns them: one copy of the state on the device instead
    of two, which is what lets a model whose state fills most of the card
    train; the caller must not read the old state afterwards.
    ``compute_dtype`` is f32 or bf16 (the JAX package's mixed
    precision)."""
    _validate_dropout_plan(run)
    _check_ported(policy, compute_dtype)
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
        # the next step casts the master again, so AdamW makes no
        # compute-dtype copy (JAX's jit drops the one it returns)
        master, _, opt, om = _adamw_update(
            grads, state["opt"], state["master"], run.train.optimizer, step,
            None, in_place=donate)
        new_state = {"master": master, "opt": opt, "step": step + 1}
        return new_state, {"loss": loss, "ce": ce, "aux": aux, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, run: RunConfig, policy=None,
                   compute_dtype=torch.float32) -> Callable:
    """eval_step(master, x, y) -> mean cross entropy, without dropout, on
    the master cast to ``compute_dtype``."""
    _check_ported(policy, compute_dtype)

    @torch.no_grad()
    def eval_step(master, x, y):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype)
        logits, _ = forward(_cast(master, compute_dtype), cfg, rt, x)
        return cross_entropy(logits, y)

    return eval_step


def make_serve_step(cfg: ModelConfig, policy=None,
                    compute_dtype=torch.float32) -> Callable:
    """serve_step(params, inputs, caches) -> (logits (B, 1, V), caches):
    one decode token for every sequence (``models.decode_step``)."""
    _check_ported(policy, compute_dtype, "serving")

    @torch.no_grad()
    def serve_step(params, inputs, caches):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype)
        return decode_step(params, cfg, rt, inputs, caches)

    return serve_step


def make_prefill_step(cfg: ModelConfig, policy=None,
                      compute_dtype=torch.float32,
                      capacity: int = 0) -> Callable:
    """prefill_step(params, inputs) -> (logits (B, 1, V), caches), the FULL
    caches holding ``capacity`` positions (``models.prefill``)."""
    _check_ported(policy, compute_dtype, "serving")

    @torch.no_grad()
    def prefill_step(params, inputs):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype)
        return prefill(params, cfg, rt, inputs, capacity=capacity)

    return prefill_step
