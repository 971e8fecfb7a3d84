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

Under a sharding policy (``policy=``) the state is DTensors on its mesh:
``init_train_state`` makes the master whole from the seed and then keeps
each rank's slice by ``train_state_specs`` (ZeRO included), so it is
bitwise the single-device init. Each step casts the master to the
compute layout (``param_specs``), places the batch by ("batch", None),
runs the forward under ``use_policy``, and brings each gradient back to
its master's layout: the partial sums a data-parallel mesh holds are
reduced there, as GSPMD reduces them, so AdamW and the gradient norm see
global values.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict

import torch

from repro_torch.config.base import ModelConfig, RunConfig
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (current_policy, distribute,
                                              gather_full, use_policy)
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
                     device: DeviceLike = None, policy=None,
                     fsdp: bool = False, zero1: bool = True
                     ) -> Dict[str, Any]:
    """Seeded random parameters (``model_init``) on ``device`` (the card
    unless asked; the mesh's device under a ``policy``), zero moments,
    step 0. With a ``policy`` the master is made whole from the seed and
    then each rank keeps its slices by ``train_state_specs`` (bitwise the
    single-device init); the moments are made in that layout."""
    if policy is None:
        params = model_init(cfg, seed=seed, device=device)
        return {"master": params, "opt": adamw_init(params), "step": 0}
    from repro_torch.distributed.specs import place_tree, train_state_specs
    params = model_init(cfg, seed=seed, device=device or
                        policy.mesh.device_type)
    specs = train_state_specs({"master": params}, policy, fsdp, zero1)
    master = place_tree(params, specs["master"], policy.mesh)
    del params
    # the moments are zeros in the master's layout: no whole copy is made
    return {"master": master, "opt": adamw_init(master), "step": 0}


def place_train_state(state, policy, fsdp: bool = False,
                      zero1: bool = True) -> Dict[str, Any]:
    """A state every rank holds whole, placed on ``policy``'s mesh by
    ``train_state_specs``: each rank keeps its slices (bitwise)."""
    from repro_torch.distributed.specs import place_tree, train_state_specs
    specs = train_state_specs(state, policy, fsdp, zero1)
    mesh = policy.mesh
    return {"master": place_tree(state["master"], specs["master"], mesh),
            "opt": {k: place_tree(state["opt"][k], specs["opt"][k], mesh)
                    for k in ("m", "v")},
            "step": state["step"]}


def place_batch(t: torch.Tensor, policy) -> torch.Tensor:
    """A global batch every rank holds, placed by ("batch", None, ...):
    each rank keeps its rows. A DTensor passes through."""
    if policy is None or not isinstance(t, torch.Tensor) \
            or hasattr(t, "device_mesh"):
        return t
    spec = policy.spec(("batch",) + (None,) * (t.ndim - 1), tuple(t.shape))
    return distribute(t, spec, policy.mesh)


def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - picked


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross entropy; logits f32 (B, S, V), labels (B, S).
    Under a policy each token's term is taken in a shard_map body over the
    batch shards, vocab-parallel where the logits' vocab dim is split (the
    max, the sum of exponentials and the picked logit reduced over the
    vocab axes): DTensor's gather of the picked logit leaves a masked
    partial it cannot reduce, and the logits stay where the unembedding
    made them."""
    policy = current_policy()
    if policy is None or not hasattr(logits, "device_mesh"):
        return torch.mean(_token_ce(logits, labels))
    from repro_torch.compat import P, shard_map
    from repro_torch.models.transformer import _vocab_axes
    b_ax = policy.mesh_axes_for("batch", logits.shape[0])
    v_ax = _vocab_axes(policy, logits.shape[-1], b_ax)
    per_tok = shard_map(
        lambda lg, y: _token_ce_vocab_parallel(lg, y, v_ax),
        mesh=policy.mesh, in_specs=(P(b_ax, None, v_ax), P(b_ax, None)),
        out_specs=P(b_ax, None))(logits, labels)
    return torch.mean(per_tok)


def _token_ce_vocab_parallel(logits, labels, v_ax):
    """Each token's lse - picked logit with the vocab split over ``v_ax``
    (inside a shard_map body; the whole vocab when None)."""
    if v_ax is None:
        return _token_ce(logits, labels)
    from repro_torch.compat import axis_index, pmax, psum
    m = pmax(logits.detach().amax(dim=-1), v_ax)
    lse = m + torch.log(psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                             v_ax))
    local = labels.long() - axis_index(v_ax) * logits.shape[-1]
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1,
                          torch.where(inside, local, 0)[..., None])[..., 0]
    return lse - psum(picked * inside.to(picked.dtype), v_ax)


def _validate_dropout_plan(run: RunConfig) -> None:
    """The producer-site knob only makes sense for decoupled RNG."""
    d = run.dropout
    if d.site != "xla" and d.mode == "fused":
        raise ValueError(
            f"site={d.site!r} requires mode='overlap' (fused mode has no "
            "producer-GEMM site)")


_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(compute_dtype) -> None:
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
    micro = run.train.microbatch
    b_eff = run.shape.global_batch // micro if micro and micro > 1 \
        else run.shape.global_batch
    return compile_schedule(cfg, run.dropout, b_eff, run.shape.seq_len,
                            policy=policy,
                            attn_impl=run.sharding.attn_impl,
                            moe_seq_dispatch=run.sharding.moe_seq_dispatch,
                            verify=verify)


def make_grad_fn(cfg: ModelConfig, run: RunConfig, policy=None,
                 compute_dtype=torch.float32, sched=None) -> Callable:
    """grad_fn(master, x, y, step) -> (loss, (ce, aux), grads): the loss of
    one batch and its gradient tree (f32) with respect to ``master``, the
    forward run on the master cast to ``compute_dtype``."""
    _validate_dropout_plan(run)
    _check_dtype(compute_dtype)
    plan = DropoutPlan(run.dropout)
    if sched is None:
        sched = compile_run_schedule(cfg, run, policy)

    def grad_fn(master, x, y, step: int):
        flat = [t.detach().requires_grad_() for t in leaves(master)]
        params = _cast(unflatten_like(master, flat), compute_dtype)
        if policy is not None:
            params = _compute_layout(params, policy)
            x, y = place_batch(x, policy), place_batch(y, policy)
        rt = Runtime(plan=plan, step=int(step), compute_dtype=compute_dtype,
                     probs_dtype=_probs_dtype(run),
                     remat=run.sharding.remat,
                     attn_impl=run.sharding.attn_impl, schedule=sched,
                     policy=policy,
                     moe_seq_dispatch=run.sharding.moe_seq_dispatch)
        with use_policy(policy):
            logits, aux = forward(params, cfg, rt, x)
            ce = cross_entropy(logits, y)
            loss = ce + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, flat)
        if policy is not None:
            # partial sums (a data-parallel mesh's) reduce into the
            # master's layout
            grads = [g.redistribute(f.device_mesh, f.placements)
                     for g, f in zip(grads, flat)]
            loss, ce, aux = (gather_full(t) for t in (loss, ce, aux))
        return (loss.detach(), (ce.detach(), aux.detach()),
                unflatten_like(master, list(grads)))

    return grad_fn


def _compute_layout(params, policy):
    """The step's parameters in the compute layout (``param_specs``): the
    ZeRO-sharded master gathered over 'data', as JAX's compute params are
    (with ``policy.fsdp_params`` they keep the data sharding: ZeRO-3)."""
    from repro_torch.compat import placements
    from repro_torch.distributed.specs import param_specs
    specs = param_specs(params, policy, policy.fsdp_params)
    return tree_map(lambda t, sp: t.redistribute(
        policy.mesh, placements(sp, policy.mesh)), params, specs)


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
    precision). Under a ``policy`` the state is the one
    ``init_train_state(policy=)`` places, and x, y global batches (each
    rank keeps its rows) or DTensors."""
    _validate_dropout_plan(run)
    _check_dtype(compute_dtype)
    micro = run.train.microbatch
    sched = compile_run_schedule(cfg, run, policy)
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
        om["grad_norm"] = gather_full(om["grad_norm"])
        return new_state, {"loss": loss, "ce": ce, "aux": aux, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, run: RunConfig, policy=None,
                   compute_dtype=torch.float32) -> Callable:
    """eval_step(master, x, y) -> mean cross entropy, without dropout, on
    the master cast to ``compute_dtype``."""
    _check_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(master, x, y):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype,
                     policy=policy)
        params = _cast(master, compute_dtype)
        if policy is not None:
            params = _compute_layout(params, policy)
            x, y = place_batch(x, policy), place_batch(y, policy)
        with use_policy(policy):
            logits, _ = forward(params, cfg, rt, x)
            return gather_full(cross_entropy(logits, y))

    return eval_step


def make_serve_step(cfg: ModelConfig, policy=None,
                    compute_dtype=torch.float32) -> Callable:
    """serve_step(params, inputs, caches) -> (logits (B, 1, V), caches):
    one decode token for every sequence (``models.decode_step``)."""
    _check_dtype(compute_dtype)

    @torch.no_grad()
    def serve_step(params, inputs, caches):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype,
                     policy=policy)
        return decode_step(params, cfg, rt, place_batch(inputs, policy),
                           caches)

    return serve_step


def make_prefill_step(cfg: ModelConfig, policy=None,
                      compute_dtype=torch.float32,
                      capacity: int = 0) -> Callable:
    """prefill_step(params, inputs) -> (logits (B, 1, V), caches), the FULL
    caches holding ``capacity`` positions (``models.prefill``)."""
    _check_dtype(compute_dtype)

    @torch.no_grad()
    def prefill_step(params, inputs):
        rt = Runtime(plan=None, step=0, compute_dtype=compute_dtype,
                     policy=policy)
        return prefill(params, cfg, rt, place_batch(inputs, policy),
                       capacity=capacity)

    return prefill_step
