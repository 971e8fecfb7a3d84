"""Compiled per-layer dropout schedule: plan -> compile -> execute.

``compile_schedule`` makes every per-layer producer decision once and
freezes it into a hashable ``DropoutSchedule`` (one ``HostAssignment`` per
layer). The schedule owns mask identity (``mask_key``), which the serving
mask cache keys on.

Ported so far: a single device with ``attn_impl="xla"``, for the inert
plan and ``site="xla"``. Other sites, ``"auto"``, the Pallas/CUDA
attention path and sharding policies raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.config.base import (
    AttentionKind,
    DropoutPlanConfig,
    ModelConfig,
)
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.kernels.philox_common import threshold_from_p

HOW_XLA = producer.HOW_XLA

_ATTN = (AttentionKind.FULL, AttentionKind.LOCAL)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """How the mask plane's (b, h) dims split over a mesh; the default is
    one device."""
    batch_shards: int = 1
    head_shards: int = 1
    batch_axes: Tuple[str, ...] = ()
    head_axes: Tuple[str, ...] = ()
    policy_installed: bool = False

    @property
    def active(self) -> bool:
        return self.batch_shards * self.head_shards > 1


@dataclasses.dataclass(frozen=True)
class HostAssignment:
    """One layer's slot in the compiled schedule: whether it consumes a
    mask, which site and producer layer make it, the planned physical
    producer (``how``) and, on the emission side, which downstream mask
    this block hosts."""
    layer: int
    kind: str
    consumes: bool = False
    site: str = "none"
    producer: int = -1
    how: str = HOW_XLA
    host_how: str = ""
    sharded: bool = False
    reason: str = ""
    emit_site: Optional[str] = None
    emit_stride: int = 0
    emit_how: str = ""
    emit_reason: str = ""


@dataclasses.dataclass(frozen=True)
class DropoutSchedule:
    """Frozen, hashable artifact of ``compile_schedule``."""
    model: str
    plan: DropoutPlanConfig
    resolved_site: str
    batch: int
    seq: int
    attn_impl: str
    shard: ShardInfo
    carried: bool
    assignments: Tuple[HostAssignment, ...]
    moe_seq_dispatch: bool = False

    @property
    def active(self) -> bool:
        """Overlap-mode plan with at least one mask consumer."""
        return any(a.consumes for a in self.assignments)

    @property
    def first_consumer(self) -> int:
        for a in self.assignments:
            if a.consumes:
                return a.layer
        return -1

    def for_layer(self, layer: int) -> HostAssignment:
        return self.assignments[layer]

    def mask_key(self, layer: int, step: int) -> Tuple[int, ...]:
        """Canonical identity of one layer-step packed mask: (seed, salt,
        layer, step) plus the plan knobs the bits depend on (keep
        threshold, Philox rounds/width). Equal keys mean equal bits,
        whichever producer made them."""
        plan = DropoutPlan(self.plan)
        return (int(plan.step_seed(int(step))),
                int(plan.salt(int(layer))), int(layer), int(step),
                threshold_from_p(self.plan.p), self.plan.philox_rounds,
                self.plan.philox_bits)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: port queue, "
        "compile_schedule beyond site='xla' / attn_impl='xla')")


@functools.lru_cache(maxsize=256)
def _compile(cfg: ModelConfig, plan_cfg: DropoutPlanConfig, batch: int,
             seq: int, shard: ShardInfo, attn_impl: str,
             moe_seq_dispatch: bool = False) -> DropoutSchedule:
    kinds = cfg.layer_kinds()
    attn_layers = [i for i, k in enumerate(kinds) if k in _ATTN]
    overlap = plan_cfg.enabled and plan_cfg.mode == "overlap"
    inert = DropoutSchedule(
        model=cfg.name, plan=plan_cfg, resolved_site=plan_cfg.site,
        batch=batch, seq=seq, attn_impl=attn_impl, shard=shard,
        carried=False,
        assignments=tuple(
            HostAssignment(layer=i, kind=kinds[i].value)
            for i in range(cfg.n_layers)),
        moe_seq_dispatch=moe_seq_dispatch)
    if not overlap or not attn_layers:
        return inert
    if attn_impl != "xla":
        raise _not_ported(f"attn_impl={attn_impl!r}")
    if plan_cfg.site != "xla":
        raise _not_ported(f"site={plan_cfg.site!r}")
    asgs = tuple(
        HostAssignment(layer=l, kind=kinds[l].value, consumes=True,
                       site="xla", producer=l, how=HOW_XLA)
        if kinds[l] in _ATTN else HostAssignment(layer=l,
                                                 kind=kinds[l].value)
        for l in range(cfg.n_layers))
    return DropoutSchedule(
        model=cfg.name, plan=plan_cfg, resolved_site="xla", batch=batch,
        seq=seq, attn_impl=attn_impl, shard=shard, carried=False,
        assignments=asgs, moe_seq_dispatch=moe_seq_dispatch)


def compile_schedule(model_cfg: ModelConfig, plan, batch: int, seq: int,
                     *, policy=None, attn_impl: str = "xla",
                     moe_seq_dispatch: bool = False,
                     shard: Optional[ShardInfo] = None) -> DropoutSchedule:
    """Compile the per-layer dropout schedule for one (model, plan, shape)
    cell. ``plan`` is a DropoutPlanConfig or DropoutPlan. Results are
    cached: the same inputs return the identical object."""
    plan_cfg = plan.cfg if isinstance(plan, DropoutPlan) else plan
    if plan_cfg is None:
        raise ValueError("compile_schedule requires a dropout plan")
    if policy is not None or (shard is not None and shard.policy_installed):
        raise _not_ported("a sharding policy")
    return _compile(model_cfg, plan_cfg, batch, seq, shard or ShardInfo(),
                    attn_impl, moe_seq_dispatch)


@dataclasses.dataclass(frozen=True)
class ScheduleBucket:
    """Hashable shape-bucket key for compiled-schedule caches: every knob
    the structure of a compiled schedule depends on, without the plan
    ``seed`` (per-request identity comes back through
    ``reseed_schedule``)."""
    model: str
    batch: int
    seq: int
    attn_impl: str
    mode: str
    p: float
    site: str
    gemm_dtype: str
    philox_rounds: int
    philox_bits: int
    shard: ShardInfo = ShardInfo()
    moe_seq_dispatch: bool = False

    @staticmethod
    def of(cfg: ModelConfig, plan_cfg: DropoutPlanConfig, batch: int,
           seq: int, *, attn_impl: str = "xla",
           shard: Optional[ShardInfo] = None,
           moe_seq_dispatch: bool = False) -> "ScheduleBucket":
        return ScheduleBucket(
            model=cfg.name, batch=batch, seq=seq, attn_impl=attn_impl,
            mode=plan_cfg.mode, p=plan_cfg.p, site=plan_cfg.site,
            gemm_dtype=plan_cfg.gemm_dtype,
            philox_rounds=plan_cfg.philox_rounds,
            philox_bits=plan_cfg.philox_bits,
            shard=shard or ShardInfo(),
            moe_seq_dispatch=moe_seq_dispatch)


def reseed_schedule(sched: DropoutSchedule, seed: int) -> DropoutSchedule:
    """The same compiled schedule under a different base seed: assignments
    never read the seed, so this is exact."""
    if seed == sched.plan.seed:
        return sched
    return dataclasses.replace(
        sched, plan=dataclasses.replace(sched.plan, seed=seed))
