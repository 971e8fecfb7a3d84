"""Compiled per-layer dropout schedule: plan -> compile -> execute.

``compile_schedule`` makes every per-layer producer decision once and
freezes it into a hashable ``DropoutSchedule`` (one ``HostAssignment`` per
layer): which site and physical producer make each layer's mask, whether
the flash consumer replays the counters instead of reading a plane, and --
where a fused kernel was not chosen -- why. The rules are the JAX
package's, so ``explain()`` renders the same text for the same cell.

Ported: a single device, sites "xla" and "qkv", ``attn_impl`` "xla" and
"pallas", the replay upgrade. ``attn_impl="pallas"`` keeps the knob's JAX
name: in the port it selects the hand-written CUDA kernels (fused
GEMM+RNG host, flash forward and backward). Carried sites ("prev_gemm",
"ffn_up", "ffn_down"), "auto" and sharding policies raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

from repro_torch.config.base import (
    CARRIED_DROPOUT_SITES,
    AttentionKind,
    DropoutPlanConfig,
    ModelConfig,
)
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.kernels.gemm_rng import mask_layout_feasible
from repro_torch.kernels.philox_common import threshold_from_p

HOW_GEMM = producer.HOW_GEMM
HOW_STANDALONE = producer.HOW_STANDALONE
HOW_XLA = producer.HOW_XLA
HOW_REPLAY = producer.HOW_REPLAY

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
    def sharded(self) -> bool:
        return any(a.sharded for a in self.assignments)

    @property
    def replay(self) -> bool:
        """True when consumption is counter replay: the flash kernels
        re-derive the bits and no plane is fed to attention."""
        return any(a.how == HOW_REPLAY for a in self.assignments)

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

    def records(self) -> Tuple[Tuple[str, str, str, str], ...]:
        """Deduplicated (site, how, gemm_dtype, note) scheduling records.
        (The JAX package adds its carried sites' emission rows; the port
        has no carried sites yet.)"""
        rows = [(a.site, a.how, self.plan.gemm_dtype, a.reason)
                for a in self.assignments if a.consumes]
        return tuple(dict.fromkeys(rows))

    def explain(self) -> str:
        """Every per-layer decision, one line a layer (the JAX package's
        rendering, character for character)."""
        p = self.plan
        head = (f"dropout schedule: model={self.model} "
                f"batch={self.batch} seq={self.seq} mode={p.mode} "
                f"p={p.p} site={p.site}")
        if p.site != self.resolved_site:
            head += f" -> {self.resolved_site}"
        head += (f" gemm_dtype={p.gemm_dtype} impl={self.attn_impl} "
                 f"carried={'yes' if self.carried else 'no'}")
        lines = [head]
        if not self.active:
            lines.append("  inert: no attention-score dropout to "
                         "schedule")
            return "\n".join(lines)
        for a in self.assignments:
            if not a.consumes:
                lines.append(f"  L{a.layer:<3d} {a.kind:<9s} -")
                continue
            src = ("bootstrap" if a.producer < 0
                   else f"L{a.producer}" if a.producer != a.layer
                   else "in-layer")
            row = (f"  L{a.layer:<3d} {a.kind:<9s} "
                   f"mask<-{src}:{a.site} how={a.how}")
            if a.host_how:
                row += f" host={a.host_how}"
            if a.sharded:
                row += " shard-local"
            if a.reason:
                row += f" ({a.reason})"
            lines.append(row)
        return "\n".join(lines)

    def summary(self) -> Dict:
        """Machine-readable digest of the per-layer assignments."""
        return {
            "model": self.model,
            "site": self.plan.site,
            "resolved_site": self.resolved_site,
            "gemm_dtype": self.plan.gemm_dtype,
            "philox_bits": self.plan.philox_bits,
            "attn_impl": self.attn_impl,
            "batch": self.batch,
            "seq": self.seq,
            "carried": self.carried,
            "sharded": self.sharded,
            "moe_seq_dispatch": self.moe_seq_dispatch,
            "shards": [self.shard.batch_shards, self.shard.head_shards],
            "layers": [
                {"layer": a.layer, "kind": a.kind, "site": a.site,
                 "producer": a.producer, "how": a.how,
                 "sharded": a.sharded,
                 **({"host_how": a.host_how} if a.host_how else {}),
                 **({"reason": a.reason} if a.reason else {})}
                for a in self.assignments if a.consumes
            ],
        }


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: port queue, carried sites / "
        "site='auto' / sharding policies)")


def _kernel_host_gates(plan: DropoutPlan, cfg: ModelConfig, batch: int,
                       seq: int, shard: ShardInfo, attn_impl: str):
    """The gates every kernel-realized host must clear: (how, sharded,
    reason) early-out, or None plus the (b_loc, h_loc) mask tile."""
    if attn_impl != "pallas":
        return (HOW_XLA, False, "impl != pallas (no fused kernels)"), 0, 0
    reason = producer.mask_kernel_unsupported_reason(plan, seq, seq)
    if reason is not None:
        return (HOW_XLA, False, reason), 0, 0
    if shard.policy_installed and not shard.active:
        return (HOW_XLA, False,
                "mask (b, h) not shardable on this mesh"), 0, 0
    return (None, batch // shard.batch_shards,
            cfg.n_heads // shard.head_shards)


def _fused_capability(plan: DropoutPlan, cfg: ModelConfig, batch: int,
                      seq: int, site: str, shard: ShardInfo,
                      attn_impl: str, dense_ffn: Optional[bool] = None
                      ) -> Tuple[str, bool, str]:
    """(how, sharded, reason) for hosting one mask under the ``site`` GEMM
    of one block: tiling and Region 3 judged on the JAX logical grid."""
    early, b_loc, h_loc = _kernel_host_gates(plan, cfg, batch, seq, shard,
                                             attn_impl)
    if early is not None:
        return early
    sharded = shard.policy_installed
    gemm = producer.block_gemm_shapes(cfg, batch, seq,
                                      dense_ffn=dense_ffn).get(site)
    if gemm is None:
        return (HOW_STANDALONE, sharded,
                f"no hostable {site} GEMM in this block")
    m, n, k = gemm
    blocks = producer.pick_gemm_blocks(m, n, k)
    if blocks is None:
        return HOW_XLA, False, f"GEMM ({m},{n},{k}) does not tile"
    bm, bn, _ = blocks
    if not mask_layout_feasible(
            (m // bm) * (n // bn), b_loc, h_loc, seq, seq,
            mask_block_cols=producer.mask_cols_cap(seq, seq)):
        return (HOW_STANDALONE, sharded,
                f"Region 3: GEMM ({m},{n},{k}) too small for "
                f"{b_loc}x{h_loc}x{seq}x{seq} mask")
    if plan.cfg.gemm_dtype != "f32":
        raise NotImplementedError(
            f"gemm_dtype={plan.cfg.gemm_dtype!r} hosts are not ported yet "
            "(ROADMAP: port queue, bf16 hosts / fp8 kernels)")
    return HOW_GEMM, sharded, ""


def _replay_reason(plan: DropoutPlan, cfg: ModelConfig, seq: int,
                   shard: ShardInfo, attn_impl: str) -> Optional[str]:
    """Why this schedule cannot plan HOW_REPLAY consumption, None when it
    can."""
    reason = producer.replay_unsupported_reason(plan, seq, seq,
                                                attn_impl=attn_impl)
    if reason is not None:
        return reason
    if (shard.policy_installed and shard.head_shards > 1
            and cfg.n_kv_heads % shard.head_shards):
        return ("head-sharded mesh without kv-divisible heads "
                "(pallas attention falls back to XLA)")
    return None


def _replay_assignment(a: HostAssignment,
                       consume_sharded: bool) -> HostAssignment:
    """One consuming assignment rewritten for counter-replay consumption:
    HOW_REPLAY, with host_how keeping a fused GEMM host (run, its plane
    discarded). (The JAX package also clears plane-only emissions of
    carried sites, which the port does not have yet.)"""
    if not a.consumes:
        return a
    host_how = a.how if a.how in (HOW_GEMM,
                                  producer.HOW_GEMM_GROUPED) else ""
    return dataclasses.replace(a, how=HOW_REPLAY, host_how=host_how,
                               sharded=consume_sharded, reason="")


@functools.lru_cache(maxsize=256)
def _compile(cfg: ModelConfig, plan_cfg: DropoutPlanConfig, batch: int,
             seq: int, shard: ShardInfo, attn_impl: str,
             moe_seq_dispatch: bool = False) -> DropoutSchedule:
    plan = DropoutPlan(plan_cfg)
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
    site = plan_cfg.site
    if site == "auto":
        raise _not_ported("site='auto'")
    if site in CARRIED_DROPOUT_SITES:
        raise _not_ported(f"carried site {site!r}")
    asgs = []
    for l in range(cfg.n_layers):
        kind = kinds[l]
        if kind not in _ATTN:
            asgs.append(HostAssignment(layer=l, kind=kind.value))
        elif site == "xla":
            asgs.append(HostAssignment(
                layer=l, kind=kind.value, consumes=True, site="xla",
                producer=l, how=HOW_XLA))
        else:                                   # site == "qkv"
            how, sh, reason = _fused_capability(
                plan, cfg, batch, seq, "qkv", shard, attn_impl)
            asgs.append(HostAssignment(
                layer=l, kind=kind.value, consumes=True, site="qkv",
                producer=l, how=how, sharded=sh and how != HOW_XLA,
                reason=reason))
    # zero-HBM upgrade: counter replay at the consumer wherever the flash
    # kernels can reconstruct the producer's counters exactly
    if _replay_reason(plan, cfg, seq, shard, attn_impl) is None:
        consume_sharded = shard.policy_installed and shard.active
        asgs = [_replay_assignment(a, consume_sharded) for a in asgs]
    sched = DropoutSchedule(
        model=cfg.name, plan=plan_cfg, resolved_site=site, batch=batch,
        seq=seq, attn_impl=attn_impl, shard=shard, carried=False,
        assignments=tuple(asgs), moe_seq_dispatch=moe_seq_dispatch)
    _check_scan_periodicity(cfg, sched)
    return sched


def _scan_static_key(a: HostAssignment):
    """The parts of an assignment one stack's shared unit body branches
    on (no carried sites in the port yet)."""
    return (a.kind, a.consumes, a.site, a.how, a.sharded,
            a.how == HOW_REPLAY, a.host_how, a.emit_site, a.emit_stride,
            a.emit_how, a.emit_reason)


def _check_scan_periodicity(cfg: ModelConfig, sched: DropoutSchedule):
    """Every instance of one unit position in a stack must have compiled
    to the same static decision, as in the JAX package (whose layer scan
    compiles one body per stack)."""
    from repro_torch.models.transformer import build_stacks
    for spec in build_stacks(cfg):
        ul = len(spec.unit)
        for j in range(ul):
            ref = sched.for_layer(spec.base + j)
            for pos in range(1, spec.count):
                inst = sched.for_layer(spec.base + pos * ul + j)
                if _scan_static_key(inst) != _scan_static_key(ref):
                    raise AssertionError(
                        "non-periodic schedule inside a stack:\n"
                        f"{ref}\nvs\n{inst}")


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


def inline_assignment(model_cfg: ModelConfig, plan: DropoutPlan,
                      batch: int, seq: int, *, policy=None,
                      attn_impl: str = "xla") -> HostAssignment:
    """Single-layer sugar for a direct ``attn_apply`` call made without a
    compiled schedule: the first consumer's assignment of a uniform
    schedule (carried sites are not ported, so there is no carry to
    drop)."""
    sched = compile_schedule(model_cfg, plan.cfg, batch, seq, policy=policy,
                             attn_impl=attn_impl)
    if not sched.active:
        return HostAssignment(layer=0, kind="full")
    return sched.for_layer(sched.first_consumer)


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
