"""Compiled per-layer dropout schedule: plan -> compile -> execute.

``compile_schedule`` makes every per-layer producer decision once and
freezes it into a hashable ``DropoutSchedule`` (one ``HostAssignment`` per
layer): which site and physical producer make each layer's mask, whether
the flash consumer replays the counters instead of reading a plane, and --
where a fused kernel was not chosen -- why. The rules are the JAX
package's, so ``explain()`` renders the same text for the same cell.

Ported: a single device; sites "xla", "qkv" and the carried sites
("prev_gemm", "ffn_up", "ffn_down": layer l+1's mask is made under a GEMM
of layer l's block and carried to it, the first consumer bootstrapping
from the standalone producer), with MoE expert and RWKV channel-mix FFNs
hosting "ffn_up" / "ffn_down" through the grouped kernel; ``gemm_dtype``
"f32", "bf16" and "fp8" (dense and grouped hosts); ``attn_impl`` "xla" and
"pallas"; the replay upgrade. ``attn_impl="pallas"`` keeps the knob's JAX
name: in the port it selects the hand-written CUDA kernels (fused and
grouped GEMM+RNG hosts, flash forward and backward). A sharding
``policy`` (or a bare ``ShardInfo``, for a mesh this process does not hold)
plans the mesh's shard-local producers as JAX's compiler does, from
``mask_plane_shards`` (``shard_info``); the lint's topology sweep proves
those plans. ``site="auto"`` resolves as JAX's does: the block's
candidate host GEMMs ranked by the perf model (``producer.rank_host_sites``
on ``hw``, the active tuned table's calibrated hardware, or ``GH100``),
the ranking shown in ``explain()``. ``compile_schedule(..., verify=True)``
proves the plan through the counter layer (``repro_torch.analysis``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

from repro_torch.config.base import (
    CARRIED_DROPOUT_SITES,
    AttentionKind,
    DropoutPlanConfig,
    FFNKind,
    ModelConfig,
)
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.kernels import quant
from repro_torch.kernels.gemm_rng import mask_layout_feasible
from repro_torch.kernels.philox_common import threshold_from_p

HOW_GEMM = producer.HOW_GEMM
HOW_GEMM_GROUPED = producer.HOW_GEMM_GROUPED
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


def shard_info(policy, batch: int, n_heads: int) -> ShardInfo:
    """Distill a ShardingPolicy into the mask plane's shard layout."""
    if policy is None:
        return ShardInfo()
    from repro_torch.distributed.sharding import mask_plane_shards
    (b_axes, nb), (h_axes, nh) = mask_plane_shards(policy, batch, n_heads)
    return ShardInfo(batch_shards=nb, head_shards=nh, batch_axes=b_axes,
                     head_axes=h_axes, policy_installed=True)


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
    headroom: Tuple[Tuple[str, float], ...] = ()   # site="auto" ranking
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
        """Deduplicated (site, how, gemm_dtype, note) scheduling records,
        consumption and emission rows in layer order."""
        dtype = self.plan.gemm_dtype
        rows = []
        for a in self.assignments:
            if a.consumes:
                rows.append((a.site, a.how, dtype, a.reason))
            if a.emit_site is not None:
                rows.append((a.emit_site, a.emit_how, dtype, a.emit_reason))
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
        if self.shard.policy_installed:
            s = self.shard
            lines.append(
                f"  sharding: mask plane (b x h) = "
                f"{s.batch_shards} x {s.head_shards} shards "
                f"(batch axes {list(s.batch_axes)}, "
                f"head axes {list(s.head_axes)}) -> "
                + ("shard-local producers" if self.sharded
                   else "replicated/XLA producers"))
        for site, hr in self.headroom:
            lines.append(f"  auto candidate {site}: "
                         f"headroom {hr * 1e6:+.2f}us")
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
            if a.emit_site is not None:
                tgt = a.layer + a.emit_stride
                tgt_s = f"L{tgt}" if tgt < len(self.assignments) \
                    else "dropped"
                row += (f" | emits->{tgt_s} under {a.emit_site} "
                        f"how={a.emit_how}")
                # a bootstrap layer shares one reason between its consume
                # and emit halves: print it once
                if a.emit_reason and a.emit_reason != a.reason:
                    row += f" ({a.emit_reason})"
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
                 **({"reason": a.reason} if a.reason else {}),
                 **({"emit_site": a.emit_site,
                     "emit_to": a.layer + a.emit_stride,
                     "emit_how": a.emit_how} if a.emit_site else {})}
                for a in self.assignments if a.consumes
            ],
        }


def _next_attn_stride(kinds: Tuple[AttentionKind, ...], period: int,
                      l: int) -> int:
    """Distance from layer l to the next attention layer in the periodic
    extension of the block pattern. For the last attention layer this
    walks past n_layers: its emission runs and has no consumer."""
    for d in range(1, period + 1):
        if kinds[(l + d) % period] in _ATTN:
            return d
    return 0


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
    # a planned shard's rows follow the batch shards, its columns the head
    # shards (the local grid; m, n themselves on one device)
    m, n, k = producer.shard_host_gemm(m, n, k, shard.batch_shards,
                                       shard.head_shards)
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
    _check_host_dtype(plan)
    return HOW_GEMM, sharded, ""


def _check_host_dtype(plan: DropoutPlan) -> None:
    """Raise for a host dtype the port has no kernel for: fp8 in a torch
    build without e4m3."""
    if plan.cfg.gemm_dtype == "fp8" and not quant.have_fp8():
        raise NotImplementedError(
            "gemm_dtype='fp8' needs torch.float8_e4m3fn, which this torch "
            "build lacks")


def _grouped_capability(plan: DropoutPlan, cfg: ModelConfig, batch: int,
                        seq: int, site: str, shard: ShardInfo,
                        attn_impl: str, moe_seq_dispatch: bool = False,
                        block_is_moe: Optional[bool] = None
                        ) -> Tuple[str, bool, str]:
    """(how, sharded, reason) for hosting one mask under the GROUPED GEMM
    of a block whose FFN has no dense 2D host: the MoE expert einsum or the
    RWKV channel-mix key / value GEMM (E=1). Feasibility is judged on the
    (E, C) grid the dispatch walks (producer.grouped_host_shapes); each
    infeasible shape reports a reason naming its block kind (MoE expert vs
    RWKV channel-mix). ``block_is_moe`` is the layer's own judgment: a MoE
    stack's first-dense layers plan on their E=1 channel-mix grid."""
    if block_is_moe is None:
        block_is_moe = cfg.moe is not None
    kind_name = "MoE expert" if block_is_moe else "RWKV channel-mix"
    early, b_loc, h_loc = _kernel_host_gates(plan, cfg, batch, seq, shard,
                                             attn_impl)
    if early is not None:
        return early
    sharded = shard.policy_installed
    g = producer.grouped_host_shapes(
        cfg, batch, seq, batch_shards=shard.batch_shards,
        head_shards=shard.head_shards, seq_dispatch=moe_seq_dispatch,
        moe_block=block_is_moe).get(site)
    if g is None:
        return (HOW_STANDALONE, sharded,
                f"no hostable {site} GEMM in this block")
    e, c, kdim, n = g
    feasible, blocks = producer.grouped_layout_feasible(
        e, c, kdim, n, b_loc, h_loc, seq, seq)
    if blocks is None:
        return (HOW_STANDALONE, sharded,
                f"{kind_name} grouped GEMM ({e}x({c},{kdim})x({kdim},{n}))"
                f" does not tile")
    if not feasible:
        return (HOW_STANDALONE, sharded,
                f"Region 3: {kind_name} grouped GEMM "
                f"({e}x({c},{kdim})x({kdim},{n})) too small for "
                f"{b_loc}x{h_loc}x{seq}x{seq} mask")
    _check_host_dtype(plan)
    return HOW_GEMM_GROUPED, sharded, ""


def _standalone_capability(plan: DropoutPlan, shard: ShardInfo, seq: int,
                           attn_impl: str) -> Tuple[str, bool, str]:
    """(how, sharded, reason) for a standalone (bootstrap / Region-3)
    producer."""
    if attn_impl != "pallas":
        return HOW_XLA, False, "impl != pallas (no fused kernels)"
    reason = producer.mask_kernel_unsupported_reason(plan, seq, seq,
                                                     fused=False)
    if reason is not None:
        return HOW_XLA, False, reason
    if shard.policy_installed and not shard.active:
        return HOW_XLA, False, "mask (b, h) not shardable on this mesh"
    return HOW_STANDALONE, shard.policy_installed, ""


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
    """One assignment rewritten for counter-replay consumption: the
    consuming side becomes HOW_REPLAY, with host_how keeping a fused GEMM
    host (run, its plane discarded); emissions whose only purpose was the
    plane (standalone / tensor-op) are cleared, GEMM-hosted ones stay (the
    RNG keeps hiding under the GEMM)."""
    changes = {}
    if a.consumes:
        host_how = a.how if a.how in (HOW_GEMM, HOW_GEMM_GROUPED) else ""
        changes.update(how=HOW_REPLAY, host_how=host_how,
                       sharded=consume_sharded, reason="")
    if a.emit_site is not None and a.emit_how not in (HOW_GEMM,
                                                      HOW_GEMM_GROUPED):
        changes.update(emit_site=None, emit_stride=0, emit_how="",
                       emit_reason="")
    return dataclasses.replace(a, **changes) if changes else a


def _resolve_auto(cfg: ModelConfig, plan: DropoutPlan, batch: int,
                  seq: int, shard: ShardInfo, attn_impl: str, hw,
                  moe_seq_dispatch: bool = False):
    """site="auto": rank the block's candidate host GEMMs by the perf
    model (``producer.rank_host_sites`` -> ``perfmodel.rank_host_gemms``)
    and take the best one; "xla" when none qualifies. The shard counts and
    dispatch layout ride along so the grouped candidates are ranked on the
    grid the per-layer capability later judges (the JAX package's
    function)."""
    if attn_impl != "pallas":
        return "xla", ()
    if producer.mask_kernel_unsupported_reason(plan, seq, seq) is not None:
        return "xla", ()
    if shard.policy_installed and not shard.active:
        return "xla", ()
    ranked = producer.rank_host_sites(cfg, plan, batch, seq, hw=hw,
                                      batch_shards=shard.batch_shards,
                                      head_shards=shard.head_shards,
                                      seq_dispatch=moe_seq_dispatch)
    return (ranked[0][0], ranked) if ranked else ("xla", ())


@functools.lru_cache(maxsize=256)
def _compile(cfg: ModelConfig, plan_cfg: DropoutPlanConfig, batch: int,
             seq: int, shard: ShardInfo, attn_impl: str, hw,
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
    headroom: Tuple[Tuple[str, float], ...] = ()
    if site == "auto":
        site, headroom = _resolve_auto(cfg, plan, batch, seq, shard,
                                       attn_impl, hw, moe_seq_dispatch)
    carried = site in CARRIED_DROPOUT_SITES
    moe_first_dense = cfg.moe.first_dense_layers if cfg.moe else 0
    period = len(cfg.block_pattern)
    asgs = []
    for l in range(cfg.n_layers):
        kind = kinds[l]
        if kind not in _ATTN:
            asgs.append(HostAssignment(layer=l, kind=kind.value))
        elif site == "xla":
            asgs.append(HostAssignment(
                layer=l, kind=kind.value, consumes=True, site="xla",
                producer=l, how=HOW_XLA))
        elif site == "qkv":
            how, sh, reason = _fused_capability(
                plan, cfg, batch, seq, "qkv", shard, attn_impl)
            asgs.append(HostAssignment(
                layer=l, kind=kind.value, consumes=True, site="qkv",
                producer=l, how=how, sharded=sh and how != HOW_XLA,
                reason=reason))
        else:
            # carried: my mask comes from the previous attention layer's
            # emission (the standalone bootstrap for the first one), and
            # my block emits the next attention layer's under its ``site``
            # GEMM: the dense fused kernel, or the grouped kernel for MoE
            # expert and RWKV channel-mix FFNs
            block_is_moe = cfg.moe is not None and l >= moe_first_dense
            if site in ("ffn_up", "ffn_down") and (
                    block_is_moe or cfg.ffn == FFNKind.RWKV_CHANNEL):
                e_how, _, e_reason = _grouped_capability(
                    plan, cfg, batch, seq, site, shard, attn_impl,
                    moe_seq_dispatch=moe_seq_dispatch,
                    block_is_moe=block_is_moe)
            else:
                # a MoE stack's first-dense layers carry a dense FFN
                dense_ffn = True if (cfg.moe is not None
                                     and not block_is_moe) else None
                e_how, _, e_reason = _fused_capability(
                    plan, cfg, batch, seq, site, shard, attn_impl,
                    dense_ffn=dense_ffn)
            emit = dict(emit_site=site,
                        emit_stride=_next_attn_stride(kinds, period, l),
                        emit_how=e_how, emit_reason=e_reason)
            prev = max((a for a in attn_layers if a < l), default=-1)
            if prev < 0:
                how, sh, reason = _standalone_capability(plan, shard, seq,
                                                         attn_impl)
                asgs.append(HostAssignment(
                    layer=l, kind=kind.value, consumes=True,
                    site="standalone", producer=-1, how=how,
                    sharded=sh and how != HOW_XLA,
                    reason=reason or "bootstrap: no producer GEMM before "
                                     "the first attention layer", **emit))
            else:
                p_how = asgs[prev].emit_how
                asgs.append(HostAssignment(
                    layer=l, kind=kind.value, consumes=True, site=site,
                    producer=prev, how=p_how,
                    sharded=(p_how != HOW_XLA and shard.policy_installed
                             and shard.active),
                    reason=asgs[prev].emit_reason, **emit))
    # zero-HBM upgrade: counter replay at the consumer wherever the flash
    # kernels can reconstruct the producer's counters exactly
    if _replay_reason(plan, cfg, seq, shard, attn_impl) is None:
        consume_sharded = shard.policy_installed and shard.active
        asgs = [_replay_assignment(a, consume_sharded) for a in asgs]
    sched = DropoutSchedule(
        model=cfg.name, plan=plan_cfg, resolved_site=site, batch=batch,
        seq=seq, attn_impl=attn_impl, shard=shard, carried=carried,
        assignments=tuple(asgs), headroom=headroom,
        moe_seq_dispatch=moe_seq_dispatch)
    _check_scan_periodicity(cfg, sched)
    return sched


def _scan_static_key(a: HostAssignment):
    """The parts of an assignment one stack's shared unit body branches
    on. Consuming a carried mask and the standalone bootstrap are the same
    code path (read the carry), so the bootstrap's consumption fields are
    no periodicity violation; the emission side and the in-layer sites
    must match exactly."""
    carries = a.site in CARRIED_DROPOUT_SITES or a.site == "standalone"
    return (a.kind, a.consumes, "carry" if carries else a.site,
            None if carries else a.how,
            None if carries else a.sharded,
            a.how == HOW_REPLAY, None if carries else a.host_how,
            a.emit_site, a.emit_stride, a.emit_how, a.emit_reason)


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
                     *, policy=None, attn_impl: str = "xla", hw=None,
                     moe_seq_dispatch: bool = False, verify: bool = False,
                     shard: Optional[ShardInfo] = None) -> DropoutSchedule:
    """Compile the per-layer dropout schedule for one (model, plan, shape)
    cell. ``plan`` is a DropoutPlanConfig or DropoutPlan (site may be
    "auto"; ``hw`` the ``perfmodel.Hardware`` it is ranked on, default the
    active tuned table's or ``GH100``). Results are cached: the same
    inputs return the identical object (``clear_cache``; installing a
    tuned table clears it).

    ``verify=True`` runs the static mask-safety verifier's counter layer
    (``repro_torch.analysis``) over the compiled schedule and raises
    ``repro_torch.analysis.MaskSafetyError`` on any finding: integer
    arithmetic over the kernels' walks, no kernel runs.

    ``policy`` is the installed ShardingPolicy (or None): its mask-plane
    layout (``shard_info``) plans the shard-local producers the forward
    then runs under it. ``shard`` plans for a mesh this process does not
    hold (the pure arithmetic the lint's topology sweep and a resharded
    restore's contract check use); the two are mutually exclusive."""
    plan_cfg = plan.cfg if isinstance(plan, DropoutPlan) else plan
    if plan_cfg is None:
        raise ValueError("compile_schedule requires a dropout plan")
    if shard is not None and policy is not None:
        raise ValueError("pass either policy or shard, not both")
    if shard is None:
        shard = shard_info(policy, batch, model_cfg.n_heads)
    sched = _compile(model_cfg, plan_cfg, batch, seq, shard, attn_impl, hw,
                     moe_seq_dispatch)
    if verify:
        # imported lazily: the analysis imports this module
        from repro_torch.analysis import verify_schedule
        verify_schedule(model_cfg, sched)
    return sched


def inline_assignment(model_cfg: ModelConfig, plan: DropoutPlan,
                      batch: int, seq: int, *, policy=None,
                      attn_impl: str = "xla") -> HostAssignment:
    """Single-layer sugar for a direct ``attn_apply`` call made without a
    compiled schedule: the first consumer's assignment of a uniform
    schedule, minus the carry (a lone call has no carried plane, so a
    carried site degrades to the standalone producer, same bits)."""
    sched = compile_schedule(model_cfg, plan.cfg, batch, seq, policy=policy,
                             attn_impl=attn_impl)
    if not sched.active:
        return HostAssignment(layer=0, kind="full")
    asg = sched.for_layer(sched.first_consumer)
    if asg.site in CARRIED_DROPOUT_SITES and asg.how != HOW_REPLAY:
        # (a replay consumer needs no carry at all: keep it as it is)
        how, sh, reason = _standalone_capability(plan, sched.shard, seq,
                                                 attn_impl)
        asg = dataclasses.replace(
            asg, site="standalone", how=how,
            sharded=sh and how != HOW_XLA,
            reason=reason or "no scan carry outside the model")
    return asg


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


def clear_cache() -> None:
    """Drop compiled schedules (a tuned table's install does: a schedule
    embeds its block and site choices)."""
    _compile.cache_clear()
