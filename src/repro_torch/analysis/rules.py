"""Rule catalogue and finding / report types of the static mask-safety
verifier: the rule IDs and types of the JAX package's
``repro/analysis/rules.py``, unchanged.

Every check in repro_torch.analysis reports through one of the rule IDs
below, so lint output, tests and CI grep the same stable names as the JAX
package's. Counter-space rules (MS-C*) come from Layer 1 (Philox
counter-interval enumeration over the port's kernel walks,
analysis/counters.py). The dataflow rules (MS-D*) stay declared for Layer
2, a taint walk over the traced step, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------- Layer 1
# Two emissions draw the same (salt, counter-window) bits — a double
# draw: one producer's write races another's (or one grid step writes a
# rectangle another step also writes).
COUNTER_OVERLAP = "MS-C1:counter-overlap"
# A consumer expects mask bits no emission produces (dead emission /
# dropped pipeline stage / uncovered counter rectangle).
EMISSION_GAP = "MS-C2:emission-gap"
# Two distinct (layer, stream) identities fold to the same uint32 salt,
# so their Philox streams collide.
SALT_COLLISION = "MS-C3:salt-collision"
# A shard-local producer's (bh_offset, b_loc, h_loc) window set does not
# tile the global (B, H) mask plane exactly.
SHARD_WINDOW_MISMATCH = "MS-C4:shard-window-mismatch"
# A carried emission's stride does not land on the layer that consumes
# it (producer/consumer linkage broken).
STRIDE_MISMATCH = "MS-C5:stride-mismatch"
# The schedule plans a fused host whose GEMM grid cannot actually host
# the mask (plan/kernel divergence — would execute as Region 3).
REGION_MISMATCH = "MS-C6:region-mismatch"

# ---------------------------------------------------------------- Layer 2
# Mask bits escape their planned scope: saved as an autodiff residual /
# stacked per-layer output / returned from the step function instead of
# living only in the carried scan buffer.
MASK_RESIDUAL_LEAK = "MS-D1:mask-residual-leak"
# Mask bits cross a collective (psum / all_gather / all_to_all / ...) —
# shard-local bits must never leave their shard.
MASK_COLLECTIVE_CROSSING = "MS-D2:mask-collective-crossing"
# Mask bits reach a token-identity-dependent op (gather / scatter /
# sort): bits are position-keyed, so routing them by token identity
# (e.g. MoE dispatch) silently permutes the counter space.
MASK_TOKEN_GATHER = "MS-D3:mask-token-gather"
# A mask-shaped plane is an operand of a pallas_call on a
# replay-planned schedule. Replay's contract is zero mask bytes in HBM:
# the attention kernels re-derive keep bits in-register from a (4,)
# seed-salt word, so any packed plane reaching a kernel as an operand
# means the zero-HBM path silently degraded to premask traffic.
MASK_OPERAND_REPLAY = "MS-D4:mask-operand-on-replay"

ALL_RULES = (
    COUNTER_OVERLAP, EMISSION_GAP, SALT_COLLISION,
    SHARD_WINDOW_MISMATCH, STRIDE_MISMATCH, REGION_MISMATCH,
    MASK_RESIDUAL_LEAK, MASK_COLLECTIVE_CROSSING, MASK_TOKEN_GATHER,
    MASK_OPERAND_REPLAY,
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation: which rule, where, and why."""
    rule: str
    message: str
    layer: Optional[int] = None          # offending consumer/producer
    other_layer: Optional[int] = None    # the paired assignment, if any

    def render(self) -> str:
        loc = ""
        if self.layer is not None:
            loc = f" L{self.layer}"
            if self.other_layer is not None:
                loc += f"/L{self.other_layer}"
        return f"{self.rule}{loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Report:
    """Verdict of one analyzed cell."""
    cell: str                            # e.g. "yi-6b site=auto dtype=f32"
    findings: Tuple[Finding, ...] = ()
    checked_emissions: int = 0
    checked_eqns: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> str:
        head = (f"[{'ok' if self.ok else 'FAIL'}] {self.cell} "
                f"(emissions={self.checked_emissions}"
                + (f", eqns={self.checked_eqns}" if self.checked_eqns
                   else "") + ")")
        return "\n".join([head] + ["  " + f.render()
                                   for f in self.findings])


class MaskSafetyError(AssertionError):
    """Raised by compile_schedule(verify=True) on any finding."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(report.render())
