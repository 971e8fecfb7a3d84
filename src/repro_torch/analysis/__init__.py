"""repro_torch.analysis -- the static mask-safety verifier for compiled
DropoutSchedules.

Layer 1 (counters): symbolic Philox counter-space enumeration -- every
planned emission resolved to (salt, shard window, the port's kernel walks)
and proven an exact, collision-free cover of the region it must draw.
Layer 2 (dataflow): a taint walk over the FX graph of the train step,
traced on fake tensors, proving that packed mask bits never escape their
planned scope (the MS-D rules). Neither layer runs a kernel.

Entry points:
  verify_schedule(cfg, sched)  -- raise MaskSafetyError on any finding
                                  (what compile_schedule(verify=True)
                                  calls)
  analyze_schedule(cfg, sched) -- the Layer-1 Report, no raise
  analyze_model(...)           -- the Layer-2 Report (forward and grad
                                  traces)
  analyze_graph(gm, cfg, sched) -- Layer 2 over one traced graph
  analyze_leaky_model(...)     -- Layer 2's MS-D1 negative control
  python -m repro_torch.analysis.lint -- the config-sweep CLI
"""
from __future__ import annotations

from repro_torch.analysis.counters import analyze_schedule, schedule_emissions
from repro_torch.analysis.dataflow import (
    analyze_graph,
    analyze_leaky_model,
    analyze_model,
)
from repro_torch.analysis.rules import (
    ALL_RULES,
    COUNTER_OVERLAP,
    EMISSION_GAP,
    MASK_COLLECTIVE_CROSSING,
    MASK_OPERAND_REPLAY,
    MASK_RESIDUAL_LEAK,
    MASK_TOKEN_GATHER,
    REGION_MISMATCH,
    SALT_COLLISION,
    SHARD_WINDOW_MISMATCH,
    STRIDE_MISMATCH,
    Finding,
    MaskSafetyError,
    Report,
)


def verify_schedule(cfg, sched, cell: str = "") -> Report:
    """Counter-space verification that raises on failure: the hook behind
    ``compile_schedule(..., verify=True)``."""
    report = analyze_schedule(cfg, sched, cell=cell)
    if not report.ok:
        raise MaskSafetyError(report)
    return report


__all__ = [
    "ALL_RULES",
    "COUNTER_OVERLAP",
    "EMISSION_GAP",
    "Finding",
    "MASK_COLLECTIVE_CROSSING",
    "MASK_OPERAND_REPLAY",
    "MASK_RESIDUAL_LEAK",
    "MASK_TOKEN_GATHER",
    "MaskSafetyError",
    "REGION_MISMATCH",
    "Report",
    "SALT_COLLISION",
    "SHARD_WINDOW_MISMATCH",
    "STRIDE_MISMATCH",
    "analyze_graph",
    "analyze_leaky_model",
    "analyze_model",
    "analyze_schedule",
    "schedule_emissions",
    "verify_schedule",
]
