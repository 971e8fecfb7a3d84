"""The paper's contribution as a composable feature:

dropout_rng — counter-based Philox masks in plain tensor ops, bit-exact
              with the CUDA kernels.
overlap     — DropoutPlan: where RNG runs, and the seed/salt folding.
schedule    — compile_schedule: per-layer producer decisions frozen into a
              hashable DropoutSchedule.
producer    — the physical mask producers the schedule's HOW_* tags name.
attention   — attention cores consuming the plan.
"""
from repro_torch.core.attention import attention_decode, attention_xla
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import (
    DropoutSchedule,
    HostAssignment,
    compile_schedule,
)

__all__ = [
    "DropoutPlan",
    "DropoutSchedule",
    "HostAssignment",
    "attention_decode",
    "attention_xla",
    "compile_schedule",
]
