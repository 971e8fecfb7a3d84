"""AdamW on f32 master parameters (the JAX package's ``optim``)."""
from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    schedule_lr,
)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "schedule_lr"]
