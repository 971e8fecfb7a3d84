"""Training step functions (the JAX package's ``train.loop``)."""
from repro_torch.train.loop import (
    compile_run_schedule,
    cross_entropy,
    init_train_state,
    make_eval_step,
    make_grad_fn,
    make_train_step,
)

__all__ = ["compile_run_schedule", "cross_entropy", "init_train_state",
           "make_eval_step", "make_grad_fn", "make_train_step"]
