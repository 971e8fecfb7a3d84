"""End-to-end training driver of the port, with checkpoints and crash
recovery:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
        --reduced --steps 100 --batch 8 --seq 256 --dropout overlap

The flags are the JAX package's (``python -m repro.launch.train``) plus
``--device`` (default ``cuda``: the launcher runs on the card unless asked
for the CPU with ``--device cpu``). Fault tolerance: a checkpoint every
``--ckpt-every`` steps, auto-resume from the latest one, straggler stats
printed at exit.

The order is JAX's: compile the dropout schedule and prove it through the
counter layer (``verify=True``); freeze the dropout contract; on resume,
``verify_resume`` the checkpoint's contract (a changed realization is
re-proven: "recompiled"; a changed mask identity raises
``ContractMismatchError``) and restore; then the ``TrainRunner`` with the
``StragglerDetector``, logging JAX's fields and ending on its ``done:``
line. ``train(run, ...)`` is that path for a ``RunConfig``; ``main``
builds the RunConfig from the flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

from repro_torch.checkpoint import (
    Checkpointer,
    contract_from_schedule,
    verify_resume,
)
from repro_torch.config import (
    DropoutPlanConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    ShardingConfig,
    StepKind,
    TrainConfig,
    get_arch,
)
from repro_torch.data import device_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.fault import (
    RunnerReport,
    StragglerDetector,
    TrainRunner,
)
from repro_torch.train.loop import (
    compile_run_schedule,
    init_train_state,
    make_train_step,
)

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_ckpt")


@dataclasses.dataclass
class TrainResult:
    """What one launch did: the runner's report, the contract's verdict
    on resume ("verified" / "recompiled"; None for a fresh run), the step
    it resumed from, the final state and the wall seconds."""
    report: RunnerReport
    contract_status: Optional[str]
    resumed_from: Optional[int]
    state: dict
    wall_s: float


def build_run(args) -> RunConfig:
    cfg = get_arch(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind=StepKind.TRAIN)
    return RunConfig(
        model=cfg,
        shape=shape,
        sharding=ShardingConfig(remat=args.remat),
        dropout=DropoutPlanConfig(mode=args.dropout, p=args.dropout_p),
        train=TrainConfig(
            optimizer=OptimizerConfig(
                lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                total_steps=args.steps),
            microbatch=args.microbatch,
            checkpoint_every=args.ckpt_every,
            checkpoint_dir=args.ckpt_dir,
            log_every=args.log_every,
            seed=args.seed,
        ),
    )


def train(run: RunConfig, steps: int, *, device: DeviceLike = None,
          checkpointer=None, wrap_step: Optional[Callable] = None
          ) -> TrainResult:
    """Train ``run`` to ``steps`` steps on ``device`` (the card unless
    asked), resuming from the latest checkpoint in
    ``run.train.checkpoint_dir`` (or ``checkpointer``'s directory).
    ``wrap_step`` wraps the train step (a fault injector or a
    recorder)."""
    cfg = run.model
    dev = resolve_device(device)
    seed = run.train.seed
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={dev} dropout={run.dropout.mode}", flush=True)

    # the dropout contract: the frozen mask lineage saved with every
    # checkpoint and verified on every resume and recovery, of a schedule
    # the counter layer has proven
    sched = compile_run_schedule(cfg, run, verify=True)
    contract = contract_from_schedule(cfg, sched)

    state = init_train_state(cfg, seed=seed, device=dev)
    ckpt = checkpointer or Checkpointer(run.train.checkpoint_dir,
                                        async_save=run.train.async_checkpoint)
    latest = ckpt.latest_step()
    status = None
    if latest is not None:
        saved = ckpt.load_contract(latest)
        if saved is not None:
            # ContractMismatchError propagates: resuming would replay
            # different mask bits than the checkpointed trajectory
            status = verify_resume(saved, contract, cfg=cfg, sched=sched)
            print(f"[train] dropout contract {status} for step {latest}",
                  flush=True)
        print(f"[train] resuming from step {latest}", flush=True)
        state = ckpt.restore(latest, state)

    step_fn = make_train_step(cfg, run)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)

    def batch_fn(step):
        return device_batch(cfg, run.shape, step, seed=seed, device=dev)

    straggler = StragglerDetector()
    t_start = time.perf_counter()
    last = {"t": t_start, "step": int(state["step"])}
    log_every = run.train.log_every

    def logging_step(state, x, y):
        state, metrics = step_fn(state, x, y)
        step = int(state["step"])
        if step % log_every == 0:
            now = time.perf_counter()
            dt = now - last["t"]
            n = step - last["step"]
            tok_s = (n * run.shape.global_batch * run.shape.seq_len
                     / max(dt, 1e-9))
            print(f"[train] step={step} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} tok/s={tok_s:,.0f}",
                  flush=True)
            last["t"], last["step"] = now, step
        return state, metrics

    runner = TrainRunner(logging_step, state, batch_fn, ckpt,
                         checkpoint_every=run.train.checkpoint_every,
                         straggler=straggler,
                         contract=contract, model_cfg=cfg, schedule=sched)
    report = runner.run(steps)
    wall = time.perf_counter() - t_start
    print(f"[train] done: steps={report.steps_completed} "
          f"restarts={report.restarts} "
          f"stragglers={report.straggler_steps} "
          f"failed_saves={report.failed_saves} wall={wall:.1f}s "
          f"final_loss={report.final_metrics.get('loss', float('nan')):.4f}",
          flush=True)
    return TrainResult(report=report, contract_status=status,
                       resumed_from=latest, state=runner.state, wall_s=wall)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="block", choices=("none", "block"))
    ap.add_argument("--dropout", default="overlap",
                    choices=("none", "fused", "overlap"))
    ap.add_argument("--dropout-p", type=float, default=0.1)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return train(build_run(args), args.steps, device=args.device)


if __name__ == "__main__":
    main()
