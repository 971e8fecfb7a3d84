"""Fault-injection harness for the determinism guarantee (the JAX
package's ``repro/distributed/chaos.py``, with the elastic re-mesh of its
tests as ``remesh_segment``).

The paper's counter-based RNG makes dropout masks pure functions of
(seed, salt, layer, step, b, h, q, k), so a crashed-and-recovered run
must reproduce the uninterrupted run bit for bit, not approximately.
This module injects the failures and proves the bits:

  * ``ChaosMonkey`` kills training steps mid-forward (before the step
    function runs — the step never happened) and mid-backward (after the
    new state is computed but before it is kept — recovery must re-run
    the step identically), and delays steps to trip the straggler
    detector.
  * ``ChaosCheckpointer`` kills the async checkpoint write itself after
    the tmp file is written but before the atomic publish — exercising
    both the atomicity guarantee (no partial checkpoint is ever visible)
    and TrainRunner's failed-save fallback path (CheckpointWriteError is
    counted, not charged to the restart budget).
  * ``remesh_segment`` runs one topology's stretch of an elastic run:
    restore the last checkpoint onto this topology (a mesh, or one
    device), gate it on the dropout contract (``verify_resume`` returns
    "recompiled" when the topology changed: same bits, new producers,
    proven by the static verifier), train, and save with this topology's
    contract. 1 rank -> 2 ranks -> 1 rank lands on the uninterrupted
    single-device run (bitwise planes, floats to the last ulps).
  * ``TrajectoryRecorder`` captures the bitwise observables per executed
    step -- the float32 loss bit pattern and a sha256 digest of the probe
    layer's packed dropout mask (made by the standalone producer:
    ``csrc/philox_mask.cu`` on the card; its bytes, and so its digest, are
    the JAX recorder's) -- and verifies every replayed step reproduces
    them exactly; ``assert_identical`` compares two full trajectories.

CLI demo (the reduced llama2; on the card unless asked for the CPU):

    PYTHONPATH=src python -m repro_torch.distributed.chaos --device cpu
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer, \
    CheckpointWriteError
from repro_torch.device import DeviceLike
from repro_torch.distributed.fault import sync

PHASES = ("forward", "backward", "ckpt-write", "delay")


class ChaosError(RuntimeError):
    """The injected failure — distinct from real errors so tests can
    assert only planned faults fired."""


class TrajectoryMismatch(AssertionError):
    """A recovered/replayed step produced different bits than the
    original — the determinism guarantee is broken."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned failure: at ``step``, during ``phase``. ``delay_s``
    only applies to phase "delay" (a straggler, not a crash)."""
    step: int
    phase: str
    delay_s: float = 0.0

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(
                f"Fault.phase={self.phase!r}; expected one of {PHASES}")


class ChaosMonkey:
    """Wraps a train step with scheduled faults, keyed by the state's
    own step counter (so a replayed step after recovery does NOT re-fire
    a consumed fault). ``injected`` logs (step, phase) in firing
    order."""

    def __init__(self, faults: Iterable[Fault]):
        self.pending: Dict[int, Fault] = {}
        for f in faults:
            if f.phase == "ckpt-write":
                raise ValueError(
                    "ckpt-write faults are injected by "
                    "ChaosCheckpointer(kill_steps=...), not ChaosMonkey")
            if f.step in self.pending:
                raise ValueError(f"duplicate fault for step {f.step}")
            self.pending[f.step] = f
        self.injected: List[Tuple[int, str]] = []

    def wrap_step(self, step_fn):

        def chaotic_step(state, x, y):
            step = int(state["step"])
            fault = self.pending.get(step)
            if fault is not None:
                del self.pending[fault.step]
                self.injected.append((fault.step, fault.phase))
                if fault.phase == "forward":
                    # the step never ran: no state was produced
                    raise ChaosError(
                        f"injected mid-forward kill at step {step}")
                if fault.phase == "delay":
                    time.sleep(fault.delay_s)
                    return step_fn(state, x, y)
                # mid-backward: the step fully computes its new state,
                # then the node dies before the result is kept —
                # recovery must re-run this step with identical bits
                new_state, metrics = step_fn(state, x, y)
                sync(metrics["loss"])
                raise ChaosError(
                    f"injected mid-backward kill at step {step}")
            return step_fn(state, x, y)

        return chaotic_step


class ChaosCheckpointer(Checkpointer):
    """Checkpointer whose write crashes mid-flight for configured steps:
    the tmp file is written, then the failure fires BEFORE the atomic
    publish — the previous checkpoint must remain the newest visible
    one. Each kill fires once (popped), so a retried save succeeds."""

    def __init__(self, directory: str, kill_steps: Iterable[int] = (),
                 **kw):
        super().__init__(directory, **kw)
        self.kill_steps = set(kill_steps)
        self.killed_writes: List[int] = []

    def _write(self, step: int, host_state):
        if step in self.kill_steps:
            self.kill_steps.discard(step)
            self.killed_writes.append(step)
            import os
            tmp = os.path.join(self.directory, f"tmp.{step}")
            with open(tmp, "wb") as f:
                np.savez(f, **host_state)
            # surfaced as CheckpointWriteError at the next wait()
            self._error = CheckpointWriteError(
                f"injected mid-write kill for checkpoint {step} "
                "(tmp written, never published)")
            return
        super()._write(step, host_state)


class TrajectoryRecorder:
    """Bitwise trajectory of one training run: per executed step, the
    float32 loss bit pattern and a sha256 digest of the probe layer's
    packed dropout mask (recomputed from the plan's counters — the bits
    the schedule will feed that step's attention). A step recorded twice
    (crash recovery replays it) must reproduce both exactly, else
    TrajectoryMismatch."""

    def __init__(self, plan, batch: int, n_heads: int, sq: int, sk: int,
                 probe_layer: int = 0, device: DeviceLike = None):
        self.plan = plan
        self.device = device
        self.shape = (batch, n_heads, sq, sk)
        self.probe_layer = probe_layer
        self.loss_bits: Dict[int, int] = {}
        self.mask_digest: Dict[int, str] = {}
        self.replays = 0

    def _digest(self, step: int) -> str:
        from repro_torch.core.producer import standalone_packed_mask
        b, h, sq, sk = self.shape
        mask = standalone_packed_mask(self.plan, b, h, sq, sk,
                                      self.probe_layer, step,
                                      device=self.device)
        return hashlib.sha256(mask.cpu().numpy().tobytes()).hexdigest()

    def record(self, step: int, loss) -> None:
        bits = int(np.float32(float(loss)).view(np.uint32))
        digest = self._digest(step)
        if step in self.loss_bits:
            self.replays += 1
            if self.loss_bits[step] != bits:
                raise TrajectoryMismatch(
                    f"step {step}: replayed loss bits "
                    f"{bits:#010x} != original "
                    f"{self.loss_bits[step]:#010x}")
            if self.mask_digest[step] != digest:
                raise TrajectoryMismatch(
                    f"step {step}: replayed mask digest differs -- the "
                    "resumed run is drawing different dropout bits")
            return
        self.loss_bits[step] = bits
        self.mask_digest[step] = digest

    def wrap_step(self, step_fn):
        """Record from inside the step pipeline (wrap below ChaosMonkey
        so a mid-backward kill records the computed step and recovery
        verifies the replay)."""

        def recording_step(state, x, y):
            step = int(state["step"])
            new_state, metrics = step_fn(state, x, y)
            self.record(step, metrics["loss"])
            return new_state, metrics

        return recording_step

    def assert_identical(self, other: "TrajectoryRecorder") -> None:
        """Both runs visited the same steps with identical bits."""
        if set(self.loss_bits) != set(other.loss_bits):
            raise TrajectoryMismatch(
                f"step sets differ: {sorted(self.loss_bits)} vs "
                f"{sorted(other.loss_bits)}")
        for step in sorted(self.loss_bits):
            if self.loss_bits[step] != other.loss_bits[step]:
                raise TrajectoryMismatch(
                    f"step {step}: loss bits "
                    f"{self.loss_bits[step]:#010x} vs "
                    f"{other.loss_bits[step]:#010x}")
            if self.mask_digest[step] != other.mask_digest[step]:
                raise TrajectoryMismatch(
                    f"step {step}: mask digests differ")


def remesh_segment(cfg, run, directory: str, start: int, stop: int,
                   batch_fn, policy=None, seed: int = 0, device=None):
    """Steps [start, stop) of an elastic run on this topology (``policy``'s
    mesh, or one device): restore checkpoint ``start`` from ``directory``
    (none at step 0) placed by ``train_state_specs``, gated by
    ``verify_resume`` against this topology's contract; train; save
    checkpoint ``stop`` with that contract (every rank of a mesh calls
    this; rank 0 writes). Returns (the gate's verdict or None, the losses,
    the final state)."""
    from repro_torch.checkpoint import (Checkpointer, contract_from_schedule,
                                        verify_resume)
    from repro_torch.distributed.specs import to_shardings, \
        train_state_specs
    from repro_torch.train.loop import (compile_run_schedule,
                                        init_train_state, make_train_step)
    sched = compile_run_schedule(cfg, run, policy)
    contract = contract_from_schedule(cfg, sched)
    ckpt = Checkpointer(directory, async_save=False)
    state = init_train_state(cfg, seed=seed, device=device, policy=policy)
    verdict = None
    if start > 0:
        verdict = verify_resume(ckpt.load_contract(start), contract,
                                cfg=cfg, sched=sched)
        shardings = None if policy is None else to_shardings(
            train_state_specs(state, policy, fsdp=False), policy.mesh)
        state = ckpt.restore(start, state, shardings=shardings)
    step_fn = make_train_step(cfg, run, policy=policy)
    losses = []
    for s in range(start, stop):
        state, m = step_fn(state, *batch_fn(s))
        losses.append(float(m["loss"]))
    ckpt.save(stop, state, contract=contract)
    return verdict, losses, state


def main(argv=None) -> int:
    """Demo: a reduced llama2 run with a mid-forward, a mid-backward and a
    mid-checkpoint-write kill recovers to the bitwise trajectory of an
    uninterrupted reference."""
    import argparse
    import tempfile

    import torch

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
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.data import batch_for_step
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault import TrainRunner
    from repro_torch.train import init_train_state, make_train_step

    ap = argparse.ArgumentParser(prog="python -m repro_torch.distributed."
                                      "chaos")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch("llama2-7b", reduced=True)
    shape = ShapeConfig("chaos", seq_len=32, global_batch=2,
                        kind=StepKind.TRAIN)
    run = RunConfig(model=cfg, shape=shape,
                    dropout=DropoutPlanConfig(mode="overlap", p=0.1),
                    sharding=ShardingConfig(remat="block"),
                    train=TrainConfig(optimizer=OptimizerConfig(
                        lr=1e-3, warmup_steps=2, total_steps=30)))
    step_fn = make_train_step(cfg, run)
    plan = DropoutPlan(run.dropout)

    def batch_fn(step):
        x, y = batch_for_step(cfg, shape, step)
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device))

    n_steps = 12

    def trajectory(faults, ckpt_kills, tmpdir):
        rec = TrajectoryRecorder(plan, shape.global_batch, cfg.n_heads,
                                 shape.seq_len, shape.seq_len,
                                 device=device)
        monkey = ChaosMonkey(faults)
        ckpt = ChaosCheckpointer(tmpdir, kill_steps=ckpt_kills,
                                 async_save=True)
        state = init_train_state(cfg, seed=0, device=device)
        runner = TrainRunner(
            monkey.wrap_step(rec.wrap_step(step_fn)), state, batch_fn,
            ckpt, checkpoint_every=4, max_restarts=5)
        report = runner.run(n_steps)
        return rec, report

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref, _ = trajectory((), (), d1)
        faults = (Fault(5, "forward"), Fault(7, "backward"))
        rec, report = trajectory(faults, {8}, d2)
    # the chaotic run replays steps after each recovery; every step's
    # first recording is held against the reference
    ref.assert_identical(rec)
    print(f"[chaos] steps={report.steps_completed} "
          f"restarts={report.restarts} "
          f"failed_saves={report.failed_saves} "
          f"replayed={rec.replays} -- trajectories bitwise identical")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
