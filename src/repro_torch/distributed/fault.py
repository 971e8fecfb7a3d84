"""Fault-tolerance runtime: straggler detection, heartbeats, and the
crash-recovering training runner (the JAX package's
``repro/distributed/fault.py``).

The failure model: (a) hard node loss -> restart from the latest
checkpoint; (b) stragglers -> detect from step-time outliers; (c) silent
stalls -> heartbeat timeout. This module implements the control logic in
a process-local form that the tests drive with injected failures; the same
interfaces would sit on top of a cluster coordinator in deployment.

Where the JAX runner reads the step with ``jax.device_get`` and ends a
step with ``jax.block_until_ready``, the port's step is a host int and a
step ends with a synchronize on the loss's device, so a step's time is
the device's finished work. ``Heartbeat`` writes its beat to a temporary
file and renames it into place: a reader never sees the truncated file
that the JAX package's open-for-write leaves between truncate and write.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Callable, Deque, List, Optional

import torch


def sync(value) -> None:
    """Wait for the work behind ``value``: a synchronize on its CUDA
    device; nothing for a CPU tensor or a host number."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


class StragglerDetector:
    """Flags step times exceeding median + k * MAD over a sliding window.

    MAD-based (not mean/std) so a few slow steps don't inflate the
    threshold — the standard robust choice for straggler detection.
    """

    def __init__(self, window: int = 50, k: float = 6.0, warmup: int = 5):
        self.window = window
        self.k = k
        self.warmup = warmup
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.flagged: List[int] = []
        self._count = 0

    def observe(self, duration_s: float) -> bool:
        """Record a step duration; True if it is a straggler step."""
        self._count += 1
        is_straggler = False
        if len(self.times) >= self.warmup:
            xs = sorted(self.times)
            med = xs[len(xs) // 2]
            mad = sorted(abs(x - med) for x in xs)[len(xs) // 2]
            thresh = med + self.k * max(mad, 1e-6) + 1e-4
            is_straggler = duration_s > thresh
        if is_straggler:
            self.flagged.append(self._count)
        else:
            # stragglers are excluded from the window so repeated slowness
            # keeps being flagged rather than shifting the baseline
            self.times.append(duration_s)
        return is_straggler

    @property
    def straggler_fraction(self) -> float:
        return len(self.flagged) / max(self._count, 1)


class Heartbeat:
    """File-based heartbeat: a worker thread touches ``path`` every
    ``interval``; ``is_alive`` checks staleness. In deployment the path
    sits on shared storage and a coordinator polls it."""

    def __init__(self, path: str, interval_s: float = 1.0):
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def _beat(self):
        tmp = f"{self.path}.tmp"
        while not self._stop.is_set():
            # write, then rename over the beat: is_alive never reads a
            # truncated, empty file
            with open(tmp, "w") as f:
                f.write(str(time.time()))
            os.replace(tmp, self.path)
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    @staticmethod
    def is_alive(path: str, timeout_s: float) -> bool:
        try:
            with open(path) as f:
                last = float(f.read().strip())
        except (OSError, ValueError):
            return False
        return (time.time() - last) < timeout_s


@dataclasses.dataclass
class RunnerReport:
    steps_completed: int
    restarts: int
    straggler_steps: int
    final_metrics: dict
    # async checkpoint writes that failed (distinct from training
    # crashes: the run fell back to the previous checkpoint, no
    # restart-budget slot was burned)
    failed_saves: int = 0


class TrainRunner:
    """Crash-recovering training loop.

    Each step may raise (injected in tests; real runs see CUDA / runtime
    errors on node loss). The runner restores the latest checkpoint and
    continues, up to ``max_restarts``. Deterministic data (step-indexed)
    plus deterministic dropout (step-folded Philox) make the recovered
    trajectory bitwise-identical to an uninterrupted one.

    With ``contract`` (checkpoint/contract.py) every recovery verifies
    the restored checkpoint's dropout contract against this run's before
    resuming — a mask_identity mismatch raises ContractMismatchError
    (fail fast: resuming would train under different mask bits), and a
    realization drift re-proves the current schedule through the counter
    layer (repro_torch.analysis) when ``model_cfg``/``schedule`` are
    given.

    A failed async checkpoint write (CheckpointWriteError) is NOT a
    training crash: it is counted in ``RunnerReport.failed_saves``, the
    previous checkpoint stays the restore point, and no restart-budget
    slot is burned.
    """

    def __init__(self, step_fn: Callable, state, batch_fn: Callable,
                 checkpointer, checkpoint_every: int = 10,
                 max_restarts: int = 3,
                 straggler: Optional[StragglerDetector] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 contract=None, model_cfg=None, schedule=None):
        self.step_fn = step_fn
        self.state = state
        self.batch_fn = batch_fn
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerDetector()
        self.failure_hook = failure_hook
        self.contract = contract
        self.model_cfg = model_cfg
        self.schedule = schedule
        self.restarts = 0
        self.failed_saves = 0

    def _save(self, step: int) -> None:
        """Checkpoint; a write failure (its own, or the PREVIOUS async
        write's, surfaced by save()'s internal wait) falls back to the
        last good checkpoint instead of crashing the step."""
        from repro_torch.checkpoint.checkpointer import CheckpointWriteError
        try:
            if self.contract is not None:
                self.ckpt.save(step, self.state,
                               contract=self.contract)
            else:
                self.ckpt.save(step, self.state)
        except CheckpointWriteError:
            self.failed_saves += 1

    def _drain_pending_save(self) -> None:
        from repro_torch.checkpoint.checkpointer import CheckpointWriteError
        try:
            self.ckpt.wait()
        except CheckpointWriteError:
            self.failed_saves += 1

    def _verify_contract(self, step: int) -> None:
        """Gate a recovery on the restored checkpoint's dropout
        contract. ContractMismatchError propagates: resuming would
        replay different mask bits, which no restart can fix."""
        if self.contract is None or not hasattr(self.ckpt,
                                                "load_contract"):
            return
        from repro_torch.checkpoint.contract import verify_resume
        saved = self.ckpt.load_contract(step)
        if saved is None:          # pre-contract checkpoint
            return
        verify_resume(saved, self.contract, cfg=self.model_cfg,
                      sched=self.schedule)

    def run(self, n_steps: int) -> RunnerReport:
        from repro_torch.checkpoint.contract import ContractMismatchError
        metrics = {}
        step = int(self.state["step"])
        while step < n_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                x, y = self.batch_fn(step)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, x, y)
                sync(metrics["loss"])
                self.straggler.observe(time.perf_counter() - t0)
                step += 1
                if step % self.checkpoint_every == 0:
                    self._save(step)
            except ContractMismatchError:
                raise                     # fail fast: wrong mask bits
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                # a failed async save surfacing here is not the crash
                # we are recovering from: count it and restore from
                # the last checkpoint that actually landed
                self._drain_pending_save()
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.state = self.ckpt.restore(latest, self.state)
                    self._verify_contract(latest)
                    step = latest
                else:
                    step = 0
        self._drain_pending_save()
        return RunnerReport(
            steps_completed=step,
            restarts=self.restarts,
            straggler_steps=len(self.straggler.flagged),
            failed_saves=self.failed_saves,
            final_metrics={k: float(v) for k, v in metrics.items()})
