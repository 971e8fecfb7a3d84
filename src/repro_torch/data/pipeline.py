"""Deterministic, resumable synthetic LM data: every batch is a pure
function of (seed, step, position) through the same Philox generator the
dropout path uses, so restarting at step N reproduces the token stream.
Tokens follow a log-uniform ("Zipf-ish") rank distribution. The batches
are the JAX package's, token for token.

``device_batch`` puts a step's batch on a device (the card unless asked)
from pinned host memory with ``non_blocking=True``, so the copy overlaps
the host's next work; ``Prefetcher`` makes the next batches on a
background thread, a queue of ``depth`` ahead (the JAX package's). Under
a sharding policy both place the global batch by ("batch", None): each
rank makes only its own rows (the counters are positional, so they are
the global batch's rows bitwise) and holds them as a DTensor's shard.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.philox_common import U32_MASK, philox4x32


def _philox_batch_np(seed: int, step: int, batch: int, seq: int,
                     vocab: int, rows=None) -> np.ndarray:
    """(B, S+1) int32 tokens, stateless in (seed, step); ``rows`` = (r0,
    r1) makes only those rows, bitwise the whole batch's."""
    r0, r1 = (0, batch) if rows is None else rows
    lo, hi = r0 * (seq + 1), r1 * (seq + 1)
    idx = torch.arange(lo // 4, -(-hi // 4), dtype=torch.int64)
    key0 = (seed >> 32) & U32_MASK if seed >> 32 else 7
    w = philox4x32(idx, step, seed, 0x0DA7A, key0, 11, rounds=7)
    u = torch.stack(w, dim=1).reshape(-1)[lo % 4:lo % 4 + hi - lo].numpy()
    uf = (u.astype(np.float64) + 0.5) / 4294967296.0
    ranks = np.exp(uf * np.log(float(vocab))) - 1.0
    toks = np.clip(ranks.astype(np.int64), 0, vocab - 1).astype(np.int32)
    return toks.reshape(r1 - r0, seq + 1)


def batch_for_step(cfg: ModelConfig, shape: ShapeConfig, step: int,
                   seed: int = 0, rows=None) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (B, S), labels (B, S)) int32 for a training step; ``rows``
    = (r0, r1) for those rows only."""
    raw = _philox_batch_np(seed, step, shape.global_batch, shape.seq_len,
                           cfg.vocab_size, rows)
    return raw[:, :-1], raw[:, 1:]


def embed_batch_for_step(cfg: ModelConfig, shape: ShapeConfig, step: int,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Frontend-stub batch: (embeddings (B, S, D) f32, labels (B, S))."""
    tokens, labels = batch_for_step(cfg, shape, step, seed)
    rng = np.random.default_rng(seed * 1000003 + step)
    emb = rng.standard_normal(
        (shape.global_batch, shape.seq_len, cfg.d_model)).astype(np.float32)
    return emb, labels


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                 policy=None, seed: int = 0, device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch of ``step`` on ``device`` (the card unless asked): tokens
    (B, S) or, for an embedding frontend, embeddings (B, S, D), and labels
    (B, S). On the card the host arrays are pinned and copied without
    blocking the host. Under a ``policy`` (on its mesh's device unless
    asked) each rank makes its rows of the ("batch", None) placement and
    both come back DTensors."""
    if policy is None:
        dev = resolve_device(device)
        if cfg.frontend == "token":
            x, y = batch_for_step(cfg, shape, step, seed)
        else:
            x, y = embed_batch_for_step(cfg, shape, step, seed)
        return _to_device(x, dev), _to_device(y, dev)
    from torch.distributed.tensor import DTensor
    from repro_torch.compat import placements
    dev = resolve_device(device or policy.mesh.device_type)
    b = shape.global_batch
    spec = policy.spec(("batch", None), (b, shape.seq_len))
    axes = () if spec[0] is None else (
        (spec[0],) if isinstance(spec[0], str) else tuple(spec[0]))
    n, idx = 1, 0
    for a in axes:
        n *= policy.sizes[a]
        idx = idx * policy.sizes[a] + policy.mesh.get_local_rank(a)
    rows = (idx * (b // n), (idx + 1) * (b // n))
    if cfg.frontend == "token":
        x, y = batch_for_step(cfg, shape, step, seed, rows=rows)
    else:
        # the stub frontend's embeddings come from one numpy stream
        x, y = embed_batch_for_step(cfg, shape, step, seed)
        x, y = x[rows[0]:rows[1]], y[rows[0]:rows[1]]

    def place(a, ndim):
        pl = placements(tuple(spec) + (None,) * (ndim - 2), policy.mesh)
        return DTensor.from_local(_to_device(a, dev), policy.mesh, pl,
                                  run_check=False)

    return place(x, x.ndim), place(y, y.ndim)


class Prefetcher:
    """Background-thread prefetch of synthetic batches (a depth-N queue of
    (step, batch) from ``start_step`` on), each placed as ``device_batch``
    places it (under ``policy``, this rank's rows)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 start_step: int, seed: int = 0, depth: int = 2,
                 policy=None, device: DeviceLike = None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.policy = policy
        self.device = resolve_device(
            device or (policy.mesh.device_type if policy else None))
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = device_batch(self.cfg, self.shape, step,
                                 policy=self.policy, seed=self.seed,
                                 device=self.device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
