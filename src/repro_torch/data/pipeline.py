"""Deterministic, resumable synthetic LM data: every batch is a pure
function of (seed, step, position) through the same Philox generator the
dropout path uses, so restarting at step N reproduces the token stream.
Tokens follow a log-uniform ("Zipf-ish") rank distribution. The batches
are the JAX package's, token for token.

``device_batch`` puts a step's batch on a device (the card unless asked)
from pinned host memory with ``non_blocking=True``, so the copy overlaps
the host's next work; ``Prefetcher`` makes the next batches on a
background thread, a queue of ``depth`` ahead (the JAX package's). A
sharding policy (batch-over-data placement) is not ported.
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
                     vocab: int) -> np.ndarray:
    """(B, S+1) int32 tokens, stateless in (seed, step)."""
    n = batch * (seq + 1)
    n4 = -(-n // 4)
    idx = torch.arange(n4, dtype=torch.int64)
    key0 = (seed >> 32) & U32_MASK if seed >> 32 else 7
    w = philox4x32(idx, step, seed, 0x0DA7A, key0, 11, rounds=7)
    u = torch.stack(w, dim=1).reshape(-1)[:n].numpy()
    uf = (u.astype(np.float64) + 0.5) / 4294967296.0
    ranks = np.exp(uf * np.log(float(vocab))) - 1.0
    toks = np.clip(ranks.astype(np.int64), 0, vocab - 1).astype(np.int32)
    return toks.reshape(batch, seq + 1)


def batch_for_step(cfg: ModelConfig, shape: ShapeConfig, step: int,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (B, S), labels (B, S)) int32 for a training step."""
    raw = _philox_batch_np(seed, step, shape.global_batch, shape.seq_len,
                           cfg.vocab_size)
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
    blocking the host. ``policy`` (a sharded placement) is not ported."""
    if policy is not None:
        raise NotImplementedError(
            "device_batch under a sharding policy is not ported yet "
            "(ROADMAP: port queue, multi-device)")
    dev = resolve_device(device)
    if cfg.frontend == "token":
        x, y = batch_for_step(cfg, shape, step, seed)
    else:
        x, y = embed_batch_for_step(cfg, shape, step, seed)
    return _to_device(x, dev), _to_device(y, dev)


class Prefetcher:
    """Background-thread prefetch of synthetic batches (a depth-N queue of
    (step, batch) from ``start_step`` on)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 start_step: int, seed: int = 0, depth: int = 2,
                 policy=None, device: DeviceLike = None):
        if policy is not None:
            raise NotImplementedError(
                "Prefetcher under a sharding policy is not ported yet "
                "(ROADMAP: port queue, multi-device)")
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = device_batch(self.cfg, self.shape, step, seed=self.seed,
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
