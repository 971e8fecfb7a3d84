"""Deterministic, resumable synthetic LM data: every batch is a pure
function of (seed, step, position) through the same Philox generator the
dropout path uses, so restarting at step N reproduces the token stream.
Tokens follow a log-uniform ("Zipf-ish") rank distribution. The batches
are the JAX package's, token for token.

The prefetch thread and on-device placement of the JAX package
(``Prefetcher``, ``device_batch``) are not ported yet (ROADMAP); callers move
the numpy arrays with ``torch.from_numpy(...).to(device)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
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
