"""Plain PyTorch oracles for the port's kernels, mirroring the JAX
package's ``kernels/ref.py``: the functions the kernels' plain versions
are built from and the tests hold them to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.philox_common import (
    seed_to_key,
    threshold_from_p,
    tile_keep_mask,
    to_int32_bits,
)


def keep_mask_ref(batch: int, n_heads: int, sq: int, sk: int, p: float,
                  seed: int, salt: int = 0, rounds: int = 7,
                  device=None) -> torch.Tensor:
    """Bool (B, H, SQ, SK) keep mask: ``tile_keep_mask`` over the whole
    score tensor of every (b, h)."""
    k0, k1 = seed_to_key(seed)
    thr = threshold_from_p(p)
    per_bh = [tile_keep_mask(0, 0, i, salt, k0, k1, thr, sq, sk, rounds,
                             device=device)
              for i in range(batch * n_heads)]
    return torch.stack(per_bh).reshape(batch, n_heads, sq, sk)


def philox_mask_ref(batch: int, n_heads: int, sq: int, sk: int, p: float,
                    seed: int, salt: int = 0, rounds: int = 7,
                    packed: bool = True, device=None) -> torch.Tensor:
    """The keep mask packed into (B, H, SQ//32, SK) int32 bit patterns
    (bit q % 32 of word q // 32), or bool (B, H, SQ, SK) unpacked."""
    keep = keep_mask_ref(batch, n_heads, sq, sk, p, seed, salt, rounds,
                         device)
    if not packed:
        return keep
    if sq % 32:
        raise ValueError(f"sq={sq} must be a multiple of 32 to pack")
    b = keep.reshape(batch, n_heads, sq // 32, 32, sk).to(torch.int64)
    shifts = torch.arange(32, device=keep.device,
                          dtype=torch.int64).reshape(1, 1, 1, 32, 1)
    return to_int32_bits((b << shifts).sum(dim=3))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, dropout_p: float = 0.0,
                  dropout_seed: int = 0, dropout_salt: int = 0,
                  philox_rounds: int = 7,
                  dropout_mask: Optional[torch.Tensor] = None,
                  local_window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with the paper's dropout semantics: softmax
    over all scores, then drop the normalized probabilities and scale by
    1/(1-p). q (B,H,SQ,D); k, v (B,KV,SK,D), H % KV == 0; queries sit at
    the end of the key sequence (positions SK-SQ ..). ``dropout_mask``:
    bool (B,H,SQ,SK) keep mask; None with p > 0 draws it from the
    canonical counters."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    if h != kv:
        kf = torch.repeat_interleave(kf, h // kv, dim=1)
        vf = torch.repeat_interleave(vf, h // kv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    dev = q.device
    q_pos = torch.arange(sq, device=dev).reshape(-1, 1) + (sk - sq)
    k_pos = torch.arange(sk, device=dev).reshape(1, -1)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    if causal:
        scores = torch.where(k_pos <= q_pos, scores, neg)
    if local_window and local_window > 0:
        scores = torch.where(k_pos > q_pos - local_window, scores, neg)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        if dropout_mask is None:
            dropout_mask = keep_mask_ref(b, h, sq, sk, dropout_p,
                                         dropout_seed, dropout_salt,
                                         philox_rounds, dev)
        probs = torch.where(dropout_mask, probs, 0.0) / (1.0 - dropout_p)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)


def gemm_rng_ref(a: torch.Tensor, b: torch.Tensor, mask_batch: int,
                 mask_heads: int, mask_sq: int, mask_sk: int, p: float,
                 seed: int, salt: int = 0, rounds: int = 7
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle of the fused GEMM+RNG kernel: the product and the canonical
    packed plane."""
    return gemm_ref(a, b), philox_mask_ref(
        mask_batch, mask_heads, mask_sq, mask_sk, p, seed, salt, rounds,
        device=a.device)


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)
