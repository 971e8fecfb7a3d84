"""Philox-4x32 counter-based RNG in PyTorch: the plain mirror of the CUDA
header ``csrc/philox.cuh``, and the bits every mask producer of the port
must reproduce.

Counter scheme: for attention-score element (b, h, q, k)

    ctr = (x0=k, x1=q//4, x2=b*nH+h, x3=layer_salt), key = (seed_lo, seed_hi)
    u32 = philox4x32_r(ctr, key)[q % 4]
    keep = u32 >= round(p * 2**32)

Arithmetic: ``torch.uint32`` on the CPU has no ``>>``, ``>=`` or ``+``, so
every uint32 value lives in an int64 tensor (or a Python int) in
[0, 2**32) and is masked back after each add. The high word of a 32x32
multiply comes from 16-bit partial products (``_mul32_hilo``), so no
intermediate leaves int64's range and nothing relies on signed wraparound.

Packed planes are stored as ``torch.int32`` holding the uint32 bit
pattern (``to_int32_bits``); ``(w >> s) & 1`` stays correct under the
arithmetic shift, and numpy reads them back with ``.view(np.uint32)``.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

U32_MASK = 0xFFFFFFFF

# Philox 4x32 round constants (Salmon et al., 2011).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9  # golden-ratio Weyl increment
PHILOX_W1 = 0xBB67AE85

# Round counts the producers implement (the CUDA kernel instantiates each).
SUPPORTED_PHILOX_ROUNDS = (3, 5, 7, 10)

# Counter-identity folding: the layer folds into x3 as
# layer * LAYER_SALT_PRIME + stream, the step into the key as
# step * STEP_SEED_MULT + seed, both mod 2**32.
LAYER_SALT_PRIME = 1000003
STEP_SEED_MULT = 2654435761

IntOrTensor = Union[int, torch.Tensor]


def fold_layer_salt(layer: int, stream: int = 0) -> int:
    """uint32 salt for (layer, stream)."""
    return (int(layer) * LAYER_SALT_PRIME + int(stream)) & U32_MASK


def fold_step_seed(step: int, seed: int) -> int:
    """uint32 Philox key-lo for (step, seed)."""
    return (int(step) * STEP_SEED_MULT + (int(seed) & U32_MASK)) & U32_MASK


def as_u32(x: IntOrTensor) -> IntOrTensor:
    """Python ints -> int in [0, 2**32); tensors -> int64 tensor, masked."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & U32_MASK
    return int(x) & U32_MASK


def _mul32_hilo(a: int, b: IntOrTensor):
    """Exact (hi, lo) words of the 64-bit product of two uint32 values via
    16-bit partial products: every product is below 2**32."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    u = al * bl
    v = ah * bl
    w = al * bh
    mid = (u >> 16) + (v & 0xFFFF) + (w & 0xFFFF)
    hi = ah * bh + (v >> 16) + (w >> 16) + (mid >> 16)
    lo = ((mid & 0xFFFF) << 16) | (u & 0xFFFF)
    return hi, lo


def philox4x32(x0, x1, x2, x3, k0, k1, rounds: int = 7):
    """Philox-4x32 with a configurable round count. Inputs broadcast (Python
    ints or int64 tensors holding uint32 values); returns four values of
    the broadcast shape, each in [0, 2**32)."""
    x0, x1, x2, x3 = as_u32(x0), as_u32(x1), as_u32(x2), as_u32(x3)
    k0, k1 = as_u32(k0), as_u32(k1)
    for _ in range(rounds):
        hi0, lo0 = _mul32_hilo(PHILOX_M0, x0)
        hi1, lo1 = _mul32_hilo(PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & U32_MASK
        k1 = (k1 + PHILOX_W1) & U32_MASK
    return x0, x1, x2, x3


def threshold_from_p(p: float) -> int:
    """keep iff u32 >= threshold; P(keep) = 1 - p exactly at p=0."""
    return min(max(int(round(p * 4294967296.0)), 0), 0xFFFFFFFF)


def seed_to_key(seed: int) -> Tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & U32_MASK, seed >> 32


def split_seed(seed) -> Tuple[int, int]:
    """seed -> (key_lo, key_hi). Python ints use the full 64-bit key; a
    0-d tensor seed (what ``DropoutPlan.step_seed`` returns) lands in
    key_lo with key_hi = 0. Every producer keys Philox through this."""
    if isinstance(seed, torch.Tensor):
        return int(seed) & U32_MASK, 0
    return seed_to_key(int(seed))


def global_bh(local_bh: IntOrTensor, heads_local: int, heads_global: int,
              bh_offset: int) -> IntOrTensor:
    """Shard-local flattened (b, h) index -> global counter index:
    offset + local_b * H_global + local_h (the identity plus the offset
    when heads_local == heads_global)."""
    lb = as_u32(local_bh)
    if heads_local == heads_global:
        return as_u32(lb + as_u32(bh_offset))
    return as_u32(as_u32(bh_offset) + (lb // heads_local) * heads_global
                  + lb % heads_local)


def packed_tile_from_counters(q32_start: int, k_start: int,
                              bh: torch.Tensor, salt: int, k0: int, k1: int,
                              threshold: int, rows32: int, bk: int,
                              rounds: int = 7) -> torch.Tensor:
    """Packed keep words for packed rows [q32_start, q32_start + rows32)
    and columns [k_start, k_start + bk) of every global (b, h) index in
    the 1-D tensor ``bh``. Returns (len(bh), rows32, bk) int64 words in
    [0, 2**32): bit (q % 32) of word q // 32."""
    dev = bh.device
    n = bh.numel()
    bhv = as_u32(bh).reshape(n, 1, 1)
    q4 = (q32_start * 8
          + torch.arange(rows32 * 8, device=dev, dtype=torch.int64)
          ).reshape(1, -1, 1)
    kk = (k_start
          + torch.arange(bk, device=dev, dtype=torch.int64)).reshape(1, 1, -1)
    words = philox4x32(kk, q4, bhv, salt, k0, k1, rounds)
    words = [w.expand(n, rows32 * 8, bk) for w in words]
    u = torch.stack(words, dim=2).reshape(n, rows32 * 32, bk)  # q = 4g + w
    bits = (u >= threshold).to(torch.int64).reshape(n, rows32, 32, bk)
    shifts = torch.arange(32, device=dev, dtype=torch.int64).reshape(
        1, 1, 32, 1)
    return (bits << shifts).sum(dim=2)


def to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def from_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & U32_MASK
