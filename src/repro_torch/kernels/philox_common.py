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


def seed_salt_words(seed, salt, bh_offset=0) -> Tuple[int, int, int, int]:
    """(key_lo, key_hi, salt, bh_offset) as Python ints in [0, 2**32): the
    four words every counter-based kernel of the port takes by value.
    ``seed`` keys through ``split_seed`` (a 0-d tensor seed has key_hi =
    0); ``salt`` / ``bh_offset`` may be ints or 0-d CPU tensors."""
    k0, k1 = split_seed(seed)
    return k0, k1, int(salt) & U32_MASK, int(bh_offset) & U32_MASK


def seed_salt_smem(seed, salt, bh_offset=0) -> torch.Tensor:
    """(4,) int32 CPU tensor [key_lo, key_hi, salt, bh_offset] (uint32 bit
    patterns): the counterpart of the JAX package's SMEM operand of the
    dynamic-seed kernels. The CUDA kernels read it on the host and take the
    words by value, so it stays on the CPU and costs no device sync."""
    words = torch.tensor(seed_salt_words(seed, salt, bh_offset),
                         dtype=torch.int64)
    return to_int32_bits(words)


def tile_random_u32(q_start: int, k_start: int, bh: IntOrTensor, salt: int,
                    k0: int, k1: int, bq: int, bk: int, rounds: int = 7,
                    device=None) -> torch.Tensor:
    """Random uint32 (as int64 in [0, 2**32)) for the score tile rows
    [q_start, q_start + bq) x cols [k_start, k_start + bk); bq % 4 == 0.
    One Philox call covers 4 consecutive q rows: out[4g + w, k] =
    word_w(x0=k, x1=q_start//4 + g)."""
    if bq % 4:
        raise ValueError(f"tile q-size {bq} must be a multiple of 4")
    dev = device if device is not None else (
        bh.device if isinstance(bh, torch.Tensor) else None)
    q4 = (as_u32(q_start) >> 2) + torch.arange(
        bq // 4, device=dev, dtype=torch.int64).reshape(-1, 1)
    kk = as_u32(k_start) + torch.arange(bk, device=dev,
                                        dtype=torch.int64).reshape(1, -1)
    w = philox4x32(kk, q4, bh, salt, k0, k1, rounds)
    w = [x.expand(bq // 4, bk) for x in w]
    return torch.stack(w, dim=1).reshape(bq, bk)


def tile_keep_mask(q_start: int, k_start: int, bh: IntOrTensor, salt: int,
                   k0: int, k1: int, threshold: int, bq: int, bk: int,
                   rounds: int = 7, device=None) -> torch.Tensor:
    """Bool keep mask (True = keep) of one score tile."""
    return tile_random_u32(q_start, k_start, bh, salt, k0, k1, bq, bk,
                           rounds, device) >= as_u32(threshold)


def pack_bits_q32(bits: torch.Tensor) -> torch.Tensor:
    """(bq, bk) bool -> (bq//32, bk) int64 words in [0, 2**32); bit (q % 32)
    of word q // 32."""
    bq, bk = bits.shape
    if bq % 32:
        raise ValueError(f"bq={bq} must be a multiple of 32")
    b = bits.reshape(bq // 32, 32, bk).to(torch.int64)
    shifts = torch.arange(32, device=bits.device,
                          dtype=torch.int64).reshape(1, 32, 1)
    return (b << shifts).sum(dim=1)


def unpack_bits_q32(packed: torch.Tensor, bq: int) -> torch.Tensor:
    """(bq//32, bk) int32 bit patterns (or int64 words) -> (bq, bk) bool.
    ``(w >> s) & 1`` is exact under int32's arithmetic shift."""
    n32, bk = packed.shape
    if n32 * 32 != bq:
        raise ValueError(f"{n32} packed rows do not hold bq={bq}")
    rep = torch.repeat_interleave(packed, 32, dim=0)
    shifts = (torch.arange(bq, device=packed.device, dtype=packed.dtype)
              % 32).reshape(bq, 1)
    return ((rep >> shifts) & 1).to(torch.bool)


def packed_rows_tile(r_start: int, k_start: int, sq32: int, salt: int,
                     k0: int, k1: int, threshold: int, rows: int, bk: int,
                     rounds: int = 7, heads_local: int = 0,
                     heads_global: int = 0, bh_offset: int = 0,
                     device=None) -> torch.Tensor:
    """Packed keep words for ``rows`` packed rows of the flattened mask
    layout (BH*SQ32, SK), from global packed row ``r_start`` and column
    ``k_start``: (rows, bk) int64 in [0, 2**32). Rows may cross (b, h)
    boundaries: row r belongs to bh = r // sq32 (remapped through
    ``global_bh`` when ``heads_local`` is set) and packed row r % sq32.
    The fused GEMM+RNG kernel's emission follows this layout."""
    sub = torch.arange(rows * 8, device=device,
                       dtype=torch.int64).reshape(-1, 1)   # r_local*8 + t
    r_glob = as_u32(r_start) + (sub >> 3)
    t = sub & 7
    q32 = r_glob % sq32
    bh = r_glob // sq32
    if heads_local:
        bh = global_bh(bh, heads_local, heads_global or heads_local,
                       bh_offset)
    x1 = q32 * 8 + t                                          # q // 4
    kk = as_u32(k_start) + torch.arange(bk, device=device,
                                        dtype=torch.int64).reshape(1, -1)
    words = philox4x32(kk, x1, bh, salt, k0, k1, rounds)
    thr = as_u32(threshold)
    shifts = (torch.arange(8, device=device, dtype=torch.int64)
              .reshape(1, 8, 1) * 4)
    packed = torch.zeros((rows, bk), dtype=torch.int64, device=device)
    for w, word in enumerate(words):
        bits = (word.expand(rows * 8, bk) >= thr).to(torch.int64)
        packed |= (bits.reshape(rows, 8, bk) << (shifts + w)).sum(dim=1)
    return packed
