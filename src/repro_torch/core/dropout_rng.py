"""Plain PyTorch dropout-mask producer with the canonical counter scheme —
the counterpart of the JAX package's XLA producer. Packed 32-bit planes
come from the CUDA kernel's plain version (``kernels.philox``); this module
is the only producer of the 8-bit scheme.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.philox import philox_dropout_mask_plain
from repro_torch.kernels.philox_common import (
    as_u32,
    philox4x32,
    split_seed,
    threshold_from_p,
    to_int32_bits,
)

__all__ = ["packed_mask", "keep_mask_block", "unpack_block", "mask_bytes"]


def keep_mask_block(batch: int, n_heads: int, q_start: int, cq: int, sk: int,
                    p: float, seed, salt, rounds: int = 7, bits: int = 32,
                    device: DeviceLike = None) -> torch.Tensor:
    """Bool (B, H, cq, SK) keep mask for query rows [q_start, q_start+cq).

    bits=32 is one u32 draw per element. bits=8 spends one byte per
    element: each Philox word covers 4 k-columns, with p quantized to
    1/256."""
    assert cq % 4 == 0
    dev = resolve_device(device)
    k0, k1 = split_seed(seed)
    i64 = torch.int64
    bh = torch.arange(batch * n_heads, device=dev, dtype=i64).reshape(-1, 1, 1)
    q4 = (as_u32(int(q_start)) // 4
          + torch.arange(cq // 4, device=dev, dtype=i64).reshape(1, -1, 1))
    salt = as_u32(int(salt))
    if bits == 8:
        assert sk % 4 == 0
        thr8 = min(max(int(round(p * 256.0)), 0), 255)
        k4 = torch.arange(sk // 4, device=dev, dtype=i64).reshape(1, 1, -1)
        w = philox4x32(k4, q4, bh, salt, k0, k1, rounds)
        u = torch.stack([x.expand(batch * n_heads, cq // 4, sk // 4)
                         for x in w], dim=2)   # (BH, cq//4, 4w, SK//4)
        u = u.reshape(batch * n_heads, cq, sk // 4)
        shifts = torch.arange(4, device=dev, dtype=i64) * 8
        bytes_ = (u[..., None] >> shifts) & 0xFF
        keep = (bytes_ >= thr8).reshape(batch * n_heads, cq, sk)
        return keep.reshape(batch, n_heads, cq, sk)
    thr = threshold_from_p(p)
    kk = torch.arange(sk, device=dev, dtype=i64).reshape(1, 1, -1)
    w = philox4x32(kk, q4, bh, salt, k0, k1, rounds)
    u = torch.stack([x.expand(batch * n_heads, cq // 4, sk) for x in w],
                    dim=2)                       # (BH, cq//4, 4, SK)
    u = u.reshape(batch * n_heads, cq, sk)
    return (u >= thr).reshape(batch, n_heads, cq, sk)


def packed_mask(batch: int, n_heads: int, sq: int, sk: int, p: float,
                seed, salt, rounds: int = 7, bits: int = 32,
                device: DeviceLike = None) -> torch.Tensor:
    """Packed (B, H, SQ//32, SK) int32 keep plane (uint32 bit patterns):
    bit (q % 32) of word q // 32."""
    assert sq % 32 == 0
    if bits == 32:
        return philox_dropout_mask_plain(batch, n_heads, sq, sk, p, seed,
                                         salt, rounds, device=device)
    keep = keep_mask_block(batch, n_heads, 0, sq, sk, p, seed, salt,
                           rounds, bits, device=device)
    b = keep.reshape(batch, n_heads, sq // 32, 32, sk).to(torch.int64)
    shifts = torch.arange(32, device=keep.device,
                          dtype=torch.int64).reshape(1, 1, 1, 32, 1)
    return to_int32_bits((b << shifts).sum(dim=3))


def unpack_block(packed_chunk: torch.Tensor, cq: int) -> torch.Tensor:
    """(B, H, cq//32, SK) int32 -> (B, H, cq, SK) bool."""
    b, h, n32, sk = packed_chunk.shape
    assert n32 * 32 == cq
    rep = torch.repeat_interleave(packed_chunk, 32, dim=2)
    shifts = (torch.arange(cq, device=packed_chunk.device,
                           dtype=packed_chunk.dtype) % 32).reshape(1, 1, cq, 1)
    return ((rep >> shifts) & 1).to(torch.bool)


def mask_bytes(batch: int, n_heads: int, sq: int, sk: int) -> int:
    """Device bytes for one layer's packed mask."""
    return batch * n_heads * (sq // 32) * sk * 4
