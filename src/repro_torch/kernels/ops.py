"""Public entry points for the port's kernels."""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels.philox import philox_dropout_mask

__all__ = ["dropout_mask"]


def dropout_mask(batch: int, n_heads: int, sq: int, sk: int, p: float,
                 seed, salt=0, rounds: int = 7, heads_global: int = 0,
                 bh_offset=0, device: DeviceLike = None) -> torch.Tensor:
    """Standalone-RNG kernel: packed keep bits (B, H, SQ//32, SK) int32.
    ``heads_global``/``bh_offset`` select a shard-local (b, h) tile of the
    global mask plane (bit-identical to slicing the full plane)."""
    return philox_dropout_mask(batch, n_heads, sq, sk, p, seed, salt,
                               rounds, heads_global=heads_global,
                               bh_offset=bh_offset, device=device)
