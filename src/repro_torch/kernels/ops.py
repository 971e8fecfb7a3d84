"""Public entry points for the port's kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels.gemm_rng import gemm_with_rng
from repro_torch.kernels.philox import philox_dropout_mask

__all__ = ["dropout_mask", "fused_qkv_gemm_rng"]


def dropout_mask(batch: int, n_heads: int, sq: int, sk: int, p: float,
                 seed, salt=0, rounds: int = 7, heads_global: int = 0,
                 bh_offset=0, device: DeviceLike = None) -> torch.Tensor:
    """Standalone-RNG kernel: packed keep bits (B, H, SQ//32, SK) int32.
    ``heads_global``/``bh_offset`` select a shard-local (b, h) tile of the
    global mask plane (bit-identical to slicing the full plane)."""
    return philox_dropout_mask(batch, n_heads, sq, sk, p, seed, salt,
                               rounds, heads_global=heads_global,
                               bh_offset=bh_offset, device=device)


def fused_qkv_gemm_rng(x: torch.Tensor, w_qkv: torch.Tensor, *,
                       mask_batch: int, mask_heads: int, mask_sq: int,
                       mask_sk: int, p: float, seed, salt=0,
                       rounds: int = 7, block_m: int = 256,
                       block_n: int = 256, block_k: int = 512,
                       mask_block_cols: int = 2048, heads_global: int = 0,
                       bh_offset=0
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """QKV projection with the attention layer's dropout plane made under
    the GEMM (the paper's overlap topology). Returns (plain GEMM, None)
    when the GEMM cannot host the RNG (Region 3): the caller then runs
    ``dropout_mask``."""
    return gemm_with_rng(
        x, w_qkv, mask_batch=mask_batch, mask_heads=mask_heads,
        mask_sq=mask_sq, mask_sk=mask_sk, p=p, seed=seed, salt=salt,
        rounds=rounds, block_m=block_m, block_n=block_n, block_k=block_k,
        mask_block_cols=mask_block_cols, heads_global=heads_global,
        bh_offset=bh_offset)
