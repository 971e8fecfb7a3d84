"""Public entry points for the port's kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels.gemm_rng import (
    gemm_with_rng,
    gemm_with_rng_fp8,
    gemm_with_rng_grouped,
    gemm_with_rng_grouped_fp8,
)
from repro_torch.kernels.philox import philox_dropout_mask

__all__ = ["dropout_mask", "fused_gemm_rng_fp8", "fused_gemm_rng_grouped",
           "fused_gemm_rng_grouped_fp8", "fused_qkv_gemm_rng"]


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


def fused_gemm_rng_fp8(x: torch.Tensor, w: torch.Tensor, *,
                       mask_batch: int, mask_heads: int, mask_sq: int,
                       mask_sk: int, p: float, seed, salt=0,
                       rounds: int = 7, block_m: int = 256,
                       block_n: int = 256, block_k: int = 512,
                       mask_block_cols: int = 2048, heads_global: int = 0,
                       bh_offset=0
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Producer GEMM on per-tile-scaled e4m3 operands with the dropout
    plane made under it (the paper's measured FP8 regime). The plane is
    bitwise the f32 host's; the GEMM is within the e4m3 error bound of
    f32 (kernels/quant.py) and comes back in the operands' dtype (f32 or
    bf16, rounded once). Returns (quantized GEMM, None) in Region 3: the
    caller then runs ``dropout_mask``. Differentiable (straight-through
    quantization, bf16 dgrad pair)."""
    return gemm_with_rng_fp8(
        x, w, mask_batch=mask_batch, mask_heads=mask_heads,
        mask_sq=mask_sq, mask_sk=mask_sk, p=p, seed=seed, salt=salt,
        rounds=rounds, block_m=block_m, block_n=block_n, block_k=block_k,
        mask_block_cols=mask_block_cols, heads_global=heads_global,
        bh_offset=bh_offset)


def fused_gemm_rng_grouped(a3: torch.Tensor, b3: torch.Tensor, *,
                           mask_batch: int, mask_heads: int, mask_sq: int,
                           mask_sk: int, p: float, seed, salt=0,
                           rounds: int = 7, block_m: int = 256,
                           block_n: int = 256, block_k: int = 512,
                           mask_block_cols: int = 2048,
                           heads_global: int = 0, bh_offset=0
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Grouped (per-expert) GEMM with the dropout plane made under it: the
    MoE expert einsum, or E=1 for the RWKV channel-mix GEMMs, on f32 or
    bf16 operands (C in their dtype). The emission grid is decoupled from
    the expert tiles, so routing / capacity never reach the bits. Returns
    (C, None) in Region 3: the caller then runs ``dropout_mask``."""
    return gemm_with_rng_grouped(
        a3, b3, mask_batch=mask_batch, mask_heads=mask_heads,
        mask_sq=mask_sq, mask_sk=mask_sk, p=p, seed=seed, salt=salt,
        rounds=rounds, block_m=block_m, block_n=block_n, block_k=block_k,
        mask_block_cols=mask_block_cols, heads_global=heads_global,
        bh_offset=bh_offset)


def fused_gemm_rng_grouped_fp8(a3: torch.Tensor, b3: torch.Tensor, *,
                               mask_batch: int, mask_heads: int,
                               mask_sq: int, mask_sk: int, p: float, seed,
                               salt=0, rounds: int = 7, block_m: int = 256,
                               block_n: int = 256, block_k: int = 512,
                               mask_block_cols: int = 2048,
                               heads_global: int = 0, bh_offset=0
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Grouped expert GEMM on per-expert-tile e4m3 operands with the dropout
    plane made under it (bitwise the f32 host's); C in the operands' dtype
    (f32 or bf16). Returns (the unquantized product in that dtype, None)
    in Region 3, as the JAX host does."""
    return gemm_with_rng_grouped_fp8(
        a3, b3, mask_batch=mask_batch, mask_heads=mask_heads,
        mask_sq=mask_sq, mask_sk=mask_sk, p=p, seed=seed, salt=salt,
        rounds=rounds, block_m=block_m, block_n=block_n, block_k=block_k,
        mask_block_cols=mask_block_cols, heads_global=heads_global,
        bh_offset=bh_offset)
