"""FP8 (e4m3) quantization with per-tile scales for the fp8 producer GEMM
(``gemm_rng.gemm_with_rng_fp8``), the JAX package's
``src/repro/kernels/quant.py`` in PyTorch.

Operands are stored as e4m3 values plus one f32 scale per (tile_r,
tile_c) operand tile; the tile grid is the GEMM's logical block grid, so
each (i, j, k) block product reads one scale per operand and the rescale
is a scalar multiply on the f32 accumulator.

Error bound: e4m3 carries a 3-bit mantissa, so once the per-tile scale
keeps every value in range the elementwise relative rounding error is at
most 2**-4; a per-tile-scaled e4m3 GEMM lands within 0.06 Frobenius-
relative of the f32 product (``quantize_error_bound``).

Quantization runs in plain torch, outside the kernel, as it runs outside
the Pallas call in the JAX package, on the exact f32 upcast of its input:
bf16 operands (bf16 compute) quantize to the bytes and scales of their f32
values, as JAX's ``x.astype(f32)`` does. A build without ``torch.float8_e4m3fn``
raises: there is no f32 stand-in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

E4M3_MAX = 448.0
_TINY = 1e-12  # scale floor so all-zero tiles stay finite


def fp8_dtype() -> Optional[torch.dtype]:
    """The e4m3 storage dtype, or None when this torch build lacks it."""
    return getattr(torch, "float8_e4m3fn", None)


def have_fp8() -> bool:
    return fp8_dtype() is not None


def _tile_view(x: torch.Tensor, tile_r: int, tile_c: int) -> torch.Tensor:
    r, c = x.shape
    if r % tile_r or c % tile_c:
        raise ValueError(f"({r},{c}) not divisible by tile "
                         f"({tile_r},{tile_c})")
    return x.reshape(r // tile_r, tile_r, c // tile_c, tile_c)


def quantize_tiled(x: torch.Tensor, tile_r: int, tile_c: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (r, c) -> (e4m3 values (r, c), f32 scales (r/tile_r, c/tile_c)).

    scale = amax(tile) / E4M3_MAX, so the largest magnitude in every tile
    maps to the top of the e4m3 range."""
    dt = fp8_dtype()
    if dt is None:
        raise NotImplementedError(
            "torch.float8_e4m3fn is missing from this torch build; the fp8 "
            "hosts need it")
    xt = _tile_view(x.to(torch.float32), tile_r, tile_c)
    amax = xt.abs().amax(dim=(1, 3))
    scale = torch.clamp_min(amax, _TINY) / E4M3_MAX
    q = (xt / scale[:, None, :, None]).to(dt)
    return q.reshape(x.shape), scale


def dequantize_tiled(q: torch.Tensor, scale: torch.Tensor, tile_r: int,
                     tile_c: int) -> torch.Tensor:
    """(e4m3 values, per-tile scales) -> f32 (r, c)."""
    qt = _tile_view(q.to(torch.float32), tile_r, tile_c)
    return (qt * scale[:, None, :, None]).reshape(q.shape)


def quantize_error_bound(k_dim: Optional[int] = None) -> float:
    """Frobenius-relative error bound of a per-tile-scaled e4m3 GEMM
    against the f32 product: elementwise rounding is at most 2**-4, and
    two rounded operands a partial product give about sqrt(2) of that in
    rms, independent of K. 0.06 is the asserted ceiling."""
    del k_dim  # the bound is K-independent (errors scale with the terms)
    return 0.06
