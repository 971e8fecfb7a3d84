"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (the JAX package's ``optim/compression``).

The quantizer is deterministic, symmetric max-scaling per tensor; the
residual (the quantization error) is carried and added back before the
next quantization, so the scheme converges to the uncompressed fixed
point. ``compressed_psum`` is the shard_map building block: quantize ->
int32 all-reduce of the int8 payload -> dequantize with the mean scale.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.compat import P, axis_size, psum, shard_map
from repro_torch.tree import leaves, tree_map, unflatten_like


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Returns (q, scale, new_residual); new_residual = g + r - deq(q)."""
    g = grad.to(torch.float32) + residual
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def compressed_psum(x: torch.Tensor, axis_name, residual: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed psum over ``axis_name`` (inside a shard_map body).
    The scales are reduced in f32, the payload as int32 sums of the int8
    values (exact for up to 2^23 shards). Returns (mean-reduced value, new
    residual)."""
    q, scale, new_res = compress_with_feedback(x, residual)
    n = axis_size(axis_name)
    summed = psum(q.to(torch.int32), axis_name)
    scale_sum = psum(scale, axis_name)
    # each shard used its own scale; the mean scale stands for them
    out = summed.to(torch.float32) * (scale_sum / n) / n
    return out.to(x.dtype), new_res


def compressed_allreduce(stacked: torch.Tensor, residual: torch.Tensor,
                         mesh, axis_name: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit-collective form of the compressed gradient all-reduce.
    ``stacked`` / ``residual`` carry one leading slot per rank on
    ``axis_name`` (shape (n_ranks, ...)); each rank quantizes its slot,
    the payload is summed, and every rank gets the mean-reduced gradient
    back plus its own updated residual."""
    spec = P(axis_name)

    def body(xs, rs):
        out, new_r = compressed_psum(xs[0], axis_name, rs[0])
        return out[None], new_r[None]

    return shard_map(body, mesh=mesh, in_specs=(spec, spec),
                     out_specs=(spec, spec))(stacked, residual)


def residual_init(grads_like) -> Any:
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), grads_like)


def compress_tree(grads, residuals):
    """Whole-tree error-feedback quantization (no collective)."""
    outs = [compress_with_feedback(g, r)
            for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten_like(grads, [dequantize_int8(q, s)
                                   for q, s, _ in outs]),
            unflatten_like(grads, [r for _, _, r in outs]))
