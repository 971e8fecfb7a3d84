"""Producer-site mask executors — the standalone half.

The compiled ``DropoutSchedule`` (core/schedule.py) tags each layer's mask
with the physical producer that realizes it:

  "gemm_rng"         — inside a fused GEMM+RNG kernel (not ported yet)
  "gemm_rng_grouped" — inside a grouped expert-GEMM kernel (not ported yet)
  "standalone"       — the standalone Philox kernel (kernels/philox.py)
  "xla"              — the plain tensor-op producer (core/dropout_rng.py;
                       the only producer of the 8-bit scheme)
  "replay"           — consumer-side counter replay in the flash kernels
                       (not ported yet)

Every producer is bit-identical for the same (seed, salt, layer, step).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dropout_rng
from repro_torch.core.overlap import DropoutPlan
from repro_torch.device import DeviceLike

HOW_GEMM = "gemm_rng"
HOW_GEMM_GROUPED = "gemm_rng_grouped"
HOW_STANDALONE = "standalone"
HOW_XLA = "xla"
HOW_REPLAY = "replay"

# the fused kernels' mask-column block (JAX gemm_rng.py mask_block_cols)
_MASK_COLS_CAP = 2048
# the TPU standalone philox kernel's column block
_PHILOX_COLS_CAP = 512


def mask_kernel_unsupported_reason(plan: DropoutPlan, sq: int, sk: int,
                                   fused: bool = True) -> Optional[str]:
    """Why the TPU mask producers cannot represent this plan/shape — None
    when they can. Kept verbatim from the JAX package, whose schedule
    planning quotes these reasons: the Pallas kernels implement the 32-bit
    Philox scheme only, need 32-packable query rows, and tile the mask
    columns in 512-column blocks; the GEMM-fused hosts (``fused=True``)
    additionally partition the mask in 2048-column blocks. The port's
    standalone CUDA kernel has no column tiling, so its producer asks only
    for 32-bit planes (``standalone_packed_mask``)."""
    if plan.cfg.philox_bits != 32:
        return f"philox_bits={plan.cfg.philox_bits} (XLA-only scheme)"
    if sq % 32:
        return f"sq={sq} not 32-packable"
    sq32 = sq // 32
    if sq32 % min(8, sq32):
        return f"sq32={sq32} breaks the packed-row tiling"
    if sk % min(_PHILOX_COLS_CAP, sk):
        return f"sk={sk} breaks the {_PHILOX_COLS_CAP}-column tiling"
    cols = _MASK_COLS_CAP
    if fused and sk % min(cols, sk):
        return f"sk={sk} breaks the {cols}-column mask blocks"
    return None


def standalone_packed_mask(plan: DropoutPlan, batch: int, n_heads: int,
                           sq: int, sk: int, layer_idx, step, policy=None,
                           device: DeviceLike = None) -> torch.Tensor:
    """Packed (B, H, SQ//32, SK) int32 mask from a standalone producer: the
    Philox kernel for 32-bit planes (its plain version on the CPU), else
    the plain tensor-op producer. Same bits either way."""
    if policy is not None:
        raise NotImplementedError(
            "shard-local producers are not ported yet (ROADMAP: port "
            "queue, sharded producers)")
    seed = plan.step_seed(step)
    salt = plan.salt(layer_idx)
    if plan.cfg.philox_bits == 32:
        from repro_torch.kernels import ops
        return ops.dropout_mask(batch, n_heads, sq, sk, plan.cfg.p, seed,
                                salt, plan.cfg.philox_rounds, device=device)
    return dropout_rng.packed_mask(
        batch, n_heads, sq, sk, plan.cfg.p, seed, salt,
        plan.cfg.philox_rounds, plan.cfg.philox_bits, device=device)
