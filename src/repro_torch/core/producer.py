"""Producer-site mask executors: the physical producers the compiled
``DropoutSchedule`` (core/schedule.py) tags each layer's mask with.

  "gemm_rng"         -- inside the fused GEMM+RNG kernel
                        (kernels/gemm_rng.py, csrc/gemm_rng.cu)
  "gemm_rng_grouped" -- inside a grouped expert-GEMM kernel (not ported)
  "standalone"       -- the standalone Philox kernel (kernels/philox.py):
                        the paper's Region 3, where the GEMM cannot host
                        the RNG
  "xla"              -- the plain tensor-op producer (core/dropout_rng.py;
                        the only producer of the 8-bit scheme)
  "replay"           -- no plane at all: the flash-attention kernels
                        re-derive each tile's keep bits from the same
                        position-based counters; a GEMM host is kept
                        run-and-discard (``HostAssignment.host_how``)

Every producer is bit-identical for the same (seed, salt, layer, step).
The capability predicates and shape helpers are the JAX package's, so the
port plans the same producer for the same cell. Shard-local producers
(a sharding policy) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import FFNKind, ModelConfig
from repro_torch.core import dropout_rng
from repro_torch.core.overlap import DropoutPlan
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops

HOW_GEMM = "gemm_rng"
HOW_GEMM_GROUPED = "gemm_rng_grouped"
HOW_STANDALONE = "standalone"
HOW_XLA = "xla"
HOW_REPLAY = "replay"

# the JAX package's model-path GEMM block caps (its logical emission grid)
_BLOCK_M_CAP = 256
_BLOCK_N_CAP = 256
_BLOCK_K_CAP = 512
# the fused kernels' mask-column block (JAX gemm_rng.py mask_block_cols)
_MASK_COLS_CAP = 2048
# the TPU standalone philox kernel's column block
_PHILOX_COLS_CAP = 512


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: port queue, sharded "
        "producers)")


def _largest_divisor(dim: int, cap: int) -> int:
    for c in range(min(cap, dim), 0, -1):
        if dim % c == 0:
            return c
    return 1


def mask_cols_cap(sq: int, sk: int) -> int:
    """The fused kernels' emission column block for this plane. The port
    has no tuned table yet, so this is the shipped default."""
    return _MASK_COLS_CAP


def pick_gemm_blocks(m: int, n: int, k: int
                     ) -> Optional[Tuple[int, int, int]]:
    """The logical block shape of a model-path fused GEMM, or None when
    the operand shapes do not tile cleanly (the caller keeps the plain
    GEMM and the tensor-op producer). The emission layout is judged on
    the grid this gives."""
    bm = _largest_divisor(m, _BLOCK_M_CAP)
    bn = _largest_divisor(n, _BLOCK_N_CAP)
    bk = _largest_divisor(k, _BLOCK_K_CAP)
    if bm % 8 or bn % 8 or bk % 8:
        return None
    return bm, bn, bk


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
    cols = mask_cols_cap(sq, sk)
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
        raise _not_ported("a shard-local standalone producer")
    seed = plan.step_seed(step)
    salt = plan.salt(layer_idx)
    if plan.cfg.philox_bits == 32:
        return ops.dropout_mask(batch, n_heads, sq, sk, plan.cfg.p, seed,
                                salt, plan.cfg.philox_rounds, device=device)
    return dropout_rng.packed_mask(
        batch, n_heads, sq, sk, plan.cfg.p, seed, salt,
        plan.cfg.philox_rounds, plan.cfg.philox_bits, device=device)


def replay_unsupported_reason(plan: DropoutPlan, sq: int, sk: int,
                              attn_impl: str = "pallas") -> Optional[str]:
    """Why the schedule does not plan counter replay (mode="replay") for
    this plan, None when it does -- the JAX package's rule, verbatim, so
    the port plans what JAX plans. Its 128-tileable gate is the TPU grid's:
    at a sequence the CUDA kernels take (a multiple of 64) that it refuses,
    the plan is premask, and the flash kernels run it all the same."""
    if plan.cfg.attn_replay == "off":
        return "disabled by plan (attn_replay=off)"
    if attn_impl != "pallas":
        return "impl != pallas (no in-kernel counter replay)"
    if plan.cfg.philox_bits != 32:
        return f"philox_bits={plan.cfg.philox_bits} (XLA-only scheme)"
    if sq % 128 or sk % 128:
        return f"seq ({sq}, {sk}) not 128-tileable for the flash kernels"
    return None


def _fused_gemm_call(x2d: torch.Tensor, w2d: torch.Tensor,
                     plan: DropoutPlan, mask_shape, seed, salt,
                     blocks: Tuple[int, int, int], gemm_dtype: str):
    """One fused GEMM+RNG launch in the plan's host dtype (f32; bf16 and
    fp8 hosts are not ported yet). Returns (y2d, plane or None)."""
    if gemm_dtype != "f32":
        raise NotImplementedError(
            f"gemm_dtype={gemm_dtype!r} hosts are not ported yet (ROADMAP: "
            "port queue, bf16 hosts / fp8 kernels)")
    batch, n_heads, sq, sk = mask_shape
    bm, bn, bk = blocks
    y, mask = ops.fused_qkv_gemm_rng(
        x2d, w2d, mask_batch=batch, mask_heads=n_heads, mask_sq=sq,
        mask_sk=sk, p=plan.cfg.p, seed=seed, salt=salt,
        rounds=plan.cfg.philox_rounds, block_m=bm, block_n=bn, block_k=bk,
        mask_block_cols=mask_cols_cap(sq, sk))
    return y, mask


def gemm_with_mask(x2d: torch.Tensor, w2d: torch.Tensor, plan: DropoutPlan,
                   mask_shape: Tuple[int, int, int, int], layer_idx, step,
                   how: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = x2d @ w2d with the packed plane for ``mask_shape`` = (B, H, SQ,
    SK) made by the schedule's planned producer ``how``: HOW_XLA (the plain
    GEMM and the tensor-op producer), HOW_GEMM (the fused GEMM+RNG kernel)
    or HOW_STANDALONE (Region 3: the same kernel with emission off, then
    the standalone Philox kernel). Runs exactly that producer, and raises
    where the kernel's own layout check disagrees with the plan. Returns
    (y2d, plane)."""
    batch, n_heads, sq, sk = mask_shape
    m, kdim = x2d.shape
    n = w2d.shape[1]
    if how == HOW_XLA:
        y = x2d @ w2d
        mask = dropout_rng.packed_mask(
            batch, n_heads, sq, sk, plan.cfg.p, plan.step_seed(step),
            plan.salt(layer_idx), plan.cfg.philox_rounds,
            plan.cfg.philox_bits, device=x2d.device)
        return y, mask
    if how not in (HOW_GEMM, HOW_STANDALONE):
        raise ValueError(f"no GEMM producer {how!r}")
    blocks = pick_gemm_blocks(m, n, kdim)
    if blocks is None:
        raise ValueError(f"producer {how!r} planned for GEMM ({m},{n},"
                         f"{kdim}), which does not tile")
    y, mask = _fused_gemm_call(x2d, w2d, plan, mask_shape,
                               plan.step_seed(step), plan.salt(layer_idx),
                               blocks, plan.cfg.gemm_dtype)
    if (mask is None) != (how == HOW_STANDALONE):
        raise RuntimeError(
            f"producer {how!r} planned, but the GEMM+RNG kernel's layout "
            f"for GEMM ({m},{n},{kdim}) and mask {mask_shape} "
            f"{'is Region 3' if mask is None else 'emits the plane'}")
    if mask is None:
        mask = standalone_packed_mask(plan, batch, n_heads, sq, sk,
                                      layer_idx, step, device=x2d.device)
    return y, mask


def block_gemm_shapes(cfg: ModelConfig, batch: int, seq: int,
                      dense_ffn: Optional[bool] = None
                      ) -> Dict[str, Tuple[int, int, int]]:
    """(m, n, k) of each candidate dense host GEMM in one transformer
    block; FFN sites only for blocks with a GEMM-shaped dense FFN."""
    d = cfg.d_model
    toks = batch * seq
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "qkv": (toks, (nq + 2 * nkv) * hd, d),
        "prev_gemm": (toks, d, nq * hd),
    }
    if dense_ffn is None:
        dense_ffn = cfg.moe is None
    if dense_ffn and cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU,
                                 FFNKind.GELU):
        gated = cfg.ffn in (FFNKind.SWIGLU, FFNKind.GEGLU)
        shapes["ffn_up"] = (toks, (2 if gated else 1) * cfg.d_ff, d)
        shapes["ffn_down"] = (toks, d, cfg.d_ff)
    return shapes
