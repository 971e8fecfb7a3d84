"""Fused GEMM + dropout RNG: C = A @ B with the packed keep plane of one
attention layer made under the product (the paper's overlap), and its
plain PyTorch version.

``gemm_with_rng`` launches the hand-written CUDA kernel
``csrc/gemm_rng.cu`` -- which replaces the TPU kernels
``src/repro/kernels/gemm_rng.py::_gemm_rng_kernel`` and, with the emission
switched off, ``_plain_gemm_impl.kern`` (the paper's Region 3) -- when its
operands lie on a CUDA device, and the plain version when they lie on the
CPU. A failed build or launch raises; nothing falls back.

The emission layout is judged on the JAX logical GEMM grid ``(gm, gn)``
(``block_m``/``block_n`` as ``core/producer.pick_gemm_blocks`` gives them),
so feasibility (Region 3) and the written rectangles are the JAX package's
exactly; the CUDA kernel's own 128 x 128 CTA tiling of the product is
independent of it. What bounds the kernel on an H100 (f32 operations) and
which CTA writes which block: see the note in ``csrc/gemm_rng.cu``.

Operands are f32 only; other dtypes raise
``NotImplementedError`` (ROADMAP: port queue, bf16 hosts).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gemm_ref
from repro_torch.kernels.philox_common import (
    SUPPORTED_PHILOX_ROUNDS,
    packed_rows_tile,
    seed_salt_words,
    threshold_from_p,
    to_int32_bits,
)

KERNEL = "gemm_rng"
# plain version: packed words per step (x 32 keep bits each)
_PLAIN_CHUNK_WORDS = 1 << 17

_launches = {"rng": 0, "plain": 0}
_fn = None


def launch_count() -> int:
    """Launches of the kernel, both variants."""
    return _launches["rng"] + _launches["plain"]


def variant_counts() -> dict:
    """Launches by variant: "rng" (emission on), "plain" (Region 3)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for key in _launches:
        _launches[key] = 0


# --------------------------------------------------------------------------
# emission layout (the JAX package's, verbatim)
# --------------------------------------------------------------------------

def _mask_layout(n_steps: int, mask_batch: int, mask_heads: int, sq32: int,
                 mask_sk: int, mask_block_cols: int,
                 max_mask_rows_per_block: int):
    """Partition of the flattened packed plane (BH*SQ32, SK) over GEMM grid
    steps: (ck, n_cb, rb, n_rb_valid, n_valid_blocks, mask_rows_alloc), or
    None when the grid cannot host the plane within the row budget (the
    paper's Region 3)."""
    mr = mask_batch * mask_heads * sq32
    ck = min(mask_block_cols, mask_sk)
    if mask_sk % ck:
        raise ValueError(f"mask_sk={mask_sk} is not a multiple of the "
                         f"{ck}-column mask block")
    n_cb = mask_sk // ck
    rows_per_block = max(1, n_steps // n_cb)
    rb = -(-mr // rows_per_block)
    rb = -(-rb // 8) * 8
    n_rb_valid = -(-mr // rb)
    n_valid_blocks = n_rb_valid * n_cb
    if rb > max_mask_rows_per_block or n_valid_blocks > n_steps:
        return None
    mask_rows_alloc = (n_rb_valid + 1) * rb
    return ck, n_cb, rb, n_rb_valid, n_valid_blocks, mask_rows_alloc


@dataclasses.dataclass(frozen=True)
class MaskEmissionLayout:
    """Which packed-plane rectangle each GEMM grid step emits. The local
    plane is (rows_valid, sk) words, rows_valid = B*H*SQ//32; ``blocks()``
    yields one rectangle per mask-producing step. ``rows_alloc`` is the
    TPU kernel's buffer height (a dummy overflow band for the steps past
    ``n_valid_blocks``); the CUDA kernel allocates exactly rows_valid."""
    n_steps: int
    rows_valid: int
    sk: int
    rb: int
    ck: int
    n_cb: int
    n_rb_valid: int
    n_valid_blocks: int
    rows_alloc: int

    def blocks(self) -> Iterator[Tuple[int, int, int, int, int]]:
        """(step, r0, r1, c0, c1): rows [r0, r1) x cols [c0, c1) written
        by step ``step``; the last row band is clipped to rows_valid."""
        for s in range(self.n_valid_blocks):
            rb_idx, cb_idx = s // self.n_cb, s % self.n_cb
            r0 = rb_idx * self.rb
            r1 = min(r0 + self.rb, self.rows_valid)
            c0 = cb_idx * self.ck
            yield s, r0, r1, c0, c0 + self.ck


def mask_emission_layout(n_steps: int, mask_batch: int, mask_heads: int,
                         sq: int, mask_sk: int, mask_block_cols: int = 2048,
                         max_mask_rows_per_block: int = 256
                         ) -> Optional[MaskEmissionLayout]:
    """The emission layout of a fused host with ``n_steps`` grid steps for
    a (mask_batch, mask_heads, sq, mask_sk) plane, or None in Region 3."""
    lay = _mask_layout(n_steps, mask_batch, mask_heads, sq // 32, mask_sk,
                       mask_block_cols, max_mask_rows_per_block)
    if lay is None:
        return None
    ck, n_cb, rb, n_rb_valid, n_valid_blocks, rows_alloc = lay
    return MaskEmissionLayout(
        n_steps=n_steps, rows_valid=mask_batch * mask_heads * (sq // 32),
        sk=mask_sk, rb=rb, ck=ck, n_cb=n_cb, n_rb_valid=n_rb_valid,
        n_valid_blocks=n_valid_blocks, rows_alloc=rows_alloc)


def mask_layout_feasible(n_steps: int, mask_batch: int, mask_heads: int,
                         sq: int, mask_sk: int, mask_block_cols: int = 2048,
                         max_mask_rows_per_block: int = 256) -> bool:
    """True when a GEMM grid of ``n_steps`` tiles can host the plane (not
    Region 3)."""
    return _mask_layout(n_steps, mask_batch, mask_heads, sq // 32, mask_sk,
                        mask_block_cols, max_mask_rows_per_block) is not None


# --------------------------------------------------------------------------
# the kernel and its plain version
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Emission:
    """What the fused launch writes: the layout and the counter words."""
    layout: MaskEmissionLayout
    sq32: int
    heads_local: int
    heads_global: int
    key_lo: int
    key_hi: int
    salt: int
    bh_offset: int
    threshold: int
    rounds: int


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load(KERNEL).repro_gemm_rng
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_uint32] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            mask: Optional[torch.Tensor], em: Optional[_Emission]) -> None:
    m, k = a.shape
    n = b.shape[1]
    if em is None:
        lay_args = [None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 7]
    else:
        lay = em.layout
        lay_args = [mask.data_ptr(), lay.rows_valid, lay.sk, em.sq32, lay.rb,
                    lay.ck, lay.n_cb, lay.n_valid_blocks, em.key_lo,
                    em.key_hi, em.salt, em.bh_offset, em.heads_local,
                    em.heads_global, em.threshold, em.rounds]
    with torch.cuda.device(a.device):
        err = _kernel_fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                           *lay_args,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_rng kernel launch failed: cudaError {err}")
    _launches["plain" if em is None else "rng"] += 1


def _plain_plane(em: _Emission, device) -> torch.Tensor:
    """The plain version's emission: every rectangle of the layout, as the
    flattened (rows_valid, sk) int32 plane. The rectangles tile the plane
    (row bands x column blocks), so whole bands are made at once."""
    lay = em.layout
    out = torch.empty((lay.rows_valid, lay.sk), dtype=torch.int32,
                      device=device)
    band = max(1, _PLAIN_CHUNK_WORDS // (lay.sk * lay.rb)) * lay.rb
    for r0 in range(0, lay.rows_valid, band):
        rows = min(band, lay.rows_valid - r0)
        out[r0:r0 + rows] = to_int32_bits(packed_rows_tile(
            r0, 0, em.sq32, em.salt, em.key_lo, em.key_hi, em.threshold,
            rows, lay.sk, em.rounds, heads_local=em.heads_local,
            heads_global=em.heads_global, bh_offset=em.bh_offset,
            device=device))
    return out


def _forward(a: torch.Tensor, b: torch.Tensor, em: Optional[_Emission]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(C, flattened plane or None) on the operands' device."""
    if a.device.type == "cuda":
        a, b = a.contiguous(), b.contiguous()
        c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                        device=a.device)
        mask = None if em is None else torch.empty(
            (em.layout.rows_valid, em.layout.sk), dtype=torch.int32,
            device=a.device)
        _launch(a, b, c, mask, em)
        return c, mask
    if a.device.type != "cpu":
        raise ValueError(f"no gemm_rng kernel for device {a.device}")
    return _plain(a, b, em)


def _plain(a, b, em: Optional[_Emission]):
    """The plain version on any device: (C, flattened plane or None)."""
    return gemm_ref(a, b), None if em is None else _plain_plane(em,
                                                                a.device)


class _GemmRng(torch.autograd.Function):
    """Forward: the kernel (or its plain version on the CPU). Backward: the
    textbook dgrad pair in f32 as torch.matmul -- the JAX package leaves
    it to XLA too (gemm_rng.py:281-296); the plane gets no gradient."""

    @staticmethod
    def forward(ctx, a, b, em):
        c, mask = _forward(a, b, em)
        ctx.save_for_backward(a, b)
        if mask is not None:
            ctx.mark_non_differentiable(mask)
        return c, mask

    @staticmethod
    def backward(ctx, dc, _dmask):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = dc @ b.T
        if ctx.needs_input_grad[1]:
            db = a.T @ dc
        return da, db, None


def _emission(a: torch.Tensor, b: torch.Tensor, mask_batch: int,
              mask_heads: int, mask_sq: int, mask_sk: int, p: float, seed,
              salt, rounds: int, block_m: int, block_n: int, block_k: int,
              mask_block_cols: int, max_mask_rows_per_block: int,
              heads_global: int, bh_offset) -> Optional[_Emission]:
    """Check the call as the JAX package does and resolve what the fused
    launch writes: the emission, or None in Region 3."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise NotImplementedError(
            f"gemm_with_rng takes f32 operands, got {a.dtype} "
            f"x {b.dtype} (ROADMAP: port queue, bf16 hosts)")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if rounds not in SUPPORTED_PHILOX_ROUNDS:
        raise ValueError(f"rounds={rounds}; expected one of "
                         f"{SUPPORTED_PHILOX_ROUNDS}")
    m, kdim = a.shape
    n = b.shape[1]
    bm, bn, bkk = min(block_m, m), min(block_n, n), min(block_k, kdim)
    if m % bm or n % bn or kdim % bkk:
        raise ValueError(f"blocks ({bm},{bn},{bkk}) do not tile the GEMM "
                         f"({m},{n},{kdim})")
    if mask_sq % 32:
        raise ValueError(f"mask_sq={mask_sq} must be a multiple of 32")
    layout = mask_emission_layout((m // bm) * (n // bn), mask_batch,
                                  mask_heads, mask_sq, mask_sk,
                                  mask_block_cols, max_mask_rows_per_block)
    if layout is None:
        return None
    k0, k1, salt_w, off = seed_salt_words(seed, salt, bh_offset)
    return _Emission(layout=layout, sq32=mask_sq // 32,
                     heads_local=mask_heads,
                     heads_global=heads_global or mask_heads, key_lo=k0,
                     key_hi=k1, salt=salt_w, bh_offset=off,
                     threshold=threshold_from_p(p), rounds=rounds)


def gemm_with_rng(a: torch.Tensor, b: torch.Tensor, *, mask_batch: int,
                  mask_heads: int, mask_sq: int, mask_sk: int, p: float,
                  seed, salt=0, rounds: int = 7, block_m: int = 256,
                  block_n: int = 256, block_k: int = 512,
                  mask_block_cols: int = 2048,
                  max_mask_rows_per_block: int = 256, heads_global: int = 0,
                  bh_offset=0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C = a @ b (f32) and the packed keep plane (B, H, SQ//32, SK) int32
    made under it; the plane is None in Region 3 (the caller makes it with
    the standalone kernel). Differentiable in a and b. ``seed`` is an int
    (64-bit key) or a 0-d CPU tensor (key_hi = 0); ``salt``/``bh_offset``
    ints or 0-d CPU tensors. ``heads_global``/``bh_offset`` make the call
    shard-local (see ``philox_common.global_bh``)."""
    em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk, p, seed,
                   salt, rounds, block_m, block_n, block_k, mask_block_cols,
                   max_mask_rows_per_block, heads_global, bh_offset)
    c, mask = _GemmRng.apply(a, b, em)
    if mask is None:
        return c, None
    return c, mask.reshape(mask_batch, mask_heads, mask_sq // 32, mask_sk)


def gemm_with_rng_plain(a: torch.Tensor, b: torch.Tensor, *, mask_batch: int,
                        mask_heads: int, mask_sq: int, mask_sk: int,
                        p: float, seed, salt=0, rounds: int = 7,
                        block_m: int = 256, block_n: int = 256,
                        block_k: int = 512, mask_block_cols: int = 2048,
                        max_mask_rows_per_block: int = 256,
                        heads_global: int = 0, bh_offset=0
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of ``gemm_with_rng`` on any device (no
    gradient)."""
    em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk, p, seed,
                   salt, rounds, block_m, block_n, block_k, mask_block_cols,
                   max_mask_rows_per_block, heads_global, bh_offset)
    c, mask = _plain(a, b, em)
    if mask is None:
        return c, None
    return c, mask.reshape(mask_batch, mask_heads, mask_sq // 32, mask_sk)
