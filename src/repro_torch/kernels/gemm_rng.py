"""Fused GEMM + dropout RNG: C = A @ B with the packed keep plane of one
attention layer made under the product (the paper's overlap), in f32, in
bf16 and on per-tile-scaled e4m3 operands, and the plain PyTorch
versions.

``gemm_with_rng`` launches a hand-written CUDA kernel -- which replaces the
TPU kernels ``src/repro/kernels/gemm_rng.py::_gemm_rng_kernel`` and, with
the emission switched off, ``_plain_gemm_impl.kern`` (the paper's Region
3) -- when its operands lie on a CUDA device, and the plain version when
they lie on the CPU: ``csrc/gemm_rng.cu`` for f32 operands (each f32
product as six bf16 ``wgmma`` part products of the operands' exact
triples, f32 sums; the tensor-core body ``csrc/gemm_tc.cuh``),
``csrc/gemm_rng_bf16.cu`` for bf16 ones (``wgmma`` with f32 sums, C
rounded once to bf16, as the JAX kernel's ``out_dtype`` cast; a
persistent body of its own, ``csrc/gemm_bf16.cuh``).
Their tensor maps read rows of 16-byte multiples: K and N must be
multiples of 4 (f32) or 8 (bf16) and the operands must start on 16 bytes,
or the wrapper raises ``NotImplementedError``. A failed build or launch
raises; nothing falls back, and no dtype is upcast to take another
kernel.

The emission layout is judged on the JAX logical GEMM grid ``(gm, gn)``
(``block_m``/``block_n`` as ``core/producer.pick_gemm_blocks`` gives them),
so feasibility (Region 3) and the written rectangles are the JAX package's
exactly; the CUDA kernels' own CTA tiling of the product (128 x 128, or
128 x 256 in clusters of two at bf16) is independent of it, and every CTA
writes an equal run of the plane's words (``csrc/gemm_emit.cuh``;
``csrc/gemm_walk.cuh`` at bf16), which needs the layout to tile the plane
(``layout_tiles_plane``; every layout ``mask_emission_layout`` makes does).
What bounds the kernel on an H100: see the note in ``csrc/gemm_rng.cu``.

``gemm_with_rng_fp8`` launches ``csrc/gemm_rng_fp8.cu`` -- which replaces
``_gemm_rng_fp8_kernel`` and, with the emission off, ``_plain_fp8_kernel``
-- on f32 or bf16 operands that ``quant.quantize_tiled`` turns (from their
exact f32 upcast) into e4m3 values and per-tile scales outside the kernel
(the scale tiles are the logical GEMM blocks); C comes back in the
operands' dtype, rounded once from the kernel's f32 result, as JAX's
``out_dtype=a.dtype``. Its plane is bitwise the f32 host's. The e4m3 kernels run on
Hopper's tensor cores (their e4m3 bytes converted exactly to f16 in shared
memory) and take B K-major, as (N, K) bytes: on the card the wrappers
transpose the quantized weight's bytes and scales (bitwise what
quantizing the transposed weight gives); every public function keeps
JAX's (K, N) layout.
``gemm_fp8_kernel_order`` is the kernels' order of summation in plain
torch.

``gemm_with_rng_grouped`` / ``gemm_with_rng_grouped_fp8`` are the grouped
hosts: C[e] = A[e] @ B[e] for E experts (a MoE block's expert einsum; E = 1
for the RWKV channel-mix key / value GEMM) with the plane made under the
products, by ``csrc/gemm_rng_grouped.cu`` for f32 operands and
``csrc/gemm_rng_grouped_bf16.cu`` for bf16 ones (replacing
``_gemm_rng_grouped_kernel`` and, emission off, ``_plain_grouped_impl.kern``)
and ``csrc/gemm_rng_grouped_fp8.cu`` (replacing
``_gemm_rng_grouped_fp8_kernel``). The emission layout is judged on the JAX
logical grid E * gm * gn; the bits do not depend on which tokens an expert
tile holds. In Region 3 both return the plain grouped product of the
operands' dtype (the fp8 host unquantized, as JAX's does) and no plane.

Every host takes f32 or bf16 operands (both of one dtype) and returns C in
that dtype; other dtypes raise ``NotImplementedError``. Each launch is an
operator of its own -- ``repro_torch::gemm_rng`` (the f32 / bf16 hosts,
dense or grouped) and ``repro_torch::gemm_rng_fp8`` (the e4m3 hosts) --
whose one implementation launches the kernel for CUDA operands and runs
the plain version for CPU ones, so a fake-tensor trace
(``analysis/dataflow.py``) records one opaque node a launch and runs
nothing; the ``autograd.Function``s around them keep the backward. Each
kernel instance counts its launches under its own name: the bf16-operand
e4m3 instances are ``gemm_rng_fp8_bf16`` and
``gemm_rng_grouped_fp8_bf16``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import build, quant
from repro_torch.kernels.ref import gemm_ref
from repro_torch.kernels.philox_common import (
    SUPPORTED_PHILOX_ROUNDS,
    packed_rows_tile,
    seed_salt_words,
    threshold_from_p,
    to_int32_bits,
)

KERNEL = "gemm_rng"
KERNEL_BF16 = "gemm_rng_bf16"
KERNEL_FP8 = "gemm_rng_fp8"
KERNEL_FP8_BF16 = "gemm_rng_fp8_bf16"
KERNEL_GROUPED = "gemm_rng_grouped"
KERNEL_GROUPED_BF16 = "gemm_rng_grouped_bf16"
KERNEL_GROUPED_FP8 = "gemm_rng_grouped_fp8"
KERNEL_GROUPED_FP8_BF16 = "gemm_rng_grouped_fp8_bf16"
# the e4m3 kernels' k-slice: one f16 wgmma
_FP8_SLICE_K = 16
# plain version: packed words per step (x 32 keep bits each)
_PLAIN_CHUNK_WORDS = 1 << 17

_fns = {}
# library (csrc/<name>.cu), C entry point and leading (operand and size)
# arguments of each kernel instance; the emission's arguments follow
_ENTRY = {KERNEL: (KERNEL, "repro_gemm_rng", 3, 3),
          KERNEL_BF16: (KERNEL_BF16, "repro_gemm_rng_bf16", 3, 3),
          KERNEL_FP8: (KERNEL_FP8, "repro_gemm_rng_fp8", 5, 7),
          KERNEL_FP8_BF16: (KERNEL_FP8, "repro_gemm_rng_fp8_bf16", 5, 7),
          KERNEL_GROUPED: (KERNEL_GROUPED, "repro_gemm_rng_grouped", 3, 4),
          KERNEL_GROUPED_BF16: (KERNEL_GROUPED_BF16,
                                "repro_gemm_rng_grouped_bf16", 3, 4),
          KERNEL_GROUPED_FP8: (KERNEL_GROUPED_FP8,
                               "repro_gemm_rng_grouped_fp8", 5, 8),
          KERNEL_GROUPED_FP8_BF16: (KERNEL_GROUPED_FP8,
                                    "repro_gemm_rng_grouped_fp8_bf16", 5, 8)}
# launches by kernel and variant: "rng" (emission on), "plain" (Region 3)
_launches = {name: {"rng": 0, "plain": 0} for name in _ENTRY}
# model (operand) dtype -> the kernel instance of each host; C has that
# dtype
_DENSE = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}
_GROUPED = {torch.float32: KERNEL_GROUPED, torch.bfloat16: KERNEL_GROUPED_BF16}
_FP8 = {torch.float32: KERNEL_FP8, torch.bfloat16: KERNEL_FP8_BF16}
_GROUPED_FP8 = {torch.float32: KERNEL_GROUPED_FP8,
                torch.bfloat16: KERNEL_GROUPED_FP8_BF16}


def launch_counts() -> dict:
    """Launches of each kernel, both variants."""
    return {name: sum(v.values()) for name, v in _launches.items()}


def variant_counts(kernel: str = KERNEL) -> dict:
    """Launches of ``kernel`` by variant: "rng" (emission on), "plain"
    (Region 3)."""
    return dict(_launches[kernel])


def reset_launch_count() -> None:
    for counts in _launches.values():
        for key in counts:
            counts[key] = 0


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


_EMIT_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 7
                  + [ctypes.c_uint32] * 4 + [ctypes.c_int] * 2
                  + [ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p])


def _kernel_fn(name: str):
    """The C entry point of kernel ``name``, built on first use."""
    fn = _fns.get(name)
    if fn is None:
        lib, entry, n_ptrs, n_ints = _ENTRY[name]
        fn = getattr(build.load(lib), entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + _EMIT_ARGTYPES)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, args, mask: Optional[torch.Tensor],
            em: Optional[_Emission], device: torch.device) -> None:
    """Launch kernel ``name`` on the current stream: ``args`` are its
    leading (operand and size) arguments, the emission's follow."""
    if em is None:
        lay_args = [None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 7]
    else:
        lay = em.layout
        if not layout_tiles_plane(lay):
            raise NotImplementedError(
                f"the {name} kernel takes only an emission layout that "
                f"tiles the plane; got {lay}")
        lay_args = [mask.data_ptr(), lay.rows_valid, lay.sk, em.sq32, lay.rb,
                    lay.ck, lay.n_cb, lay.n_valid_blocks, em.key_lo,
                    em.key_hi, em.salt, em.bh_offset, em.heads_local,
                    em.heads_global, em.threshold, em.rounds]
    with torch.cuda.device(device):
        err = _kernel_fn(name)(*args, *lay_args,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _launches[name]["plain" if em is None else "rng"] += 1


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


def _outputs(a: torch.Tensor, n: int, em: Optional[_Emission],
             dtype=torch.float32):
    """Empty C (``dtype``, ``a``'s leading dims by ``n``) and flattened
    plane (or None) for a launch."""
    c = torch.empty((*a.shape[:-1], n), dtype=dtype, device=a.device)
    mask = None if em is None else torch.empty(
        (em.layout.rows_valid, em.layout.sk), dtype=torch.int32,
        device=a.device)
    return c, mask


def _check_device(a: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    plain version); other devices raise."""
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} kernel for device {a.device}")
    return a.device.type == "cuda"


def _check_rows(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on f32 or bf16 operands the tensor maps of ``name`` cannot
    read: K and N multiples of 16 bytes' worth of elements (TMA's row
    stride: 4 at f32, 8 at bf16), operands on 16 bytes."""
    k, n = a.shape[-1], b.shape[-1]
    per = 16 // a.element_size()
    if k % per or n % per or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise NotImplementedError(
            f"the {name} kernel takes K and N multiples of {per} (TMA's "
            f"16-byte rows) and operands on 16 bytes, got K={k}, N={n}")


def layout_tiles_plane(lay: MaskEmissionLayout) -> bool:
    """True when the layout's valid rectangles tile the (rows_valid, sk)
    plane exactly -- whole row bands of n_cb blocks, the last band the only
    clipped one -- and the plane's words fit 32-bit indices: what the
    kernels' emission (``gemm_emit.cuh::emit_share``, and the bf16
    kernels' ``gemm_walk.cuh`` units) assumes."""
    if lay.n_valid_blocks <= 0 or lay.n_valid_blocks % lay.n_cb:
        return False
    n_rb = lay.n_valid_blocks // lay.n_cb
    return (n_rb * lay.rb >= lay.rows_valid
            and (n_rb - 1) * lay.rb < lay.rows_valid
            and lay.n_cb * lay.ck == lay.sk
            and lay.rows_valid * lay.sk < 2 ** 31)


def _pack(em: Optional[_Emission]) -> List[int]:
    """An emission as the int list an operator takes (empty: none)."""
    if em is None:
        return []
    return [*dataclasses.astuple(em.layout), em.sq32, em.heads_local,
            em.heads_global, em.key_lo, em.key_hi, em.salt, em.bh_offset,
            em.threshold, em.rounds]


def _unpack(words: List[int]) -> Optional[_Emission]:
    """The inverse of ``_pack``."""
    if not words:
        return None
    n = len(dataclasses.fields(MaskEmissionLayout))
    return _Emission(MaskEmissionLayout(*words[:n]), *words[n:])


def _plane_out(a: torch.Tensor, mask: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """An operator's plane output: the plane, or an empty one in Region 3
    (an operator returns tensors only)."""
    if mask is None:
        return torch.empty((0, 0), dtype=torch.int32, device=a.device)
    return mask


def _fake_outputs(a: torch.Tensor, n: int, emission: List[int],
                  dtype: torch.dtype):
    """The outputs' shapes without running anything (a trace's
    ``register_fake``)."""
    rows, sk = (emission[1], emission[2]) if emission else (0, 0)
    return (a.new_empty((*a.shape[:-1], n), dtype=dtype),
            a.new_empty((rows, sk), dtype=torch.int32))


def _launch_host(name: str, a: torch.Tensor, b: torch.Tensor,
                 em: Optional[_Emission]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the f32 / bf16 host ``name``, dense (a (M, K)) or
    grouped (a (E, M, K))."""
    a, b = a.contiguous(), b.contiguous()
    _check_rows(name, a, b)
    n = b.shape[-1]
    c, mask = _outputs(a, n, em, dtype=a.dtype)
    _launch(name, [a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   *a.shape[:-1], n, a.shape[-1]], mask, em, a.device)
    return c, mask


@torch.library.custom_op("repro_torch::gemm_rng", mutates_args=())
def _gemm_rng_op(a: torch.Tensor, b: torch.Tensor, emission: List[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the f32 / bf16 host of the operands' dtype as an
    operator of its own, dense or grouped (by a's rank): the kernel on the
    card, the plain version on the CPU. A trace (``make_fx``) records it
    as one opaque node and runs neither."""
    em = _unpack(emission)
    grouped = a.dim() == 3
    name = (_GROUPED if grouped else _DENSE)[a.dtype]
    if _check_device(a, name):
        c, mask = _launch_host(name, a, b, em)
    else:
        c, mask = (_plain_grouped if grouped else _plain)(a, b, em)
    return c, _plane_out(a, mask)


@_gemm_rng_op.register_fake
def _(a, b, emission):
    return _fake_outputs(a, b.shape[-1], emission, a.dtype)


def _forward(a: torch.Tensor, b: torch.Tensor, em: Optional[_Emission]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(C in the operands' dtype, flattened plane or None) on the operands'
    device: the kernel of their dtype on the card, the plain version on the
    CPU (``repro_torch::gemm_rng``)."""
    c, mask = _gemm_rng_op(a, b, _pack(em))
    return c, None if em is None else mask


def _plain(a, b, em: Optional[_Emission]):
    """The plain version on any device: (C, flattened plane or None); C is
    the f32 product of the upcast operands, rounded to their dtype."""
    return gemm_ref(a, b), None if em is None else _plain_plane(em,
                                                                a.device)


class _GemmRng(torch.autograd.Function):
    """Forward: the kernel (or its plain version on the CPU). Backward: the
    textbook dgrad pair as torch.matmul -- the JAX package leaves it to XLA
    too (``_dgrad_pair``, gemm_rng.py:281-285): products of the operand
    dtype's values with f32 sums, rounded once to that dtype. At bf16 the
    pair is a bf16 x bf16 torch.matmul: its products are exact and cuBLAS
    (and the CPU's bf16 GEMM) sums them in f32 and rounds the result once,
    which is JAX's upcast-multiply-downcast up to the order of the f32
    sums -- an f32 product of the upcast operands would take the card's
    f32 SIMT GEMMs. torch's default lets cuBLAS reduce split-k partial sums
    in bf16 (``allow_bf16_reduced_precision_reduction``, left as it is);
    the card-against-CPU tolerances of the bf16 step hold with it. The
    plane gets no gradient."""

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


def _check_operands(a: torch.Tensor, b: torch.Tensor, rounds: int,
                    mask_sq: int, grouped: bool) -> None:
    """Raise on a call the hosts do not take, as the JAX package asserts.
    Every host has a kernel for f32 and for bf16 operands."""
    if a.dtype not in _DENSE or b.dtype != a.dtype:
        raise NotImplementedError(
            f"the GEMM hosts take f32 or bf16 operands of one dtype, got "
            f"{a.dtype} x {b.dtype}")
    nd = 3 if grouped else 2
    if (a.dim() != nd or b.dim() != nd or a.shape[-1] != b.shape[-2]
            or (grouped and a.shape[0] != b.shape[0])):
        raise ValueError(f"bad {'grouped ' if grouped else ''}GEMM shapes "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if rounds not in SUPPORTED_PHILOX_ROUNDS:
        raise ValueError(f"rounds={rounds}; expected one of "
                         f"{SUPPORTED_PHILOX_ROUNDS}")
    if mask_sq % 32:
        raise ValueError(f"mask_sq={mask_sq} must be a multiple of 32")


def _blocks(m: int, n: int, kdim: int, block_m: int, block_n: int,
            block_k: int) -> Tuple[int, int, int]:
    """The logical GEMM blocks (bm, bn, bk) of one (m, n, kdim) product."""
    bm, bn, bkk = min(block_m, m), min(block_n, n), min(block_k, kdim)
    if m % bm or n % bn or kdim % bkk:
        raise ValueError(f"blocks ({bm},{bn},{bkk}) do not tile the GEMM "
                         f"({m},{n},{kdim})")
    return bm, bn, bkk


def _layout_emission(n_steps: int, mask_batch: int, mask_heads: int,
                     mask_sq: int, mask_sk: int, p: float, seed, salt,
                     rounds: int, mask_block_cols: int,
                     max_mask_rows_per_block: int, heads_global: int,
                     bh_offset) -> Optional[_Emission]:
    """What a fused launch on a logical grid of ``n_steps`` tiles writes:
    the emission, or None in Region 3."""
    layout = mask_emission_layout(n_steps, mask_batch, mask_heads, mask_sq,
                                  mask_sk, mask_block_cols,
                                  max_mask_rows_per_block)
    if layout is None:
        return None
    k0, k1, salt_w, off = seed_salt_words(seed, salt, bh_offset)
    return _Emission(
        layout=layout, sq32=mask_sq // 32, heads_local=mask_heads,
        heads_global=heads_global or mask_heads, key_lo=k0, key_hi=k1,
        salt=salt_w, bh_offset=off, threshold=threshold_from_p(p),
        rounds=rounds)


def _emission(a: torch.Tensor, b: torch.Tensor, mask_batch: int,
              mask_heads: int, mask_sq: int, mask_sk: int, p: float, seed,
              salt, rounds: int, block_m: int, block_n: int, block_k: int,
              mask_block_cols: int, max_mask_rows_per_block: int,
              heads_global: int, bh_offset, grouped: bool = False
              ) -> Tuple[Tuple[int, int, int], Optional[_Emission]]:
    """Check the call as the JAX package does and resolve the logical GEMM
    blocks (bm, bn, bk) and what the fused launch writes: the emission, or
    None in Region 3. ``grouped``: a (E, C, K) x (E, K, N) call, whose
    logical grid is E * gm * gn."""
    _check_operands(a, b, rounds, mask_sq, grouped)
    m, kdim = a.shape[-2:]
    n = b.shape[-1]
    bm, bn, bkk = _blocks(m, n, kdim, block_m, block_n, block_k)
    groups = a.shape[0] if grouped else 1
    em = _layout_emission(groups * (m // bm) * (n // bn), mask_batch,
                          mask_heads, mask_sq, mask_sk, p, seed, salt,
                          rounds, mask_block_cols, max_mask_rows_per_block,
                          heads_global, bh_offset)
    return (bm, bn, bkk), em


def _as_plane(mask: Optional[torch.Tensor], mask_batch: int,
              mask_heads: int, mask_sq: int, mask_sk: int):
    """The flattened plane as (B, H, SQ//32, SK), or None in Region 3."""
    if mask is None:
        return None
    return mask.reshape(mask_batch, mask_heads, mask_sq // 32, mask_sk)


def gemm_with_rng(a: torch.Tensor, b: torch.Tensor, *, mask_batch: int,
                  mask_heads: int, mask_sq: int, mask_sk: int, p: float,
                  seed, salt=0, rounds: int = 7, block_m: int = 256,
                  block_n: int = 256, block_k: int = 512,
                  mask_block_cols: int = 2048,
                  max_mask_rows_per_block: int = 256, heads_global: int = 0,
                  bh_offset=0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C = a @ b and the packed keep plane (B, H, SQ//32, SK) int32 made
    under it; the plane is None in Region 3 (the caller makes it with the
    standalone kernel). ``a`` and ``b`` are both f32 or both bf16; C has
    their dtype (f32 sums, rounded once), and the plane does not depend on
    it. Differentiable in a and b. ``seed`` is an int (64-bit key) or a 0-d
    CPU tensor (key_hi = 0); ``salt``/``bh_offset`` ints or 0-d CPU
    tensors. ``heads_global``/``bh_offset`` make the call shard-local (see
    ``philox_common.global_bh``)."""
    _, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk, p,
                      seed, salt, rounds, block_m, block_n, block_k,
                      mask_block_cols, max_mask_rows_per_block, heads_global,
                      bh_offset)
    c, mask = _GemmRng.apply(a, b, em)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


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
    _, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk, p,
                      seed, salt, rounds, block_m, block_n, block_k,
                      mask_block_cols, max_mask_rows_per_block, heads_global,
                      bh_offset)
    c, mask = _plain(a, b, em)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


# --------------------------------------------------------------------------
# the fp8 (e4m3) host
# --------------------------------------------------------------------------

def gemm_fp8_plain(a_q: torch.Tensor, a_s: torch.Tensor, b_q: torch.Tensor,
                   b_s: torch.Tensor, blocks: Tuple[int, int, int]
                   ) -> torch.Tensor:
    """The plain version of the e4m3 tile product: for each k-block kb of
    bk columns, C += (a_q[:, kb] @ b_q[kb, :]) * (a_s[i, kb] * b_s[kb, j])
    in f32 on the exactly decoded e4m3 values -- the JAX kernel's order of
    rounding (partial product, scale product, then the accumulate)."""
    bm, bn, bk = blocks
    a = a_q.to(torch.float32)
    b = b_q.to(torch.float32)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for kb in range(a.shape[1] // bk):
        part = a[:, kb * bk:(kb + 1) * bk] @ b[kb * bk:(kb + 1) * bk]
        scale = (a_s[:, kb].repeat_interleave(bm)[:, None]
                 * b_s[kb].repeat_interleave(bn)[None, :])
        acc += part * scale
    return acc


def gemm_fp8_kernel_order(a_q: torch.Tensor, a_s: torch.Tensor,
                          bt_q: torch.Tensor, bt_s: torch.Tensor,
                          blocks: Tuple[int, int, int]) -> torch.Tensor:
    """The e4m3 kernels' decomposition of ``gemm_fp8_plain`` in plain torch,
    on K-major operands (``bt_q`` (N, K), ``bt_s`` (N/bn, K/bk)): k16 slices
    (one f16 wgmma each), summed from zero over a k-block; a slice that
    straddles a k-block end issued once for each of its two k-blocks, with
    A's 8 k outside that block zeroed; the block's sum folded into the f32
    accumulator as acc + p * (a_s * b_s), element by element. Equal to
    ``gemm_fp8_plain`` up to the order of f32 rounding."""
    bm, bn, bk = blocks
    a = a_q.to(torch.float32)
    bt = bt_q.to(torch.float32)
    m, kdim = a.shape
    acc = torch.zeros((m, bt.shape[0]), dtype=torch.float32,
                      device=a.device)
    rows = torch.arange(m, device=a.device) // bm
    cols = torch.arange(bt.shape[0], device=a.device) // bn
    piece = None
    for k0 in range(0, kdim, _FP8_SLICE_K):
        k1 = k0 + _FP8_SLICE_K
        kb0, kb1 = k0 // bk, (k1 - 1) // bk
        for kb in range(kb0, kb1 + 1):
            a_slice = a[:, k0:k1].clone()
            a_slice[:, :max(kb * bk - k0, 0)] = 0.0
            a_slice[:, max((kb + 1) * bk - k0, 0):] = 0.0
            part = a_slice @ bt[:, k0:k1].T
            piece = part if piece is None else piece + part
            if kb < kb1 or k1 == (kb + 1) * bk:
                scale = a_s[rows, kb][:, None] * bt_s[cols, kb][None, :]
                acc = acc + piece * scale
                piece = None
    return acc


def _row_stride(t: torch.Tensor) -> int:
    """The row stride of a K-major operand in elements, or 0 when its rows
    are not packed rows of one buffer as the tensor maps read them: unit
    element stride, and an expert's rows right after the last one's."""
    if t.stride(-1) != 1 or (t.dim() == 3
                             and t.stride(0) != t.shape[1] * t.stride(1)):
        return 0
    return t.stride(-2)


def pad_k16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., K) as the e4m3 kernels' tensor maps take it: a view of a
    zero-padded (..., K rounded up to 16) copy when K % 16 (TMA's row stride
    is a multiple of 16 bytes), else ``t`` contiguous. The values and the
    shape are ``t``'s; the zeros past K are never read as operands."""
    k = t.shape[-1]
    if k % 16 == 0:
        return t.contiguous()
    buf = torch.zeros((*t.shape[:-1], -(-k // 16) * 16), dtype=t.dtype,
                      device=t.device)
    buf[..., :k] = t
    return buf[..., :k]


def _check_fp8_kmajor(name: str, a_q: torch.Tensor, a_s: torch.Tensor,
                      bt_q: torch.Tensor, bt_s: torch.Tensor,
                      blocks: Tuple[int, int, int], groups: int = 0) -> int:
    """Raise on K-major operands the e4m3 kernel ``name`` does not take:
    a_q (M, K) and bt_q (N, K) -- (E, M, K) and (E, N, K) for ``groups`` =
    E experts -- e4m3 starting on 16 bytes, rows of one stride, a multiple
    of 16 (the tensor maps' row stride; ``pad_k16`` makes one), a_s
    (E*M/bm, K/bk) and bt_s (E*N/bn, K/bk) contiguous f32, all on one
    device; k-blocks of a multiple of 8. Returns the row stride."""
    bm, bn, bk = blocks
    nd = 3 if groups else 2
    if a_q.dim() != nd or bt_q.dim() != nd:
        raise ValueError(f"{name} takes {nd}-d operands, got "
                         f"{tuple(a_q.shape)} x {tuple(bt_q.shape)}")
    e = groups or 1
    m, k = a_q.shape[-2:]
    n = bt_q.shape[-2]
    ldk = _row_stride(a_q)
    if bk % 8:
        raise NotImplementedError(
            f"the {name} kernel takes k-blocks of a multiple of 8, got "
            f"bk={bk}")
    ops = (a_q, a_s, bt_q, bt_s)
    dtypes = (quant.fp8_dtype(), torch.float32) * 2
    if (any(t.dtype != dt for t, dt in zip(ops, dtypes))
            or any(t.device != a_q.device for t in ops)
            or not (a_s.is_contiguous() and bt_s.is_contiguous())
            or ldk < k or ldk % 16 or _row_stride(bt_q) != ldk
            or bt_q.shape[-1] != k or (groups and bt_q.shape[0] != e)
            or m % bm or n % bn or k % bk
            or a_s.shape != (e * (m // bm), k // bk)
            or bt_s.shape != (e * (n // bn), k // bk)):
        raise ValueError(
            f"{name} takes K-major e4m3 operands with rows of one stride, a "
            f"multiple of 16 (pad_k16), and contiguous f32 scales of the "
            f"({bm},{bn},{bk}) blocks on one device, got "
            f"{[(t.dtype, tuple(t.shape), t.stride()) for t in ops]} on "
            f"{[str(t.device) for t in ops]}")
    if a_q.data_ptr() % 16 or bt_q.data_ptr() % 16:
        raise ValueError(f"{name} takes operands that start on 16 bytes")
    return ldk


@torch.library.custom_op("repro_torch::gemm_rng_fp8", mutates_args=())
def _gemm_rng_fp8_op(a_q: torch.Tensor, a_s: torch.Tensor,
                     bt_q: torch.Tensor, bt_s: torch.Tensor,
                     blocks: List[int], emission: List[int],
                     out_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the e4m3 host of ``out_dtype`` on K-major operands as
    an operator of its own, dense (a_q (M, K)) or grouped (a_q (E, M, K)):
    the kernel on the card, the plain version on the CPU (on the
    operands laid out as JAX's, contiguous). A trace records it as one
    opaque node and runs neither."""
    em = _unpack(emission)
    blocks = tuple(blocks)
    grouped = a_q.dim() == 3
    name = (_GROUPED_FP8 if grouped else _FP8)[out_dtype]
    if not _check_device(a_q, name):
        bm, bn, bk = blocks
        k = a_q.shape[-1]
        n = bt_q.shape[-2]
        a_q = a_q.contiguous()
        b_q = bt_q.transpose(-1, -2).contiguous()
        if grouped:
            e = a_q.shape[0]
            b_s = bt_s.reshape(e, n // bn, k // bk).transpose(1, 2).reshape(
                e * (k // bk), n // bn)
            c = gemm_grouped_fp8_plain(a_q, a_s, b_q, b_s, blocks, out_dtype)
        else:
            c = gemm_fp8_plain(a_q, a_s, b_q, bt_s.T.contiguous(),
                               blocks).to(out_dtype)
        mask = None if em is None else _plain_plane(em, a_q.device)
        return c, _plane_out(a_q, mask)
    groups = a_q.shape[0] if grouped else 0
    ldk = _check_fp8_kmajor(name, a_q, a_s, bt_q, bt_s, blocks, groups)
    bm, bn, bk = blocks
    n = bt_q.shape[-2]
    c, mask = _outputs(a_q, n, em, dtype=out_dtype)
    _launch(name,
            [a_q.data_ptr(), bt_q.data_ptr(), a_s.data_ptr(),
             bt_s.data_ptr(), c.data_ptr(), *a_q.shape[:-1], n,
             a_q.shape[-1], ldk, bm, bn, bk], mask, em, a_q.device)
    return c, _plane_out(a_q, mask)


@_gemm_rng_fp8_op.register_fake
def _(a_q, a_s, bt_q, bt_s, blocks, emission, out_dtype):
    return _fake_outputs(a_q, bt_q.shape[-2], emission, out_dtype)


def gemm_rng_fp8_kmajor(a_q: torch.Tensor, a_s: torch.Tensor,
                        bt_q: torch.Tensor, bt_s: torch.Tensor,
                        blocks: Tuple[int, int, int],
                        em: Optional[_Emission],
                        out_dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fp8 host on K-major operands: a_q (M, K), bt_q (N, K) (= b_q.T),
    rows of one stride as ``pad_k16`` gives them, and their scales a_s
    (M/bm, K/bk), bt_s (N/bn, K/bk) (= b_s.T). Launches the kernel instance
    of ``out_dtype`` (f32, or bf16 for bf16 model operands: C rounded once)
    for CUDA tensors (or raises), the plain version for CPU ones
    (``repro_torch::gemm_rng_fp8``): (C, flattened plane or None)."""
    c, mask = _gemm_rng_fp8_op(a_q, a_s, bt_q, bt_s, list(blocks),
                               _pack(em), out_dtype)
    return c, None if em is None else mask


def gemm_rng_fp8_quantized(a_q: torch.Tensor, a_s: torch.Tensor,
                           b_q: torch.Tensor, b_s: torch.Tensor,
                           blocks: Tuple[int, int, int],
                           em: Optional[_Emission],
                           out_dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fp8 host on operands already quantized per logical block
    ``blocks`` = (bm, bn, bk), in JAX's layout (b_q (K, N), b_s (K/bk,
    N/bn)): (C in ``out_dtype``, flattened plane or None), through
    ``gemm_rng_fp8_kmajor`` on b's bytes and scales transposed to K-major
    (both operands' rows zero-padded to a multiple of 16 bytes where K is
    not): the kernel for CUDA tensors, the plain version for CPU ones."""
    if b_q.dim() != 2 or b_s.dim() != 2:
        raise ValueError(f"{KERNEL_FP8} takes a 2-d (K, N) operand, got "
                         f"{tuple(b_q.shape)}")
    return gemm_rng_fp8_kmajor(pad_k16(a_q), a_s, pad_k16(b_q.T),
                               b_s.T.contiguous(), blocks, em, out_dtype)


def _forward_fp8(a: torch.Tensor, b: torch.Tensor,
                 blocks: Tuple[int, int, int], em: Optional[_Emission]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize per logical block (the exact f32 upcast of bf16 operands),
    then the fp8 host; C in the operands' dtype."""
    bm, bn, bk = blocks
    a_q, a_s = quant.quantize_tiled(a, bm, bk)
    b_q, b_s = quant.quantize_tiled(b, bk, bn)
    return gemm_rng_fp8_quantized(a_q, a_s, b_q, b_s, blocks, em, a.dtype)


def _plain_fp8(a_q, a_s, b_q, b_s, blocks, em: Optional[_Emission],
               out_dtype: torch.dtype = torch.float32):
    """The plain version of the fp8 host on any device: the f32 tile
    product rounded once to ``out_dtype``."""
    c = gemm_fp8_plain(a_q, a_s, b_q, b_s, blocks).to(out_dtype)
    return c, None if em is None else _plain_plane(em, a_q.device)


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _dgrad_cast(a: torch.Tensor):
    """How the fp8 hosts' dgrad pair (JAX's ``_dgrad_pair_bf16`` /
    ``_grouped_dgrad_pair_bf16``: operands rounded to bf16, f32 sums, the
    result cast to the operand dtype) takes its operands: for f32 ones
    bf16-rounded values in f32 -- a bf16 x bf16 torch.matmul would round
    its f32 result to bf16 -- and for bf16 ones bf16 (a bf16 torch.matmul:
    exact products, f32 sums rounded once to bf16, JAX's cast back)."""
    if a.dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16)
    return _bf16_f32


class _GemmRngFp8(torch.autograd.Function):
    """Forward: quantize, then the fp8 kernel (or its plain version on the
    CPU). Backward: straight-through quantization -- the gradients are
    taken with respect to the unquantized operands, which the residual
    keeps -- and the dgrad pair on bf16-rounded operands with f32
    accumulation, as JAX's ``_dgrad_pair_bf16`` (XLA there, torch.matmul
    here; ``_dgrad_cast``)."""

    @staticmethod
    def forward(ctx, a, b, blocks, em):
        c, mask = _forward_fp8(a, b, blocks, em)
        ctx.save_for_backward(a, b)
        if mask is not None:
            ctx.mark_non_differentiable(mask)
        return c, mask

    @staticmethod
    def backward(ctx, dc, _dmask):
        a, b = ctx.saved_tensors
        cast = _dgrad_cast(a)
        dcb = cast(dc)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = dcb @ cast(b).T
        if ctx.needs_input_grad[1]:
            db = cast(a).T @ dcb
        return da, db, None, None


def gemm_with_rng_fp8(a: torch.Tensor, b: torch.Tensor, *, mask_batch: int,
                      mask_heads: int, mask_sq: int, mask_sk: int, p: float,
                      seed, salt=0, rounds: int = 7, block_m: int = 256,
                      block_n: int = 256, block_k: int = 512,
                      mask_block_cols: int = 2048,
                      max_mask_rows_per_block: int = 256,
                      heads_global: int = 0, bh_offset=0
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C ~= a @ b computed on e4m3 operands quantized per logical block
    (a per (bm, bk), b per (bk, bn), from the exact f32 upcast of f32 or
    bf16 operands), and the packed keep plane made under it -- bitwise the
    f32 host's plane. C has the operands' dtype (rounded once) and is
    within ``quant.quantize_error_bound()`` (Frobenius-relative) of the
    f32 product. The plane is None in Region 3 (the kernel runs with the
    emission off). Differentiable: straight-through quantization, bf16
    dgrad pair. Arguments as ``gemm_with_rng``."""
    blocks, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk,
                           p, seed, salt, rounds, block_m, block_n, block_k,
                           mask_block_cols, max_mask_rows_per_block,
                           heads_global, bh_offset)
    c, mask = _GemmRngFp8.apply(a, b, blocks, em)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


def gemm_with_rng_fp8_plain(a: torch.Tensor, b: torch.Tensor, *,
                            mask_batch: int, mask_heads: int, mask_sq: int,
                            mask_sk: int, p: float, seed, salt=0,
                            rounds: int = 7, block_m: int = 256,
                            block_n: int = 256, block_k: int = 512,
                            mask_block_cols: int = 2048,
                            max_mask_rows_per_block: int = 256,
                            heads_global: int = 0, bh_offset=0
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of ``gemm_with_rng_fp8`` on any device (no
    gradient)."""
    blocks, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk,
                           p, seed, salt, rounds, block_m, block_n, block_k,
                           mask_block_cols, max_mask_rows_per_block,
                           heads_global, bh_offset)
    bm, bn, bk = blocks
    a_q, a_s = quant.quantize_tiled(a, bm, bk)
    b_q, b_s = quant.quantize_tiled(b, bk, bn)
    c, mask = _plain_fp8(a_q, a_s, b_q, b_s, blocks, em, a.dtype)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


# --------------------------------------------------------------------------
# the grouped hosts (MoE expert einsum, RWKV channel-mix with E = 1)
# --------------------------------------------------------------------------

def gemm_grouped_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the grouped product: one ``gemm_ref`` an expert
    (the upcast operands' f32 product, rounded once to their dtype)."""
    return torch.stack([gemm_ref(a[e], b[e]) for e in range(a.shape[0])])


def _plain_grouped(a, b, em: Optional[_Emission]):
    """The plain version of the grouped host on any device."""
    c = gemm_grouped_plain(a, b)
    return c, None if em is None else _plain_plane(em, a.device)


def _forward_grouped(a: torch.Tensor, b: torch.Tensor,
                     em: Optional[_Emission]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(C in the operands' dtype, flattened plane or None) of the grouped
    host on the operands' device: the kernel of their dtype on the card,
    the plain version on the CPU (``repro_torch::gemm_rng``)."""
    return _forward(a, b, em)


def _grouped_dgrad(a, b, dc, needs, cast=lambda t: t):
    """The per-expert dgrad pair, da[e] = dc[e] @ b[e]^T and db[e] =
    a[e]^T @ dc[e], as JAX's ``_grouped_dgrad_pair`` (``cast`` rounds the
    operands first: ``_dgrad_cast`` for the fp8 host's pair). On bf16
    operands (dc is bf16 too) it is a bf16 torch.bmm: exact products, f32
    sums rounded once, JAX's f32 einsum cast back to bf16."""
    dcc = cast(dc)
    da = dcc @ cast(b).transpose(1, 2) if needs[0] else None
    db = cast(a).transpose(1, 2) @ dcc if needs[1] else None
    return da, db


class _GemmRngGrouped(torch.autograd.Function):
    """Forward: the grouped kernel of the operands' dtype (or its plain
    version on the CPU). Backward: the per-expert dgrad pair with f32 sums
    (JAX's ``_grouped_dgrad_pair``, plain products outside any kernel there
    too); the plane gets no gradient."""

    @staticmethod
    def forward(ctx, a, b, em):
        c, mask = _forward_grouped(a, b, em)
        ctx.save_for_backward(a, b)
        if mask is not None:
            ctx.mark_non_differentiable(mask)
        return c, mask

    @staticmethod
    def backward(ctx, dc, _dmask):
        a, b = ctx.saved_tensors
        return (*_grouped_dgrad(a, b, dc, ctx.needs_input_grad[:2]), None)


def gemm_with_rng_grouped(a: torch.Tensor, b: torch.Tensor, *,
                          mask_batch: int, mask_heads: int, mask_sq: int,
                          mask_sk: int, p: float, seed, salt=0,
                          rounds: int = 7, block_m: int = 256,
                          block_n: int = 256, block_k: int = 512,
                          mask_block_cols: int = 2048,
                          max_mask_rows_per_block: int = 256,
                          heads_global: int = 0, bh_offset=0
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C[e] = a[e] @ b[e] for a (E, C, K) and b (E, K, N), both f32 or both
    bf16 (f32 sums, C rounded once to their dtype), and the packed keep
    plane (B, H, SQ//32, SK) int32 made under the products:
    mask blocks go round-robin over the E * gm * gn logical expert tiles
    and are indexed by Philox counters only, so the routing never reaches
    the bits. The plane is None in Region 3 (the kernel runs with the
    emission off; the caller makes the plane with the standalone kernel).
    Differentiable in a and b. Arguments as ``gemm_with_rng``."""
    _, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk, p,
                      seed, salt, rounds, block_m, block_n, block_k,
                      mask_block_cols, max_mask_rows_per_block, heads_global,
                      bh_offset, grouped=True)
    c, mask = _GemmRngGrouped.apply(a, b, em)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


def gemm_with_rng_grouped_plain(a: torch.Tensor, b: torch.Tensor, *,
                                mask_batch: int, mask_heads: int,
                                mask_sq: int, mask_sk: int, p: float, seed,
                                salt=0, rounds: int = 7, block_m: int = 256,
                                block_n: int = 256, block_k: int = 512,
                                mask_block_cols: int = 2048,
                                max_mask_rows_per_block: int = 256,
                                heads_global: int = 0, bh_offset=0
                                ) -> Tuple[torch.Tensor,
                                           Optional[torch.Tensor]]:
    """The plain version of ``gemm_with_rng_grouped`` on any device (no
    gradient)."""
    _, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk, p,
                      seed, salt, rounds, block_m, block_n, block_k,
                      mask_block_cols, max_mask_rows_per_block, heads_global,
                      bh_offset, grouped=True)
    c, mask = _plain_grouped(a, b, em)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


def quantize_grouped(a: torch.Tensor, b: torch.Tensor,
                     blocks: Tuple[int, int, int]):
    """Per expert tile e4m3 operands of the grouped fp8 host, as JAX's
    ``_gemm_rng_grouped_fp8_impl`` makes them: the expert folds into
    ``quant.quantize_tiled``'s tile rows. Returns (a_q (E, C, K), a_s
    (E*gm, gk), b_q (E, K, N), b_s (E*gk, gn))."""
    bm, bn, bk = blocks
    e, c, kdim = a.shape
    n = b.shape[2]
    a_q, a_s = quant.quantize_tiled(a.reshape(e * c, kdim), bm, bk)
    b_q, b_s = quant.quantize_tiled(b.reshape(e * kdim, n), bk, bn)
    return a_q.reshape(e, c, kdim), a_s, b_q.reshape(e, kdim, n), b_s


def gemm_grouped_fp8_plain(a_q: torch.Tensor, a_s: torch.Tensor,
                           b_q: torch.Tensor, b_s: torch.Tensor,
                           blocks: Tuple[int, int, int],
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The plain version of the grouped e4m3 tile product: ``gemm_fp8_plain``
    on each expert's operands and scale rows, rounded once to
    ``out_dtype``."""
    bm, _, bk = blocks
    e, c, kdim = a_q.shape
    gm, gk = c // bm, kdim // bk
    return torch.stack([
        gemm_fp8_plain(a_q[i], a_s[i * gm:(i + 1) * gm], b_q[i],
                       b_s[i * gk:(i + 1) * gk], blocks).to(out_dtype)
        for i in range(e)])


def kmajor_grouped(b_q: torch.Tensor, b_s: torch.Tensor,
                   blocks: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's grouped weight operand (b_q (E, K, N), b_s (E*gk, gn)) as the
    grouped e4m3 kernel takes it, K-major: (bt_q (E, N, K), bt_s (E*gn,
    gk)), each expert's bytes and scales transposed -- bitwise what
    quantizing the transposed weight gives (the same tiles, amax and
    division)."""
    _, bn, bk = blocks
    e, kdim, n = b_q.shape
    bt_s = b_s.reshape(e, kdim // bk, n // bn).transpose(1, 2)
    return (b_q.transpose(1, 2).contiguous(),
            bt_s.reshape(e * (n // bn), kdim // bk).contiguous())


def gemm_rng_grouped_fp8_kmajor(a_q: torch.Tensor, a_s: torch.Tensor,
                                bt_q: torch.Tensor, bt_s: torch.Tensor,
                                blocks: Tuple[int, int, int],
                                em: Optional[_Emission],
                                out_dtype: torch.dtype = torch.float32
                                ) -> Tuple[torch.Tensor,
                                           Optional[torch.Tensor]]:
    """The grouped fp8 host on K-major operands: a_q (E, C, K), a_s (E*gm,
    gk) as ``quantize_grouped`` gives them, bt_q (E, N, K) and bt_s (E*gn,
    gk) as ``kmajor_grouped`` does (rows of one stride, as ``pad_k16``
    gives them): (C in ``out_dtype``, flattened plane or None). Launches the
    kernel instance of ``out_dtype`` for CUDA tensors (or raises), the
    plain version for CPU ones (``repro_torch::gemm_rng_fp8``)."""
    return gemm_rng_fp8_kmajor(a_q, a_s, bt_q, bt_s, blocks, em, out_dtype)


def gemm_rng_grouped_fp8_quantized(a_q: torch.Tensor, a_s: torch.Tensor,
                                   b_q: torch.Tensor, b_s: torch.Tensor,
                                   blocks: Tuple[int, int, int],
                                   em: Optional[_Emission],
                                   out_dtype: torch.dtype = torch.float32
                                   ) -> Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]:
    """The grouped fp8 host on operands already quantized by
    ``quantize_grouped`` (JAX's layout: b_q (E, K, N), b_s (E*gk, gn)):
    (C in ``out_dtype``, flattened plane or None), through
    ``gemm_rng_grouped_fp8_kmajor`` on b's bytes and scales transposed to
    K-major (both operands' rows zero-padded to a multiple of 16 bytes where
    K is not): the kernel for CUDA tensors, the plain version for CPU
    ones."""
    _, bn, bk = blocks
    if b_q.dim() != 3 or b_s.dim() != 2:
        raise ValueError(f"{KERNEL_GROUPED_FP8} takes a 3-d (E, K, N) "
                         f"operand, got {tuple(b_q.shape)}")
    e, k, n = b_q.shape
    if b_s.shape != (e * (k // bk), n // bn):
        raise ValueError(f"{KERNEL_GROUPED_FP8}: scales {tuple(b_s.shape)} "
                         f"do not match {tuple(b_q.shape)} in ({bk},{bn}) "
                         f"tiles")
    bt_q, bt_s = kmajor_grouped(b_q, b_s, blocks)
    return gemm_rng_grouped_fp8_kmajor(pad_k16(a_q), a_s, pad_k16(bt_q),
                                       bt_s, blocks, em, out_dtype)


class _GemmRngGroupedFp8(torch.autograd.Function):
    """Forward: quantize per expert tile, then the grouped e4m3 kernel (or
    its plain version on the CPU); C in the operands' dtype. Backward:
    straight-through quantization and the per-expert dgrad pair on
    bf16-rounded operands with f32 accumulation, as JAX's
    ``_grouped_dgrad_pair_bf16``."""

    @staticmethod
    def forward(ctx, a, b, blocks, em):
        c, mask = gemm_rng_grouped_fp8_quantized(
            *quantize_grouped(a, b, blocks), blocks, em, a.dtype)
        ctx.save_for_backward(a, b)
        if mask is not None:
            ctx.mark_non_differentiable(mask)
        return c, mask

    @staticmethod
    def backward(ctx, dc, _dmask):
        a, b = ctx.saved_tensors
        return (*_grouped_dgrad(a, b, dc, ctx.needs_input_grad[:2],
                                cast=_dgrad_cast(a)), None, None)


def gemm_with_rng_grouped_fp8(a: torch.Tensor, b: torch.Tensor, *,
                              mask_batch: int, mask_heads: int,
                              mask_sq: int, mask_sk: int, p: float, seed,
                              salt=0, rounds: int = 7, block_m: int = 256,
                              block_n: int = 256, block_k: int = 512,
                              mask_block_cols: int = 2048,
                              max_mask_rows_per_block: int = 256,
                              heads_global: int = 0, bh_offset=0
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """The grouped host on e4m3 operands quantized per expert tile (a per
    (e, bm, bk), b per (e, bk, bn), from the exact f32 upcast of f32 or
    bf16 operands), and the packed keep plane made under it -- bitwise the
    f32 hosts' plane; C in the operands' dtype. In Region 3 the product runs
    unquantized on the grouped kernel of the operands' dtype with the
    emission off, and the plane is None, as JAX's host does.
    Differentiable: straight-through quantization, bf16 dgrad pair (the
    grouped host's pair in Region 3). Arguments as ``gemm_with_rng``."""
    blocks, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk,
                           p, seed, salt, rounds, block_m, block_n, block_k,
                           mask_block_cols, max_mask_rows_per_block,
                           heads_global, bh_offset, grouped=True)
    if em is None:
        return _GemmRngGrouped.apply(a, b, None)
    c, mask = _GemmRngGroupedFp8.apply(a, b, blocks, em)
    return c, _as_plane(mask, mask_batch, mask_heads, mask_sq, mask_sk)


def gemm_with_rng_grouped_fp8_plain(a: torch.Tensor, b: torch.Tensor, *,
                                    mask_batch: int, mask_heads: int,
                                    mask_sq: int, mask_sk: int, p: float,
                                    seed, salt=0, rounds: int = 7,
                                    block_m: int = 256, block_n: int = 256,
                                    block_k: int = 512,
                                    mask_block_cols: int = 2048,
                                    max_mask_rows_per_block: int = 256,
                                    heads_global: int = 0, bh_offset=0
                                    ) -> Tuple[torch.Tensor,
                                               Optional[torch.Tensor]]:
    """The plain version of ``gemm_with_rng_grouped_fp8`` on any device (no
    gradient)."""
    blocks, em = _emission(a, b, mask_batch, mask_heads, mask_sq, mask_sk,
                           p, seed, salt, rounds, block_m, block_n, block_k,
                           mask_block_cols, max_mask_rows_per_block,
                           heads_global, bh_offset, grouped=True)
    if em is None:
        return gemm_grouped_plain(a, b), None
    ops = quantize_grouped(a, b, blocks)
    c = gemm_grouped_fp8_plain(*ops, blocks, a.dtype)
    return c, _as_plane(_plain_plane(em, a.device), mask_batch, mask_heads,
                        mask_sq, mask_sk)
