"""Standalone dropout-RNG kernel: the packed keep plane (B, H, SQ//32, SK)
of one attention layer, and its plain PyTorch version.

``philox_mask_into`` launches the hand-written CUDA kernel
``csrc/philox_mask.cu`` (which replaces the TPU kernel
``src/repro/kernels/philox.py::_philox_kernel``) when its output lies on a
CUDA device, and computes the plain version when it lies on the CPU. There
is no other path: a failed build or launch raises.

What bounds the kernel on an H100 is integer instructions, not memory:
8 Philox calls of ROUNDS rounds and 32 keep bits a 4-byte word, at least
224 instructions a word at 7 rounds once the products and xors that
several words share are counted once (``chip_smoke.philox_word_ops``).
The multiplies run only on the multiply-add pipe, at half its rate, and
the xors and compares only on the ALU pipe, each pipe half of the issue
lanes, so the pipes' load, not the issue rate, sets the least time
(``chip_smoke.philox_bound``). The kernel computes what a word's 8 calls
share once (``packed_word_shared`` in ``csrc/philox.cuh``), makes each
product one ``mul.wide.u32`` and each keep bit a subtract and an add with
carry (one instruction on each pipe), and walks the plane with a
persistent grid, each thread four consecutive words of a row at a time,
with no division in its loop (``csrc/philox_walk.cuh``); see the note in
``csrc/philox_mask.cu``.

Planes are ``torch.int32`` holding the uint32 bit pattern
(``philox_common.to_int32_bits``). The launch is the operator
``repro_torch::philox_mask`` (it writes ``out``): a fake-tensor trace
(``analysis/dataflow.py``) records it as one node and runs nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.philox_common import (
    SUPPORTED_PHILOX_ROUNDS,
    global_bh,
    packed_tile_from_counters,
    split_seed,
    threshold_from_p,
    to_int32_bits,
)

KERNEL = "philox_mask"
# plain version: (b, h) rows and packed rows per step, so that one step
# holds at most this many mask elements
_PLAIN_CHUNK_ELEMS = 1 << 22

_launches = 0
_fn = None


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _kernel_fn():
    """The bound C entry point, built on first use."""
    global _fn
    if _fn is None:
        fn = build.load(KERNEL).repro_philox_mask
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _plain_words(batch: int, n_heads: int, sq32: int, sk: int, key_lo: int,
                 key_hi: int, salt: int, threshold: int, rounds: int,
                 heads_global: int, bh_offset: int,
                 device: torch.device) -> torch.Tensor:
    """(B*H, SQ32, SK) int32 plane, in steps of bounded size."""
    out = torch.empty((batch * n_heads, sq32, sk), dtype=torch.int32,
                      device=device)
    per_bh = sq32 * 32 * sk
    bh_step = max(1, _PLAIN_CHUNK_ELEMS // max(per_bh, 1))
    row_step = sq32 if bh_step > 1 else max(
        1, _PLAIN_CHUNK_ELEMS // (32 * max(sk, 1)))
    for b0 in range(0, batch * n_heads, bh_step):
        local = torch.arange(b0, min(b0 + bh_step, batch * n_heads),
                             device=device, dtype=torch.int64)
        bh = global_bh(local, n_heads, heads_global, bh_offset)
        for r0 in range(0, sq32, row_step):
            rows = min(row_step, sq32 - r0)
            words = packed_tile_from_counters(r0, 0, bh, salt, key_lo,
                                              key_hi, threshold, rows, sk,
                                              rounds)
            out[b0:b0 + local.numel(), r0:r0 + rows] = to_int32_bits(words)
    return out


@torch.library.custom_op("repro_torch::philox_mask", mutates_args=("out",))
def _philox_op(out: torch.Tensor, key_lo: int, key_hi: int, salt: int,
               threshold: int, rounds: int, heads_global: int,
               bh_offset: int) -> None:
    """One launch as an operator of its own: the kernel on a CUDA ``out``,
    the plain version on a CPU one. A trace (``make_fx``) records it as
    one opaque node and runs neither (``register_fake`` below)."""
    global _launches
    batch, n_heads, sq32, sk = out.shape
    if out.device.type == "cuda":
        fn = _kernel_fn()
        with torch.cuda.device(out.device):
            err = fn(out.data_ptr(), batch, n_heads, sq32, sk, key_lo,
                     key_hi, salt, threshold, rounds, heads_global,
                     bh_offset, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"philox_mask kernel launch failed: "
                               f"cudaError {err}")
        _launches += 1
        return
    out.copy_(_plain_words(batch, n_heads, sq32, sk, key_lo, key_hi, salt,
                           threshold, rounds, heads_global, bh_offset,
                           out.device).reshape(out.shape))


@_philox_op.register_fake
def _(out, key_lo, key_hi, salt, threshold, rounds, heads_global,
      bh_offset):
    return None


def philox_mask_into(out: torch.Tensor, *, key_lo: int, key_hi: int,
                     salt: int, threshold: int, rounds: int = 7,
                     heads_global: int = 0, bh_offset: int = 0
                     ) -> torch.Tensor:
    """Fill ``out`` (B, H, SQ//32, SK) int32 with the packed keep plane.
    ``heads_global``/``bh_offset`` make the call shard-local: ``out`` is
    the (B, H) tile of the global (B_global, H_global) plane that starts
    at flattened index ``bh_offset``."""
    if out.dtype != torch.int32 or out.dim() != 4 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous 4-d int32 tensor, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if rounds not in SUPPORTED_PHILOX_ROUNDS:
        raise ValueError(f"rounds={rounds}; expected one of "
                         f"{SUPPORTED_PHILOX_ROUNDS}")
    if out.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no philox_mask kernel for device {out.device}")
    _philox_op(out, key_lo, key_hi, salt, threshold, rounds,
               heads_global or out.shape[1], bh_offset)
    return out


def _key_args(p: float, seed, salt, bh_offset):
    key_lo, key_hi = split_seed(seed)
    return dict(key_lo=key_lo, key_hi=key_hi, salt=int(salt) & 0xFFFFFFFF,
                threshold=threshold_from_p(p),
                bh_offset=int(bh_offset) & 0xFFFFFFFF)


def philox_dropout_mask(batch: int, n_heads: int, sq: int, sk: int,
                        p: float, seed, salt=0, rounds: int = 7,
                        heads_global: int = 0, bh_offset=0,
                        device: DeviceLike = None) -> torch.Tensor:
    """Packed keep plane (B, H, SQ//32, SK) int32 from the canonical
    counter scheme. ``seed`` is a Python int (full 64-bit key) or a 0-d
    tensor (key_hi = 0); ``salt``/``bh_offset`` are ints or 0-d tensors."""
    if sq % 32:
        raise ValueError(f"sq={sq} must be a multiple of 32 (bit packing)")
    out = torch.empty((batch, n_heads, sq // 32, sk), dtype=torch.int32,
                      device=resolve_device(device))
    return philox_mask_into(out, rounds=rounds, heads_global=heads_global,
                            **_key_args(p, seed, salt, bh_offset))


def philox_dropout_mask_plain(batch: int, n_heads: int, sq: int, sk: int,
                              p: float, seed, salt=0, rounds: int = 7,
                              heads_global: int = 0, bh_offset=0,
                              device: DeviceLike = None) -> torch.Tensor:
    """The plain PyTorch version of ``philox_dropout_mask`` on any device:
    the same bits, computed with int64 tensor ops."""
    if sq % 32:
        raise ValueError(f"sq={sq} must be a multiple of 32 (bit packing)")
    a = _key_args(p, seed, salt, bh_offset)
    words = _plain_words(batch, n_heads, sq // 32, sk, a["key_lo"],
                         a["key_hi"], a["salt"], a["threshold"], rounds,
                         heads_global or n_heads, a["bh_offset"],
                         resolve_device(device))
    return words.reshape(batch, n_heads, sq // 32, sk)
