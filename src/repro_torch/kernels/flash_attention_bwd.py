"""Flash-attention backward: the dq and dkv kernels and their plain
PyTorch version.

With keep mask K and P = softmax(S) recomputed from the forward's lse,
O = (K o P / (1-p)) V gives

    dV = (K o P / (1-p))^T dO,   dP = K / (1-p) o (dO V^T),
    dS = P o (dP - Delta),       Delta = rowsum(dO o O),

and dq = dS K * scale, dk = dS^T Q * scale. Delta and the GQA group sum of
the per-query-head dk / dv stay in torch, as in the JAX package. At bf16
q/k/v/dO every product and sum is f32 on the upcast values, and dq and the
per-head dk / dv are rounded once to bf16, as the JAX kernels write them
(``out_dtype``); the group sum then adds those bf16 values.

``flash_attention_bwd`` launches hand-written CUDA kernels -- the dq kernel
replaces the TPU kernel ``src/repro/kernels/flash_attention_bwd.py::
_dq_kernel`` and the dkv kernel ``::_dkv_kernel`` -- when its inputs lie on
a CUDA device, and the plain version when they lie on the CPU; a failed
build or launch raises. All four are tensor-core kernels on Hopper
(``wgmma``, ``csrc/flash_sm90.cuh``): the f32 dq and dkv are
``csrc/flash_dq_f32.cu`` and ``csrc/flash_dkv_f32.cu``, every product's
two f32 operands split into exact hi + mid + lo triples of bf16 values and
the six part products that reach 2^-16 summed in f32; the bf16 dq and dkv
are ``csrc/flash_dq_bf16.cu`` and ``csrc/flash_dkv_bf16.cu``, where only
dS and P_drop are f32 and enter as triples. At head_dim 256 each library
runs a kernel of its own, counted apart as ``flash_dq_bf16_d256`` /
``flash_dkv_bf16_d256`` and ``flash_dq_f32_d256`` / ``flash_dkv_f32_d256``:
the bf16 dq takes 128 query rows a CTA, a producer warpgroup feeding two
consumers of 64 rows each; the bf16 dkv 64 keys a CTA, a producer and two
consumers that split the score products by queries and each hold one
column half of dk and dv; the f32 ones run two warpgroups a CTA, each
holding one column half of the output, and stream the walked tiles in
32-column slices (``csrc/flash_f32_wide.cuh``; the f32 dq takes them
already split, from K's and V's bf16 triples that the same launch writes
into a workspace on the card, ``_dq_workspace``). No
kernel uses atomics, so a step is bitwise reproducible; what bounds each
is in its CUDA source.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    KERNEL_HEAD_DIMS,
    NEG_BIG,
    WIDE_HEAD_DIM,
    Dropout,
    check_kernel_shapes,
    dropout_args,
    dropout_of,
    instance,
    keep_rows,
    q_chunk,
    resolve_dropout,
    score_mask,
)

KERNEL_DQ = "flash_dq"
KERNEL_DKV = "flash_dkv"
KERNEL_DQ_BF16 = "flash_dq_bf16"
KERNEL_DKV_BF16 = "flash_dkv_bf16"
# q/k/v dtype -> (dq kernel, dkv kernel); the C entry point is repro_<name>
KERNELS = {torch.float32: (KERNEL_DQ, KERNEL_DKV),
           torch.bfloat16: (KERNEL_DQ_BF16, KERNEL_DKV_BF16)}
# kernel instance -> its library (csrc/<source>.cu)
SOURCES = {KERNEL_DQ: "flash_dq_f32", KERNEL_DKV: "flash_dkv_f32",
           KERNEL_DQ_BF16: "flash_dq_bf16", KERNEL_DKV_BF16: "flash_dkv_bf16"}

_launches = {n: 0 for dtype, pair in KERNELS.items() for name in pair
             for n in {instance(name, d) for d in KERNEL_HEAD_DIMS[dtype]}}
_fns = {}


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_count() -> None:
    for key in _launches:
        _launches[key] = 0


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(SOURCES[name]), f"repro_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float]
                       + [ctypes.c_uint32] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _dq_workspace(name, b, kvh, sk, d, device) -> Optional[torch.Tensor]:
    """The scratch the dq kernel ``name`` takes on the card, or None: the
    f32 one at head_dim 256 writes K's and V's bf16 triples there (hi,
    mid, lo of each value, 1.5x their f32 bytes, laid out by ``dq_ws_part``
    of ``csrc/flash_wide_map.cuh``)."""
    if name != KERNEL_DQ or d != WIDE_HEAD_DIM:
        return None
    return torch.empty(2 * 3 * b * kvh * sk * d * 2, dtype=torch.uint8,
                       device=device)


def _bwd_kernel(name, q, k, v, do, lse, delta, out_a, out_b, dp: Dropout,
                causal, local_window, scale):
    """One launch of ``name`` (dq writes out_a, with its workspace in dk's
    place; dkv writes out_a = dk_h and out_b = dv_h)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    ptrs = [q, k, v, do, lse, delta]
    outs = ([out_a, _dq_workspace(name, b, kvh, sk, d, q.device), None]
            if out_b is None else [None, out_a, out_b])
    with torch.cuda.device(q.device):
        err = _kernel_fn(name)(
            *[t.data_ptr() for t in ptrs],
            *[None if t is None else t.data_ptr() for t in outs],
            b, h, kvh, sq, sk, d, float(scale), int(causal),
            int(local_window), *dp.kernel_args(h),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _launches[instance(name, d)] += 1


def _bwd_plain(q, k, v, do, lse, delta, dp: Dropout, causal, local_window,
               scale, part: str = "all"):
    """Per-query-head (dq, dk_h, dv_h) in plain tensor ops, per q-chunk, in
    f32 on the upcast inputs; each rounded once to q's dtype. ``part``
    "dq" or "dkv" computes only what the one kernel writes (the other
    outputs None); the same arithmetic either way."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    want_dq, want_dkv = part in ("all", "dq"), part in ("all", "dkv")
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if h != kvh:
        kf = torch.repeat_interleave(kf, h // kvh, dim=1)
        vf = torch.repeat_interleave(vf, h // kvh, dim=1)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk_h = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv_h = torch.zeros_like(dk_h)
    cq = q_chunk(b, h, sq, sk)
    for q0 in range(0, sq, cq):
        rows = slice(q0, q0 + cq)
        qc = q[:, :, rows].to(torch.float32)
        doc = do[:, :, rows].to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        valid = score_mask(q0, cq, sq, sk, causal, local_window, q.device)
        if valid is not None:
            s = s.masked_fill(~valid, NEG_BIG)
        p = torch.exp(s - lse[:, :, rows, None])
        dpr = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        p_drop = p
        if dp.mode != "none":
            keep = keep_rows(dp, b, h, q0, cq, sk, q.device)
            dpr = torch.where(keep, dpr * dp.inv_keep, 0.0)
            p_drop = torch.where(keep, p * dp.inv_keep, 0.0)
        ds = p * (dpr - delta[:, :, rows, None])
        if want_dq:
            dq[:, :, rows] = (ds @ kf) * scale
        if want_dkv:
            dk_h += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
            dv_h += torch.einsum("bhqk,bhqd->bhkd", p_drop, doc)
    return (dq.to(q.dtype) if want_dq else None,
            dk_h.to(q.dtype) if want_dkv else None,
            dv_h.to(q.dtype) if want_dkv else None)


def _bwd_launch(name, q, k, v, do, lse, delta, dp: Dropout, causal,
                local_window, scale):
    """One launch of the dq (``name`` its instance) or dkv kernel on the
    card: dq, or (dk_h, dv_h)."""
    check_kernel_shapes(q, k, v)
    if do.dtype != q.dtype:
        raise NotImplementedError(f"the flash kernels take dO in q's "
                                  f"dtype {q.dtype}, got {do.dtype}")
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    if dp.plane is not None:
        dp = dataclasses.replace(dp, plane=dp.plane.contiguous())
    args = (dp, causal, local_window, scale)
    if name in (KERNEL_DQ, KERNEL_DQ_BF16):
        dq = torch.empty_like(q)
        _bwd_kernel(name, q, k, v, do, lse, delta, dq, None, *args)
        return dq
    b, h, _, d = q.shape
    dk_h = torch.empty((b, h, k.shape[2], d), dtype=q.dtype,
                       device=q.device)
    dv_h = torch.empty_like(dk_h)
    _bwd_kernel(name, q, k, v, do, lse, delta, dk_h, dv_h, *args)
    return dk_h, dv_h


@torch.library.custom_op("repro_torch::flash_dq", mutates_args=())
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 plane: Optional[torch.Tensor], mode: str, threshold: int,
                 inv_keep: float, key_lo: int, key_hi: int, salt: int,
                 bh_offset: int, heads_global: int, rounds: int,
                 causal: bool, local_window: int, scale: float
                 ) -> torch.Tensor:
    """One launch of the dq kernel as an operator of its own: the kernel
    on the card, the plain version's dq on the CPU. A trace records it as
    one opaque node and runs neither."""
    dp = dropout_of(plane, mode, threshold, inv_keep, key_lo, key_hi, salt,
                    bh_offset, heads_global, rounds)
    if q.device.type == "cuda":
        return _bwd_launch(KERNELS[q.dtype][0], q, k, v, do, lse, delta, dp,
                           causal, local_window, scale)
    return _bwd_plain(q, k, v, do, lse, delta, dp, causal, local_window,
                      scale, part="dq")[0]


@_flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, plane, mode, threshold, inv_keep, key_lo,
      key_hi, salt, bh_offset, heads_global, rounds, causal, local_window,
      scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_dkv", mutates_args=())
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  plane: Optional[torch.Tensor], mode: str, threshold: int,
                  inv_keep: float, key_lo: int, key_hi: int, salt: int,
                  bh_offset: int, heads_global: int, rounds: int,
                  causal: bool, local_window: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dkv kernel as an operator of its own: (dk_h,
    dv_h) per query head, the kernel on the card, the plain version's on
    the CPU. A trace records it as one opaque node and runs neither."""
    dp = dropout_of(plane, mode, threshold, inv_keep, key_lo, key_hi, salt,
                    bh_offset, heads_global, rounds)
    if q.device.type == "cuda":
        return _bwd_launch(KERNELS[q.dtype][1], q, k, v, do, lse, delta, dp,
                           causal, local_window, scale)
    return _bwd_plain(q, k, v, do, lse, delta, dp, causal, local_window,
                      scale, part="dkv")[1:]


@_flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, plane, mode, threshold, inv_keep, key_lo,
      key_hi, salt, bh_offset, heads_global, rounds, causal, local_window,
      scale):
    b, h, _, d = q.shape
    shape = (b, h, k.shape[2], d)
    return q.new_empty(shape), q.new_empty(shape)


def flash_attention_bwd_heads(q, k, v, o, lse, do,
                              mask_packed: Optional[torch.Tensor] = None, *,
                              causal=True, local_window=0, dropout_p=0.0,
                              mode="none", seed=0, salt=0, rounds=7,
                              scale=None, heads_global=0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk_h, dv_h) in q's dtype, dk / dv per query head (B, H, SK, D)
    as the dkv kernel writes them, before the GQA group sum: the kernels on
    a CUDA device, the plain version on the CPU (the operators
    ``repro_torch::flash_dq`` and ``repro_torch::flash_dkv``)."""
    batch, n_heads, sq, d = q.shape
    sk = k.shape[2]
    dp = resolve_dropout(mode, mask_packed, batch=batch, n_heads=n_heads,
                         sq=sq, sk=sk, dropout_p=dropout_p, seed=seed,
                         salt=salt, rounds=rounds,
                         heads_global=heads_global)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash kernel for device {q.device}")
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    args = (*dropout_args(dp), causal, local_window, scale)
    dq = _flash_dq_op(q, k, v, do, lse, delta, *args)
    dk_h, dv_h = _flash_dkv_op(q, k, v, do, lse, delta, *args)
    return dq, dk_h, dv_h


def flash_attention_bwd(q, k, v, o, lse, do,
                        mask_packed: Optional[torch.Tensor] = None, *,
                        causal=True, local_window=0, dropout_p=0.0,
                        mode="none", seed=0, salt=0, rounds=7, scale=None,
                        heads_global=0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the counterpart of the JAX package's
    ``flash_attention_bwd``. dk / dv are computed per query head by the
    dkv kernel (in q's dtype, ``flash_attention_bwd_heads``) and
    group-summed here for GQA. In "replay" mode ``mask_packed`` carries the
    (4,) seed-salt word and both kernels re-derive the forward's keep bits;
    no plane is read."""
    batch, n_heads, _, d = q.shape
    kv_heads, sk = k.shape[1], k.shape[2]
    group = n_heads // kv_heads
    dq, dk_h, dv_h = flash_attention_bwd_heads(
        q, k, v, o, lse, do, mask_packed, causal=causal,
        local_window=local_window, dropout_p=dropout_p, mode=mode, seed=seed,
        salt=salt, rounds=rounds, scale=scale, heads_global=heads_global)
    if group > 1:
        dk = dk_h.reshape(batch, kv_heads, group, sk, d).sum(dim=2)
        dv = dv_h.reshape(batch, kv_heads, group, sk, d).sum(dim=2)
    else:
        dk, dv = dk_h, dv_h
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, mask_packed=None, *,
                              causal=True, local_window=0, dropout_p=0.0,
                              mode="none", seed=0, salt=0, rounds=7,
                              scale=None, heads_global=0):
    """The plain version on any device: per-query-head (dq, dk_h, dv_h) in
    q's dtype."""
    b, h, sq, d = q.shape
    dp = resolve_dropout(mode, mask_packed, batch=b, n_heads=h, sq=sq,
                         sk=k.shape[2], dropout_p=dropout_p, seed=seed,
                         salt=salt, rounds=rounds, heads_global=heads_global)
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    return _bwd_plain(q, k, v, do, lse, delta, dp, causal, local_window,
                      1.0 / (d ** 0.5) if scale is None else scale)
