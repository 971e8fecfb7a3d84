"""Flash-attention backward: the dq and dkv kernels and their plain
PyTorch version.

With keep mask K and P = softmax(S) recomputed from the forward's lse,
O = (K o P / (1-p)) V gives

    dV = (K o P / (1-p))^T dO,   dP = K / (1-p) o (dO V^T),
    dS = P o (dP - Delta),       Delta = rowsum(dO o O),

and dq = dS K * scale, dk = dS^T Q * scale. Delta and the GQA group sum of
the per-query-head dk / dv stay in torch, as in the JAX package.

``flash_attention_bwd`` launches the hand-written CUDA kernels of
``csrc/flash_bwd.cu`` -- ``repro_flash_dq`` replaces the TPU kernel
``src/repro/kernels/flash_attention_bwd.py::_dq_kernel`` and
``repro_flash_dkv`` replaces ``::_dkv_kernel`` -- when its inputs lie on a
CUDA device, and the plain version when they lie on the CPU; a failed
build or launch raises. Neither kernel uses atomics, so a step is bitwise
reproducible; what bounds them (f32 operations) is in the CUDA source.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    NEG_BIG,
    Dropout,
    check_kernel_shapes,
    keep_rows,
    q_chunk,
    resolve_dropout,
    score_mask,
)

SOURCE = "flash_bwd"
KERNEL_DQ = "flash_dq"
KERNEL_DKV = "flash_dkv"

_launches = {KERNEL_DQ: 0, KERNEL_DKV: 0}
_fns = {}


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_count() -> None:
    for key in _launches:
        _launches[key] = 0


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(SOURCE), f"repro_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float]
                       + [ctypes.c_uint32] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _bwd_kernel(name, q, k, v, do, lse, delta, out_a, out_b, dp: Dropout,
                causal, local_window, scale):
    """One launch of ``name`` (dq writes out_a; dkv writes out_a = dk_h and
    out_b = dv_h)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    ptrs = [q, k, v, do, lse, delta]
    outs = ([out_a, None, None] if name == KERNEL_DQ
            else [None, out_a, out_b])
    with torch.cuda.device(q.device):
        err = _kernel_fn(name)(
            *[t.data_ptr() for t in ptrs],
            *[None if t is None else t.data_ptr() for t in outs],
            b, h, kvh, sq, sk, d, float(scale), int(causal),
            int(local_window), *dp.kernel_args(h),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _launches[name] += 1


def _bwd_plain(q, k, v, do, lse, delta, dp: Dropout, causal, local_window,
               scale):
    """Per-query-head (dq, dk_h, dv_h) in plain tensor ops, per q-chunk."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    kf, vf = k, v
    if h != kvh:
        kf = torch.repeat_interleave(k, h // kvh, dim=1)
        vf = torch.repeat_interleave(v, h // kvh, dim=1)
    dq = torch.empty_like(q)
    dk_h = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv_h = torch.zeros_like(dk_h)
    cq = q_chunk(b, h, sq, sk)
    for q0 in range(0, sq, cq):
        rows = slice(q0, q0 + cq)
        qc, doc = q[:, :, rows], do[:, :, rows]
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
        dq[:, :, rows] = (ds @ kf) * scale
        dk_h += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
        dv_h += torch.einsum("bhqk,bhqd->bhkd", p_drop, doc)
    return dq, dk_h, dv_h


def flash_attention_bwd(q, k, v, o, lse, do,
                        mask_packed: Optional[torch.Tensor] = None, *,
                        causal=True, local_window=0, dropout_p=0.0,
                        mode="none", seed=0, salt=0, rounds=7, scale=None,
                        heads_global=0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the counterpart of the JAX package's
    ``flash_attention_bwd``. dk / dv are computed per query head by the
    dkv kernel and group-summed here for GQA. In "replay" mode
    ``mask_packed`` carries the (4,) seed-salt word and both kernels
    re-derive the forward's keep bits; no plane is read."""
    batch, n_heads, sq, d = q.shape
    kv_heads, sk = k.shape[1], k.shape[2]
    group = n_heads // kv_heads
    dp = resolve_dropout(mode, mask_packed, batch=batch, n_heads=n_heads,
                         sq=sq, sk=sk, dropout_p=dropout_p, seed=seed,
                         salt=salt, rounds=rounds,
                         heads_global=heads_global)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    if q.device.type == "cuda":
        check_kernel_shapes(q, k, v)
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
        lse, delta = lse.contiguous(), delta.contiguous()
        if dp.plane is not None:
            dp = dataclasses.replace(dp, plane=dp.plane.contiguous())
        dq = torch.empty_like(q)
        dk_h = torch.empty((batch, n_heads, sk, d), dtype=torch.float32,
                           device=q.device)
        dv_h = torch.empty_like(dk_h)
        args = (dp, causal, local_window, scale)
        _bwd_kernel(KERNEL_DQ, q, k, v, do, lse, delta, dq, None, *args)
        _bwd_kernel(KERNEL_DKV, q, k, v, do, lse, delta, dk_h, dv_h, *args)
    elif q.device.type == "cpu":
        dq, dk_h, dv_h = _bwd_plain(q, k, v, do, lse, delta, dp, causal,
                                    local_window, scale)
    else:
        raise ValueError(f"no flash kernel for device {q.device}")
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
    """The plain version on any device: per-query-head (dq, dk_h, dv_h)."""
    b, h, sq, d = q.shape
    dp = resolve_dropout(mode, mask_packed, batch=b, n_heads=h, sq=sq,
                         sk=k.shape[2], dropout_p=dropout_p, seed=seed,
                         salt=salt, rounds=rounds, heads_global=heads_global)
    delta = torch.sum(do * o, dim=-1)
    return _bwd_plain(q, k, v, do, lse, delta, dp, causal, local_window,
                      1.0 / (d ** 0.5) if scale is None else scale)
