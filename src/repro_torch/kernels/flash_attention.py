"""Flash attention with the paper's dropout modes: the forward kernel, its
plain PyTorch version, and the differentiable ``flash_attention_mosaic``
whose forward and backward are both kernels.

    mode "none"    -- no dropout;
    mode "fused"   -- keep bits drawn inside the kernel from the canonical
                      counters with bh = b*H + h (the paper's baseline);
    mode "premask" -- keep bits read from a packed (B, H, SQ//32, SK) int32
                      plane made by a producer (the paper's technique);
    mode "replay"  -- keep bits re-derived in the kernel from the (4,)
                      seed-salt word [key_lo, key_hi, salt, bh_offset]
                      (``philox_common.seed_salt_smem``): no plane exists.

All four give the JAX package's bits: ``flash_attention_fwd`` launches a
hand-written CUDA kernel that replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel`` when its inputs
lie on a CUDA device, and the plain version when they lie on the CPU; a
failed build or launch raises. Both dtypes run one tensor-core body
(``csrc/flash_fwd_sm90.cuh``: TMA tiles, bf16 ``wgmma`` with f32 sums, P
entering P V as an exact hi + mid + lo triple of bf16 values, each
block's P V folded into O by f32 adds), each instance a library of its
own: bf16 q/k/v run ``csrc/flash_fwd_bf16.cu``, which computes the JAX
kernel's bf16 function -- f32 arithmetic on the upcast tiles -- up to the
order of the f32 sums and writes O in bf16, lse in f32; f32 q/k/v run
``csrc/flash_fwd_f32.cu``, which splits q, k and v into exact bf16
triples as well and sums the six part products of each f32 product that
reach 2^-16, the f32 function up to the order of the sums. What bounds
each on an H100 and how it tiles: see the notes in the CUDA sources. Both
take SQ and SK multiples of 64 and head_dim in {16, 32, 64, 128, 256}
(``KERNEL_HEAD_DIMS``; at 256 each library runs a kernel of its own,
counted as the instances ``flash_fwd_bf16_d256`` and ``flash_fwd_f32_d256``:
the bf16 one 128 query rows a CTA, a producer warpgroup feeding two
consumers that accumulate P V into O inside the tensor core; the f32 one
two warpgroups on 64 rows, the score products split between them by D, K
and V streamed in 32-column slices, ``csrc/flash_f32_wide.cuh``); anything
else on the card raises.

The seed-salt word is host data: the kernels take its four words by
value, so it stays on the CPU and reading it costs no device sync. The
launch is the operator ``repro_torch::flash_fwd`` (the backward's
``repro_torch::flash_dq`` and ``::flash_dkv``): a fake-tensor trace
(``analysis/dataflow.py``) records one node a launch and runs nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels import build
from repro_torch.kernels.philox_common import (
    SUPPORTED_PHILOX_ROUNDS,
    from_int32_bits,
    global_bh,
    philox4x32,
    seed_salt_words,
    threshold_from_p,
)

KERNEL = "flash_fwd"
KERNEL_BF16 = "flash_fwd_bf16"
# q/k/v dtype -> the kernel instance (the C entry point is repro_<name>)
KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}
# kernel instance -> its library (csrc/<source>.cu)
SOURCES = {KERNEL: "flash_fwd_f32", KERNEL_BF16: "flash_fwd_bf16"}

NEG_BIG = float(np.float32(-0.7 * np.finfo(np.float32).max))
# head dims each dtype's kernels take
KERNEL_HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
                    torch.bfloat16: (16, 32, 64, 128, 256)}
# the head dim whose instances count their launches apart
WIDE_HEAD_DIM = 256
KERNEL_TILE = 64
# plain versions: score elements per q-chunk
_PLAIN_CHUNK_ELEMS = 1 << 24
_MODE_CODE = {"none": 0, "premask": 1, "replay": 2, "fused": 2}

def instance(name: str, head_dim: int) -> str:
    """The launch counter of kernel ``name`` at ``head_dim``: the D = 256
    instances (kernels of their own) count apart from the narrower ones,
    as their library's name and the head dim (``flash_fwd_bf16_d256``,
    ``flash_dq_f32_d256``)."""
    if head_dim != WIDE_HEAD_DIM:
        return name
    library = name if name.endswith("_bf16") else f"{name}_f32"
    return f"{library}_d{head_dim}"


_launches = {n: 0 for dtype, name in KERNELS.items()
             for n in {instance(name, d) for d in KERNEL_HEAD_DIMS[dtype]}}
_fns = {}


def launch_counts() -> dict:
    """Launches of each instance of the forward kernel."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


# --------------------------------------------------------------------------
# operands
# --------------------------------------------------------------------------

def _check_premask(mask_packed, batch: int, n_heads: int, sq: int,
                   sk: int) -> torch.Tensor:
    """Fail fast on a mis-packed premask plane."""
    if mask_packed is None:
        raise ValueError("premask mode requires mask_packed")
    if sq % 32:
        raise ValueError(f"premask mode requires SQ % 32 == 0 (bit "
                         f"packing); got SQ={sq}")
    expect = (batch, n_heads, sq // 32, sk)
    got = tuple(mask_packed.shape)
    if got != expect or mask_packed.dtype != torch.int32:
        raise ValueError(
            f"premask mask_packed must be (B, H, SQ//32, SK) int32 = "
            f"{expect}, got shape {got} dtype {mask_packed.dtype} -- pack "
            "with philox.philox_dropout_mask / dropout_rng.packed_mask")
    return mask_packed


def _check_replay_operand(seed_salt) -> torch.Tensor:
    """The replay-mode mask slot holds the (4,) int32 seed-salt word
    [key_lo, key_hi, salt, bh_offset] on the CPU."""
    if (not isinstance(seed_salt, torch.Tensor)
            or tuple(seed_salt.shape) != (4,)
            or seed_salt.dtype != torch.int32
            or seed_salt.device.type != "cpu"):
        desc = (f"shape {tuple(seed_salt.shape)} dtype {seed_salt.dtype} "
                f"on {seed_salt.device}"
                if isinstance(seed_salt, torch.Tensor) else repr(seed_salt))
        raise ValueError(
            "replay mode takes the (4,) int32 [key_lo, key_hi, salt, "
            "bh_offset] CPU tensor (philox_common.seed_salt_smem) in the "
            f"mask_packed slot, got {desc}")
    return seed_salt


@dataclasses.dataclass(frozen=True)
class Dropout:
    """The dropout operands of one flash call, resolved: the mode, the
    plane (premask) or the counter words (replay / fused)."""
    mode: str
    plane: Optional[torch.Tensor] = None
    threshold: int = 0
    inv_keep: float = 1.0
    key_lo: int = 0
    key_hi: int = 0
    salt: int = 0
    bh_offset: int = 0
    heads_global: int = 0
    rounds: int = 7

    def kernel_args(self, n_heads: int):
        """mode code, plane pointer and key words, in the C order."""
        plane = None if self.plane is None else self.plane.data_ptr()
        return [_MODE_CODE[self.mode], plane, self.threshold,
                self.inv_keep, self.key_lo, self.key_hi, self.salt,
                self.bh_offset, self.heads_global or n_heads, self.rounds]


def resolve_dropout(mode: str, mask_packed, *, batch: int, n_heads: int,
                    sq: int, sk: int, dropout_p: float, seed, salt,
                    rounds: int, heads_global: int) -> Dropout:
    """Check a call's dropout operands as the JAX kernels do and resolve
    them into the words the kernels take."""
    if mode not in _MODE_CODE:
        raise ValueError(f"mode={mode!r}; expected one of "
                         f"{tuple(_MODE_CODE)}")
    if mode == "none" or dropout_p == 0.0:
        return Dropout("none")
    if rounds not in SUPPORTED_PHILOX_ROUNDS:
        raise ValueError(f"rounds={rounds}; expected one of "
                         f"{SUPPORTED_PHILOX_ROUNDS}")
    common = dict(threshold=threshold_from_p(dropout_p),
                  inv_keep=float(1.0 / (1.0 - dropout_p)), rounds=rounds)
    if mode == "premask":
        plane = _check_premask(mask_packed, batch, n_heads, sq, sk)
        return Dropout("premask", plane=plane, **common)
    if mode == "replay":
        if mask_packed is None:
            k0, k1, salt_w, off = seed_salt_words(seed, salt)
        else:
            # the word is a host constant of the call: read it as one, also
            # under a fake-tensor trace (analysis.dataflow)
            with _disable_current_modes():
                k0, k1, salt_w, off = from_int32_bits(
                    _check_replay_operand(mask_packed)).tolist()
        return Dropout("replay", key_lo=k0, key_hi=k1, salt=salt_w,
                       bh_offset=off, heads_global=heads_global or n_heads,
                       **common)
    k0, k1, salt_w, _ = seed_salt_words(seed, salt)
    return Dropout("fused", key_lo=k0, key_hi=k1, salt=salt_w,
                   heads_global=n_heads, **common)


def keep_rows(dp: Dropout, batch: int, n_heads: int, q0: int, cq: int,
              sk: int, device) -> torch.Tensor:
    """Bool keep mask (B, H, cq, SK) of query rows [q0, q0 + cq), as the
    kernels read (premask) or re-derive (replay / fused) it; q0 and cq
    multiples of 32 for premask, of 4 otherwise."""
    if dp.mode == "premask":
        words = dp.plane[:, :, q0 // 32:(q0 + cq) // 32]
        rep = torch.repeat_interleave(words, 32, dim=2)
        shifts = (torch.arange(cq, device=device, dtype=torch.int32)
                  % 32).reshape(1, 1, cq, 1)
        return ((rep >> shifts) & 1).to(torch.bool)
    lb = torch.arange(batch * n_heads, device=device,
                      dtype=torch.int64).reshape(-1, 1, 1)
    bh = global_bh(lb, n_heads, dp.heads_global or n_heads, dp.bh_offset)
    q4 = (q0 // 4 + torch.arange(cq // 4, device=device,
                                 dtype=torch.int64)).reshape(1, -1, 1)
    kk = torch.arange(sk, device=device, dtype=torch.int64).reshape(1, 1, -1)
    w = philox4x32(kk, q4, bh, dp.salt, dp.key_lo, dp.key_hi, dp.rounds)
    u = torch.stack([x.expand(batch * n_heads, cq // 4, sk) for x in w],
                    dim=2).reshape(batch, n_heads, cq, sk)
    return u >= dp.threshold


def replay_keep_plane(seed_salt, batch: int, n_heads: int, sq: int,
                      sk: int, dropout_p: float, rounds: int = 7,
                      heads_global: int = 0, device=None) -> torch.Tensor:
    """(B, H, SQ, SK) bool keep plane replayed from the (4,) seed-salt word:
    the plain mirror of the kernels' in-register derivation (equal to
    unpacking the premask plane)."""
    dp = resolve_dropout("replay", seed_salt, batch=batch, n_heads=n_heads,
                         sq=sq, sk=sk, dropout_p=dropout_p, seed=0, salt=0,
                         rounds=rounds, heads_global=heads_global)
    return keep_rows(dp, batch, n_heads, 0, sq, sk, device)


def q_chunk(batch: int, n_heads: int, sq: int, sk: int) -> int:
    """Query rows a plain-version step covers: a multiple of 32 dividing
    SQ (or SQ itself) with at most ``_PLAIN_CHUNK_ELEMS`` scores."""
    cq = sq
    while cq > 32 and batch * n_heads * cq * sk > _PLAIN_CHUNK_ELEMS \
            and cq % 64 == 0:
        cq //= 2
    return cq


def score_mask(q0: int, cq: int, sq: int, sk: int, causal: bool,
               local_window: int, device) -> Optional[torch.Tensor]:
    """Valid-score mask (cq, SK) of rows [q0, q0 + cq), queries at key
    positions q + SK - SQ; None when every score is valid."""
    if not causal and local_window <= 0:
        return None
    q_pos = (q0 + sk - sq + torch.arange(cq, device=device)).reshape(-1, 1)
    k_pos = torch.arange(sk, device=device).reshape(1, -1)
    valid = torch.ones((cq, sk), dtype=torch.bool, device=device)
    if causal:
        valid = k_pos <= q_pos
    if local_window > 0:
        valid = valid & (k_pos > q_pos - local_window)
    return valid


def kernel_shape_unsupported_reason(sq: int, sk: int, head_dim: int,
                                    dtype=torch.float32) -> Optional[str]:
    """Why the CUDA kernels of ``dtype`` cannot take this shape, None when
    they can."""
    dims = KERNEL_HEAD_DIMS[dtype]
    if sq % KERNEL_TILE or sk % KERNEL_TILE or head_dim not in dims:
        return (f"the {str(dtype).removeprefix('torch.')} flash kernels "
                f"take SQ, SK multiples of {KERNEL_TILE} and head_dim in "
                f"{dims}; got SQ={sq} SK={sk} D={head_dim}")
    return None


def check_kernel_shapes(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """What the CUDA kernels take; anything else on the card raises."""
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"the flash kernels take f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    reason = kernel_shape_unsupported_reason(q.shape[2], k.shape[2],
                                             q.shape[3], q.dtype)
    if reason is not None:
        raise ValueError(reason)


# --------------------------------------------------------------------------
# forward: kernel and plain version
# --------------------------------------------------------------------------

def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(SOURCES[name]), f"repro_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float]
                       + [ctypes.c_uint32] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _fwd_kernel(q, k, v, dp: Dropout, causal, local_window, scale):
    check_kernel_shapes(q, k, v)
    name = KERNELS[q.dtype]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    plane = dp.plane.contiguous() if dp.plane is not None else None
    dp = dataclasses.replace(dp, plane=plane)
    with torch.cuda.device(q.device):
        err = _kernel_fn(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), b, h, kvh,
                               sq, sk, d, float(scale), int(causal),
                               int(local_window), *dp.kernel_args(h),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _launches[instance(name, d)] += 1
    return out, lse


def _fwd_plain(q, k, v, dp: Dropout, causal, local_window, scale):
    """The plain version: per q-chunk softmax with the kernels' rules
    (l sums the undropped probabilities, l == 0 -> 1, lse = m + log l), in
    f32 on the upcast inputs; O rounded once to q's dtype."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if h != kvh:
        kf = torch.repeat_interleave(kf, h // kvh, dim=1)
        vf = torch.repeat_interleave(vf, h // kvh, dim=1)
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    cq = q_chunk(b, h, sq, sk)
    for q0 in range(0, sq, cq):
        s = torch.einsum("bhqd,bhkd->bhqk",
                         q[:, :, q0:q0 + cq].to(torch.float32), kf) * scale
        valid = score_mask(q0, cq, sq, sk, causal, local_window, q.device)
        if valid is not None:
            s = s.masked_fill(~valid, NEG_BIG)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(dim=-1, keepdim=True)
        if dp.mode != "none":
            e = e.masked_fill(~keep_rows(dp, b, h, q0, cq, sk, q.device),
                              0.0)
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0:q0 + cq] = (e @ vf) / l * dp.inv_keep
        lse[:, :, q0:q0 + cq] = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def dropout_args(dp: Dropout) -> list:
    """A resolved ``Dropout`` as an operator's arguments (the plane first,
    None when the call reads none)."""
    return [dp.plane, dp.mode, dp.threshold, dp.inv_keep, dp.key_lo,
            dp.key_hi, dp.salt, dp.bh_offset, dp.heads_global, dp.rounds]


def dropout_of(plane, mode, threshold, inv_keep, key_lo, key_hi, salt,
               bh_offset, heads_global, rounds) -> Dropout:
    """The inverse of ``dropout_args``."""
    return Dropout(mode, plane, threshold, inv_keep, key_lo, key_hi, salt,
                   bh_offset, heads_global, rounds)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  plane: Optional[torch.Tensor], mode: str, threshold: int,
                  inv_keep: float, key_lo: int, key_hi: int, salt: int,
                  bh_offset: int, heads_global: int, rounds: int,
                  causal: bool, local_window: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel as an operator of its own: the
    kernel on the card, the plain version on the CPU. A trace
    (``make_fx``) records it as one opaque node and runs neither."""
    dp = dropout_of(plane, mode, threshold, inv_keep, key_lo, key_hi, salt,
                    bh_offset, heads_global, rounds)
    if q.device.type == "cuda":
        return _fwd_kernel(q, k, v, dp, causal, local_window, scale)
    return _fwd_plain(q, k, v, dp, causal, local_window, scale)


@_flash_fwd_op.register_fake
def _(q, k, v, plane, mode, threshold, inv_keep, key_lo, key_hi, salt,
      bh_offset, heads_global, rounds, causal, local_window, scale):
    b, h, sq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq),
                                             dtype=torch.float32)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_packed=None, *, causal: bool = True,
                        local_window: int = 0, dropout_p: float = 0.0,
                        mode: str = "none", seed=0, salt=0, rounds: int = 7,
                        scale: Optional[float] = None,
                        heads_global: int = 0, return_lse: bool = False):
    """Forward flash attention; q (B,H,SQ,D), k/v (B,KV,SK,D). The
    counterpart of the JAX package's ``flash_attention_fwd`` less its
    TPU grid's ``block_q``/``block_k``: the CUDA kernel tiles by 64 x 64,
    and no tiling changes a bit. "premask" takes the (B,H,SQ//32,SK) int32
    plane, "replay" the (4,) seed-salt word (built from seed/salt when
    omitted). The launch is the operator ``repro_torch::flash_fwd``.
    Returns out, or (out, lse)."""
    batch, n_heads, sq, d = q.shape
    kv_heads, sk = k.shape[1], k.shape[2]
    if n_heads % kv_heads:
        raise ValueError(f"{n_heads} heads over {kv_heads} kv heads")
    dp = resolve_dropout(mode, mask_packed, batch=batch, n_heads=n_heads,
                         sq=sq, sk=sk, dropout_p=dropout_p, seed=seed,
                         salt=salt, rounds=rounds,
                         heads_global=heads_global)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash kernel for device {q.device}")
    out, lse = _flash_fwd_op(q, k, v, *dropout_args(dp), causal,
                             local_window, scale)
    return (out, lse) if return_lse else out


def flash_attention_fwd_plain(q, k, v, mask_packed=None, *, causal=True,
                              local_window=0, dropout_p=0.0, mode="none",
                              seed=0, salt=0, rounds=7, scale=None,
                              heads_global=0) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The plain version on any device: (out, lse)."""
    b, h, sq, d = q.shape
    dp = resolve_dropout(mode, mask_packed, batch=b, n_heads=h, sq=sq,
                         sk=k.shape[2], dropout_p=dropout_p, seed=seed,
                         salt=salt, rounds=rounds, heads_global=heads_global)
    return _fwd_plain(q, k, v, dp, causal, local_window,
                      1.0 / (d ** 0.5) if scale is None else scale)


# --------------------------------------------------------------------------
# differentiable attention: both directions are kernels
# --------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask_packed, causal, local_window, dropout_p,
                mode, seed, salt, rounds, heads_global):
        o, lse = flash_attention_fwd(
            q, k, v, mask_packed, causal=causal, local_window=local_window,
            dropout_p=dropout_p, mode=mode, seed=seed, salt=salt,
            rounds=rounds, heads_global=heads_global, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask_packed = mask_packed
        ctx.args = dict(causal=causal, local_window=local_window,
                        dropout_p=dropout_p, mode=mode, seed=seed,
                        salt=salt, rounds=rounds, heads_global=heads_global)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention_bwd import (
            flash_attention_bwd,
        )
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         ctx.mask_packed, **ctx.args)
        return (dq, dk, dv) + (None,) * 9


def flash_attention_mosaic(q, k, v, mask_packed=None, causal=True,
                           local_window=0, dropout_p=0.0, mode="none",
                           seed=0, salt=0, rounds=7,
                           heads_global=0) -> torch.Tensor:
    """Differentiable flash attention whose forward
    (``csrc/flash_fwd_f32.cu``, at bf16 ``csrc/flash_fwd_bf16.cu``) and
    backward (``csrc/flash_dq_f32.cu`` and ``csrc/flash_dkv_f32.cu``; at
    bf16 ``csrc/flash_dq_bf16.cu`` and ``csrc/flash_dkv_bf16.cu``) are
    kernels on the card -- the port of the JAX package's
    ``flash_attention_mosaic`` (flash_attention.py:388-433), with the same
    positional arguments less the TPU grid's ``block_q``/``block_k`` and
    ``interpret``. Nothing O(SQ*SK) reaches device memory except a premask
    plane; in "replay" mode not even that."""
    return _FlashAttention.apply(q, k, v, mask_packed, causal, local_window,
                                 dropout_p, mode, seed, salt, rounds,
                                 heads_global)
