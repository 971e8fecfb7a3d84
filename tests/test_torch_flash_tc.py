"""The arithmetic of the tensor-core flash kernels, on the CPU.

``csrc/flash_fwd_bf16.cu``, ``csrc/flash_dq_bf16.cu`` and
``csrc/flash_dkv_bf16.cu`` run only on the card. What they compute is
emulated here in torch: scores from products of bf16 values (exact in f32)
with f32 sums, then the f32 operands of the second products -- P in the
forward, dS in dq, P_drop and dS in dkv -- split into the exact triple
hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each part
multiplied by the bf16 tile and summed in f32, each block's product folded
into the output by an f32 add, then each output rounded once to bf16. The
emulation is held against the JAX package's bf16 ``flash_attention_fwd``
/ ``flash_attention_bwd`` (Pallas interpret mode) and against the port's
plain versions at the limit the card's check uses, 1e-2 x (|x| + rms(x))
(lse at 1e-4 x (1 + |x|)), in replay, premask and none, MHA and GQA 2:1,
at head_dim 64, 32 and 16. A second test records why the kernels split as
they do: against JAX's function the triple is exact up to the order of
f32 sums, the pair hi + lo (16 bits) reads further and P rounded once to
bf16 (FlashAttention-3's choice) much further, in f32 and in the bf16
outputs. A third pins the wrappers: the bf16 entry names and launch
counters, the library each instance loads, the head dims the kernels
take, and both forwards on one tensor-core body.

The f32 kernels (the forward ``csrc/flash_fwd_f32.cu``, dq
``csrc/flash_dq_f32.cu``, dkv ``csrc/flash_dkv_f32.cu``) split both f32
operands of every product -- Q, K, V, dO as well as P, dS and P_drop --
into exact triples and sum the six part products that reach 2^-16
(lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi) in f32. That is emulated
on f32 inputs and held against JAX's f32 ``flash_attention_fwd`` and
``flash_attention_bwd`` (Pallas interpret mode) and the plain versions at
1e-4 x (1 + |x|), in replay, premask and none, MHA and GQA 2:1, at
head_dim 16, 32 and 64; tests pin why: the triple is exact, and the six
products are the f32 product to 2^-22 of sum |a||b| where a triple on one
side alone (the other rounded once to bf16) is at least 100x further off;
the forward on K and V rounded once to bf16 at least 10x.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_tc.py
"""
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import philox_common as jpc
from repro.kernels.ref import philox_mask_ref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels import flash_attention_bwd as tb
from repro_torch.kernels import launch_counts
from repro_torch.kernels import philox_common as tpc

jf = importlib.import_module("repro.kernels.flash_attention")
jfb = importlib.import_module("repro.kernels.flash_attention_bwd")

BF16 = torch.bfloat16
# chip_smoke.py's limits of the bf16 flash kernels against their plain
# versions: outputs tol x (|want| + rms(want)), lse tol x (1 + |want|)
BF16_FLASH_TOL = 1e-2
FWD_TOL = 1e-4
TILE = 64  # the kernels' key block
ARGS = dict(causal=True, dropout_p=0.1, seed=9, salt=3)


def _bf16_np(rng, shape) -> np.ndarray:
    """Standard normal values that are bf16 numbers, as f32."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _ratio(got, want, tol, scaled=True) -> float:
    """max |got - want| / limit: tol x (|want| + rms(want)), or with
    ``scaled`` False tol x (1 + |want|)."""
    got = torch.as_tensor(np.array(got, np.float32))
    want = torch.as_tensor(np.array(want, np.float32))
    floor = want.square().mean().sqrt() if scaled else 1.0
    return float(((got - want).abs() / (tol * (want.abs() + floor))).max())


def _split(x: torch.Tensor, parts: int):
    """x as ``parts`` bf16 values, each bf16(x - the ones before): three
    (the kernels) are exact, two (hi + lo) keep 16 bits, one rounds once."""
    out, rest = [], x
    for _ in range(parts):
        out.append(rest.to(BF16).float())
        rest = rest - out[-1]
    return out


def _times(p: torch.Tensor, b: torch.Tensor, parts: int = 3,
           both: bool = False) -> torch.Tensor:
    """p @ b with p an f32 operand and b bf16 values: p split into
    ``parts`` bf16 values, each product summed in f32. With ``both`` b is
    f32 too and both are split into triples: the six part products that
    reach 2^-16, smallest first, summed in f32 (the f32 kernels)."""
    if not both:
        return sum(x @ b for x in _split(p, parts))
    ah, am, al = _split(p, 3)
    bh, bm, bl = _split(b, 3)
    out = al @ bh
    for x, y in ((am, bm), (ah, bl), (am, bh), (ah, bm), (ah, bh)):
        out = out + x @ y
    return out


def _dropout(mode, mask, b, h, s):
    return tf.resolve_dropout(mode, mask, batch=b, n_heads=h, sq=s, sk=s,
                              dropout_p=ARGS["dropout_p"], seed=ARGS["seed"],
                              salt=ARGS["salt"], rounds=7, heads_global=0)


def emulate_fwd(q, k, v, dp, scale, parts=3, both=False):
    """The forward kernel's arithmetic: (O in f32 before its rounding, lse).
    Online softmax over 64-key blocks with flash_fwd_sm90.cuh's rules; with
    ``both`` (the f32 instance) Q K^T and P V have both operands split into
    triples, six part products each, smallest first."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf = q.float()
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    keep = (tf.keep_rows(dp, b, h, 0, s, s, "cpu") if dp.mode != "none"
            else torch.ones((b, h, s, s), dtype=torch.bool))
    valid = tf.score_mask(0, s, s, s, True, 0, "cpu")
    m = torch.full((b, h, s, 1), tf.NEG_BIG)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, d))
    for k0 in range(0, s, TILE):
        cols = slice(k0, k0 + TILE)
        kt = kf[:, :, cols].transpose(-1, -2)
        sc = (_times(qf, kt, both=True) if both else qf @ kt) * scale
        sc = sc.masked_fill(~valid[:, cols], tf.NEG_BIG)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sc - m_new)
        l = alpha * l + e.sum(-1, keepdim=True)
        p = torch.where(keep[..., cols], e, 0.0)
        o = o * alpha + _times(p, vf[:, :, cols], parts, both)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return o / l * dp.inv_keep, (m + torch.log(l))[..., 0]


def _bwd_scores(q, k, v, do, o, lse, dp, scale, both=False):
    """The backward kernels' f32 tiles, per query head: (q, dO, k, v) as
    f32, P_drop and dS * scale, from scores of bf16 products with f32
    sums (with ``both``, of f32 operands split on both sides)."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    mm = ((lambda x, y: _times(x, y, both=True)) if both
          else (lambda x, y: x @ y))
    sc = mm(qf, kf.transpose(-1, -2)) * scale
    sc = sc.masked_fill(~tf.score_mask(0, s, s, s, True, 0, "cpu"),
                        tf.NEG_BIG)
    p = torch.exp(sc - lse[..., None])
    dpr = mm(dof, vf.transpose(-1, -2))
    pd = p
    if dp.mode != "none":
        keep = tf.keep_rows(dp, b, h, 0, s, s, "cpu")
        dpr = torch.where(keep, dpr * dp.inv_keep, 0.0)
        pd = torch.where(keep, p * dp.inv_keep, 0.0)
    return qf, dof, kf, vf, pd, p * (dpr - delta) * scale


def emulate_dq(q, k, v, do, o, lse, dp, scale, parts=3, both=False):
    """The dq kernel's arithmetic: dq in f32 before its rounding, each
    64-key block's dS K (dS * scale in ``parts`` bf16 values, the products
    summed in f32; with ``both``, K split too) folded in by an f32 add.
    Tiles that hold no valid score add zeros, so every block is taken."""
    qf, _, kf, _, _, ds = _bwd_scores(q, k, v, do, o, lse, dp, scale, both)
    dq = torch.zeros_like(qf)
    for k0 in range(0, q.shape[2], TILE):
        cols = slice(k0, k0 + TILE)
        dq = dq + _times(ds[..., cols], kf[:, :, cols], parts, both)
    return dq


def emulate_dkv(q, k, v, do, o, lse, dp, scale, parts=3, both=False):
    """The dkv kernel's arithmetic: per-query-head (dk, dv) in f32 before
    their rounding, each 64-query block's products folded in by f32 adds
    (with ``both``, dO and Q split too). Tiles that hold no valid score
    add zeros, so every block is taken."""
    s = q.shape[2]
    qf, dof, kf, vf, pd, ds = _bwd_scores(q, k, v, do, o, lse, dp, scale,
                                          both)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, s, TILE):
        rows = slice(q0, q0 + TILE)
        dv = dv + _times(pd[:, :, rows].transpose(-1, -2), dof[:, :, rows],
                         parts, both)
        dk = dk + _times(ds[:, :, rows].transpose(-1, -2), qf[:, :, rows],
                         parts, both)
    return dk, dv


def _group_sum(x_h: torch.Tensor, kv: int) -> torch.Tensor:
    """The wrapper's GQA sum of per-query-head bf16 values."""
    b, h, s, d = x_h.shape
    return x_h.reshape(b, kv, h // kv, s, d).sum(dim=2)


def _case(mode, kv, d, seed):
    b, h, s = 2, 4, 128
    rng = np.random.default_rng(seed)
    q, do = _bf16_np(rng, (b, h, s, d)), _bf16_np(rng, (b, h, s, d))
    k, v = _bf16_np(rng, (b, kv, s, d)), _bf16_np(rng, (b, kv, s, d))
    jplane = philox_mask_ref(b, h, s, s, ARGS["dropout_p"], ARGS["seed"],
                             salt=ARGS["salt"])
    jop = {"premask": jplane,
           "replay": jpc.seed_salt_smem(ARGS["seed"], ARGS["salt"])}.get(mode)
    top = {"premask": torch.from_numpy(np.array(jplane).view(np.int32)),
           "replay": tpc.seed_salt_smem(ARGS["seed"], ARGS["salt"])}.get(mode)
    return (b, h, s), (q, k, v, do), jop, top


@pytest.mark.parametrize("mode,kv,d", [
    ("replay", 4, 32), ("premask", 4, 32), ("replay", 2, 32),
    ("premask", 2, 32), ("none", 4, 32), ("replay", 4, 16),
    ("premask", 4, 16), ("replay", 2, 64)])
def test_tc_emulation_matches_jax_and_plain(mode, kv, d):
    """The kernels' arithmetic (hi + mid + lo) against JAX's bf16 kernels
    and the port's plain versions: O, dq, dk, dv within 1e-2 x (|x| +
    rms(x)), lse within 1e-4 x (1 + |x|)."""
    (b, h, s), arrays, jop, top = _case(mode, kv, d, 10 * kv + d + len(mode))
    q, k, v, do = (torch.from_numpy(x).to(BF16) for x in arrays)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    args = dict(ARGS, mode=mode)
    scale = 1.0 / d ** 0.5
    dp = _dropout(mode, top, b, h, s)

    jo, jl = jf.flash_attention_fwd(jq, jk, jv, jop, return_lse=True, **args)
    o32, lse = emulate_fwd(q, k, v, dp, scale)
    o = o32.to(BF16)
    po, plse = tf.flash_attention_fwd_plain(q, k, v, top, **args)
    assert _ratio(o.float(), np.asarray(jo, np.float32), BF16_FLASH_TOL) <= 1
    assert _ratio(o.float(), po.float(), BF16_FLASH_TOL) <= 1
    assert _ratio(lse, np.asarray(jl), FWD_TOL, scaled=False) <= 1
    assert _ratio(lse, plse, FWD_TOL, scaled=False) <= 1

    # dq and dkv on JAX's forward outputs, as the backward receives them
    jo_t = torch.from_numpy(np.array(jo, np.float32)).to(BF16)
    jl_t = torch.from_numpy(np.array(jl, np.float32))
    jdq, jdk, jdv = jfb.flash_attention_bwd(jq, jk, jv, jo, jl, jdo, jop,
                                            **args)
    dq = emulate_dq(q, k, v, do, jo_t, jl_t, dp, scale).to(BF16)
    dk_h, dv_h = emulate_dkv(q, k, v, do, jo_t, jl_t, dp, scale)
    dk, dv = (_group_sum(x.to(BF16), kv) for x in (dk_h, dv_h))
    pdq, pdk_h, pdv_h = tb.flash_attention_bwd_plain(q, k, v, jo_t, jl_t,
                                                     do, top, **args)
    pdk, pdv = (_group_sum(x, kv) for x in (pdk_h, pdv_h))
    for got, want, pwant in ((dq, jdq, pdq), (dk, jdk, pdk), (dv, jdv, pdv)):
        assert got.dtype == BF16
        assert _ratio(got.float(), np.asarray(want, np.float32),
                      BF16_FLASH_TOL) <= 1
        assert _ratio(got.float(), pwant.float(), BF16_FLASH_TOL) <= 1


def test_tc_triple_is_jax_function_pair_and_single_rounding_are_not():
    """Why the kernels split P, P_drop and dS into three bf16 parts:
    against JAX's f32 kernels on the same (bf16) values -- the function the
    bf16 kernels compute before their one rounding -- the triple is within
    2^-18 of each output's scale (measured 4e-7 to 1.7e-6: the order of f32
    sums; dq 1.0e-6), the pair hi + lo at least 4x further (1e-5 to 3e-5;
    dq 1.9e-5) and the operand rounded once at least 100x further (4e-3 to
    2e-2; dq 1.2e-2); and the bf16 O of each differs from JAX's bf16
    kernel in more of its 32,768 elements, pair than triple, once than
    pair (measured 3, 57 and 11,386). The pair's extra flips in O move
    Delta = rowsum(dO o O) and with it dq past the card's limit against
    the plain versions."""
    (b, h, s), arrays, jop, top = _case("replay", 4, 32, 5)
    d = arrays[0].shape[-1]
    q, k, v, do = (torch.from_numpy(x).to(BF16) for x in arrays)
    j32 = [jnp.asarray(x, jnp.float32) for x in arrays]
    j16 = [jnp.asarray(x, jnp.bfloat16) for x in arrays]
    args = dict(ARGS, mode="replay")
    scale = 1.0 / d ** 0.5
    dp = _dropout("replay", top, b, h, s)

    jo32, jl32 = jf.flash_attention_fwd(*j32[:3], jop, return_lse=True,
                                        **args)
    jo16 = torch.from_numpy(np.array(
        jf.flash_attention_fwd(*j16[:3], jop, **args), np.float32))
    o_t = torch.from_numpy(np.array(jo32, np.float32)).to(BF16)
    l_t = torch.from_numpy(np.array(jl32, np.float32))
    jdq32, jdk32, jdv32 = jfb.flash_attention_bwd(
        *j32[:3], jnp.asarray(o_t.float().numpy()), jl32, j32[3], jop, **args)
    err = {}
    for parts in (3, 2, 1):
        o32, _ = emulate_fwd(q, k, v, dp, scale, parts)
        dq32 = emulate_dq(q, k, v, do, o_t, l_t, dp, scale, parts)
        dk32, dv32 = emulate_dkv(q, k, v, do, o_t, l_t, dp, scale, parts)
        err[parts] = dict(
            o=_ratio(o32, np.asarray(jo32), 1.0),
            dq=_ratio(dq32, np.asarray(jdq32), 1.0),
            dk=_ratio(dk32, np.asarray(jdk32), 1.0),
            dv=_ratio(dv32, np.asarray(jdv32), 1.0),
            flips=int((o32.to(BF16).float() != jo16).sum()))
    for key in ("o", "dq", "dk", "dv"):
        assert err[3][key] <= 2.0 ** -18, (key, err)
        assert err[2][key] >= 4 * err[3][key], (key, err)
        assert err[1][key] >= 100 * err[3][key], (key, err)
    assert err[3]["flips"] < err[2]["flips"] < err[1]["flips"], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_wrappers_route_by_dtype(dtype, monkeypatch):
    """Entry names, launch counters and libraries: bf16 q/k/v launch
    repro_flash_fwd_bf16 (flash_fwd_bf16.cu), repro_flash_dq_bf16
    (flash_dq_bf16.cu) and repro_flash_dkv_bf16 (flash_dkv_bf16.cu), f32
    q/k/v repro_flash_fwd (flash_fwd_f32.cu), repro_flash_dq
    (flash_dq_f32.cu) and repro_flash_dkv (flash_dkv_f32.cu) -- every
    flash kernel on the tensor cores, the two forwards instances of one
    body (flash_fwd_sm90.cuh) and the SIMT forward gone; the kernels take
    head dims 16, 32, 64 and 128."""
    bf16 = dtype == BF16
    fwd = tf.KERNELS[dtype]
    dq, dkv = tb.KERNELS[dtype]
    assert (fwd, dq, dkv) == (("flash_fwd_bf16", "flash_dq_bf16",
                               "flash_dkv_bf16") if bf16 else
                              ("flash_fwd", "flash_dq", "flash_dkv"))
    counts = launch_counts()
    assert {fwd, dq, dkv} <= set(counts)
    want_src = {fwd: "flash_fwd_bf16" if bf16 else "flash_fwd_f32",
                dq: "flash_dq_bf16" if bf16 else "flash_dq_f32",
                dkv: "flash_dkv_bf16" if bf16 else "flash_dkv_f32"}

    loaded = []

    class _Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, sym):
            fn = type("Fn", (), {})()
            fn.lib, fn.sym = self.name, sym
            return fn

    monkeypatch.setattr(build, "load", lambda name: loaded.append(name)
                        or _Lib(name))
    monkeypatch.setattr(tf, "_fns", {})
    monkeypatch.setattr(tb, "_fns", {})
    for name, mod in ((fwd, tf), (dq, tb), (dkv, tb)):
        fn = mod._kernel_fn(name)
        assert (fn.lib, fn.sym) == (want_src[name], f"repro_{name}")
    assert loaded == [want_src[fwd], want_src[dq], want_src[dkv]]

    # each entry point is defined in the source its wrapper loads, and
    # nowhere else; the dq and dkv kernels keep the names the profiler
    # looks up
    csrc = Path(build.CSRC)
    assert {"flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16",
            "flash_fwd_f32", "flash_dq_f32",
            "flash_dkv_f32"} <= set(build.sources())
    assert "flash_fwd" not in build.sources()
    for name in (fwd, dq, dkv):
        defined = [p.stem for p in sorted(csrc.glob("*.cu"))
                   if f'extern "C" int repro_{name}(' in p.read_text()
                   or f"int repro_{name}(REPRO_" in p.read_text()]
        assert defined == [want_src[name]], (name, defined)
    body = (csrc / "flash_fwd_sm90.cuh").read_text()
    assert "flash_fwd_kernel" in body
    assert ("Bf16Ops" if bf16 else "F32Ops") in body
    assert '#include "flash_fwd_sm90.cuh"' in (
        csrc / f"{want_src[fwd]}.cu").read_text()
    assert "flash_dq_kernel" in (csrc / f"{want_src[dq]}.cu").read_text()
    assert "flash_dkv_kernel" in (csrc / f"{want_src[dkv]}.cu").read_text()

    for d in (16, 32, 64, 128):
        x = torch.zeros((1, 2, 64, d), dtype=dtype)
        tf.check_kernel_shapes(x, x, x)
    for shape in ((1, 2, 64, 48), (1, 2, 96, 64)):
        x = torch.zeros(shape, dtype=dtype)
        with pytest.raises(ValueError, match="head_dim"):
            tf.check_kernel_shapes(x, x, x)


def _f32_case(mode, kv, d, seed):
    """f32 inputs (not bf16 values) from a numpy seed, and the dropout
    operands of JAX and of the port."""
    (b, h, s), _, jop, top = _case(mode, kv, d, seed)
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d),
                            (b, h, s, d))]
    return (b, h, s), arrays, jop, top


@pytest.mark.parametrize("mode,kv,d", [
    ("replay", 4, 32), ("premask", 4, 32), ("none", 4, 32),
    ("replay", 2, 32), ("premask", 2, 16), ("replay", 4, 16),
    ("replay", 4, 64), ("premask", 2, 64)])
def test_f32_tc_emulation_matches_jax_and_plain(mode, kv, d):
    """The f32 dq and dkv kernels' arithmetic (both operands of every
    product split into triples, six part products) on f32 inputs against
    JAX's f32 kernels and the port's plain version: dq, dk, dv within
    1e-4 x (1 + |x|) of both."""
    (b, h, s), arrays, jop, top = _f32_case(mode, kv, d, 7 * kv + d)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in arrays)
    args = dict(ARGS, mode=mode)
    scale = 1.0 / d ** 0.5
    dp = _dropout(mode, top, b, h, s)

    jo, jl = jf.flash_attention_fwd(jq, jk, jv, jop, return_lse=True, **args)
    o = torch.from_numpy(np.array(jo, np.float32))
    lse = torch.from_numpy(np.array(jl, np.float32))
    jdq, jdk, jdv = jfb.flash_attention_bwd(jq, jk, jv, jo, jl, jdo, jop,
                                            **args)
    dq = emulate_dq(q, k, v, do, o, lse, dp, scale, both=True)
    dk_h, dv_h = emulate_dkv(q, k, v, do, o, lse, dp, scale, both=True)
    dk, dv = (_group_sum(x, kv) for x in (dk_h, dv_h))
    pdq, pdk_h, pdv_h = tb.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     top, **args)
    pdk, pdv = (_group_sum(x, kv) for x in (pdk_h, pdv_h))
    for got, want, pwant in ((dq, jdq, pdq), (dk, jdk, pdk), (dv, jdv, pdv)):
        assert got.dtype == torch.float32 and pwant.dtype == torch.float32
        assert _ratio(got, np.asarray(want), FWD_TOL, scaled=False) <= 1
        assert _ratio(got, pwant, FWD_TOL, scaled=False) <= 1


@pytest.mark.parametrize("mode,kv,d", [
    ("replay", 4, 32), ("premask", 4, 32), ("none", 4, 32),
    ("replay", 2, 32), ("premask", 2, 16), ("replay", 4, 16),
    ("replay", 4, 64), ("premask", 2, 64)])
def test_f32_tc_fwd_emulation_matches_jax_and_plain(mode, kv, d):
    """The f32 forward kernel's arithmetic (Q, K, V and P split into
    triples, six part products a product, each block's P V folded by an
    f32 add) on f32 inputs against JAX's f32 kernel and the port's plain
    version: O and lse within 1e-4 x (1 + |x|) of both."""
    (b, h, s), arrays, jop, top = _f32_case(mode, kv, d, 5 * kv + d)
    q, k, v, _ = (torch.from_numpy(x) for x in arrays)
    jq, jk, jv, _ = (jnp.asarray(x) for x in arrays)
    args = dict(ARGS, mode=mode)
    dp = _dropout(mode, top, b, h, s)

    jo, jl = jf.flash_attention_fwd(jq, jk, jv, jop, return_lse=True, **args)
    o, lse = emulate_fwd(q, k, v, dp, 1.0 / d ** 0.5, both=True)
    po, plse = tf.flash_attention_fwd_plain(q, k, v, top, **args)
    for got, want, pwant in ((o, jo, po), (lse, jl, plse)):
        assert got.dtype == torch.float32 and pwant.dtype == torch.float32
        assert _ratio(got, np.asarray(want), FWD_TOL, scaled=False) <= 1
        assert _ratio(got, pwant, FWD_TOL, scaled=False) <= 1


def test_f32_tc_fwd_bf16_rounded_kv_is_further_off():
    """The forward's precision control: the same emulation with K and V
    rounded once to bf16 (what a product that splits only one operand
    keeps of the other) is at least 10x further from JAX's f32 O and lse
    than the kernels' six part products (measured: O 4.8e-7 against
    4.4e-3 x (1 + |x|), lse 1.7e-7 against 1.9e-3)."""
    (b, h, s), arrays, jop, top = _f32_case("replay", 4, 64, 3)
    q, k, v, _ = (torch.from_numpy(x) for x in arrays)
    dp = _dropout("replay", top, b, h, s)
    jo, jl = jf.flash_attention_fwd(*(jnp.asarray(x) for x in arrays[:3]),
                                    jop, return_lse=True,
                                    **dict(ARGS, mode="replay"))
    bf = lambda t: t.to(BF16).float()  # noqa: E731
    err = {}
    for tag, kk, vv in (("split", k, v), ("rounded", bf(k), bf(v))):
        o, lse = emulate_fwd(q, kk, vv, dp, 1.0 / 8, both=True)
        err[tag] = (_ratio(o, np.asarray(jo), 1.0, scaled=False),
                    _ratio(lse, np.asarray(jl), 1.0, scaled=False))
    assert err["split"][0] <= FWD_TOL / 100, err
    for i in (0, 1):
        assert err["rounded"][i] >= 10 * err["split"][i], err
    assert err["rounded"][0] > FWD_TOL, err


@pytest.mark.parametrize("k_len", [16, 64, 128])
def test_f32_tc_both_sides_split_is_f32_one_side_is_not(k_len):
    """Why the f32 kernels split both operands: hi + mid + lo == x
    bitwise; the six part products that reach 2^-16, summed in f32, are
    within 2^-22 x sum |a||b| of the exact product (float64) at worst; a
    triple on one side alone, the other operand rounded once to bf16, is
    at least 100x further off."""
    rng = np.random.default_rng(k_len)
    a = torch.from_numpy(rng.standard_normal((64, k_len)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k_len, 64)).astype(np.float32)
                         * np.float32(3.0))
    for x in (a, b):
        hi, mid, lo = _split(x, 3)
        assert all(t.to(BF16).float().equal(t) for t in (hi, mid, lo))
        assert torch.equal(hi.double() + mid.double() + lo.double(),
                           x.double())
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err6 = float(((_times(a, b, both=True).double() - exact).abs()
                  / scale).max())
    err3 = float(((_times(a, b.to(BF16).float()).double() - exact).abs()
                  / scale).max())
    assert err6 <= 2.0 ** -22, err6
    assert err3 >= 100 * err6, (err3, err6)
