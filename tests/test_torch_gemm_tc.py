"""The arithmetic of the tensor-core f32 GEMM+RNG kernels, on the CPU.

``csrc/gemm_rng.cu`` (dense) and ``csrc/gemm_rng_grouped.cu`` (grouped)
run only on the card, as the f32 instance of ``csrc/gemm_tc.cuh``: both
f32 operands split into exact bf16 triples (hi = bf16(x), mid = bf16(x -
hi), lo = bf16(x - hi - mid)), each f32 product taken as the six part
products that reach 2^-16 (lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi,
the smallest first), summed in f32 a stage of 32 k at a time and each
stage's sum folded into C by an f32 add. That is emulated here in torch and
held, with the port's plain version, against the JAX package's
``gemm_with_rng`` / ``gemm_with_rng_grouped`` (Pallas interpret mode) on
numpy inputs from a seed at the North star's 3e-5: dense and grouped (an
expert's M not a multiple of 64, K not a multiple of 32), each with the
emission on (planes bitwise) and off (Region 3). Further tests pin why:
the triple is exact over wide exponents, and operands rounded once to bf16
are at least 100x further off and outside 3e-5; that f32 operands reach the
new entry points and K or N off a multiple of 4 raises
``NotImplementedError``, which no configuration's host widths meet; and
that every emission layout the ported hosts plan tiles the plane, as the
kernels' emission (``emit_share``) needs.

    PYTHONPATH=src python -m pytest -q tests/test_torch_gemm_tc.py
"""
import contextlib
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm_rng as jg
from repro_torch.core.producer import pick_gemm_blocks
from repro_torch.kernels import build
from repro_torch.kernels import gemm_rng as tg

BF16 = torch.bfloat16
C_TOL = dict(atol=3e-5, rtol=3e-5)
STAGE_K = 32  # k of one stage of the kernels
# the six part products (A part, B part), 0 = hi, 1 = mid, 2 = lo
PARTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))

# (E or None for the dense host, M, K, N), logical blocks, plane (B, H, SQ,
# SK): each host with a plane its grid holds, and with one it cannot
# (Region 3: the emission off). The grouped M = 200 leaves an expert's
# second CTA row 72 rows; K = 100 and 68 end inside a stage.
CASES = {
    "dense-emit": ((None, 256, 100, 128), (64, 64, 100), (1, 2, 64, 64)),
    "dense-off": ((None, 256, 100, 128), (256, 128, 100), (1, 32, 1024, 1024)),
    "grouped-emit": ((3, 200, 68, 136), (200, 136, 68), (1, 2, 64, 64)),
    "grouped-off": ((3, 200, 68, 136), (200, 136, 68), (1, 32, 1024, 1024)),
}


def _operands(seed, e, m, k, n):
    rng = np.random.default_rng(seed)
    lead = () if e is None else (e,)
    return (rng.standard_normal((*lead, m, k)).astype(np.float32),
            rng.standard_normal((*lead, k, n)).astype(np.float32))


def _kw(blocks, plane):
    mb, mh, sq, sk = plane
    return dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sk, p=0.1,
                seed=7, salt=3, block_m=blocks[0], block_n=blocks[1],
                block_k=blocks[2])


def _triple(x: torch.Tensor):
    """x's exact triple as f32 tensors of bf16 values (split3's steps)."""
    hi = x.to(BF16).float()
    rest = x - hi
    mid = rest.to(BF16).float()
    return hi, mid, (rest - mid).to(BF16).float()


def emulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' C = a @ b for f32 a (..., M, K), b (..., K, N): a stage
    of 32 k at a time, the six part products of both triples summed from
    zero in f32, then folded into C by an f32 add."""
    c = torch.zeros((*a.shape[:-1], b.shape[-1]))
    for k0 in range(0, a.shape[-1], STAGE_K):
        at = _triple(a[..., k0:k0 + STAGE_K])
        bt = _triple(b[..., k0:k0 + STAGE_K, :])
        d = at[PARTS[0][0]] @ bt[PARTS[0][1]]
        for i, j in PARTS[1:]:
            d = d + at[i] @ bt[j]
        c = c + d
    return c


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_tc_emulation_equals_jax(case):
    """JAX's f32 kernel (interpret mode), the emulation of the tensor-core
    kernel and the port's plain version agree within 3e-5; the planes are
    bitwise JAX's, and none is made in Region 3."""
    (e, m, k, n), blocks, plane = CASES[case]
    a, b = _operands(len(case), e, m, k, n)
    kw = _kw(blocks, plane)
    fn, jfn = ((tg.gemm_with_rng, jg.gemm_with_rng) if e is None else
               (tg.gemm_with_rng_grouped, jg.gemm_with_rng_grouped))
    jc, jmask = jfn(jnp.asarray(a), jnp.asarray(b), **kw)
    c, mask = fn(torch.from_numpy(a), torch.from_numpy(b), **kw)
    em = emulate(torch.from_numpy(a), torch.from_numpy(b))
    assert (mask is None) == (jmask is None) == case.endswith("off")
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                      np.asarray(jmask))
    np.testing.assert_allclose(em.numpy(), np.asarray(jc), **C_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **C_TOL)
    np.testing.assert_allclose(em.numpy(), c.numpy(), **C_TOL)


def test_f32_tc_triple_is_exact():
    """hi + mid + lo == x exactly for f32 values of both signs over
    exponents -100 .. 100, each part a bf16 value, each smaller part at
    most half a bf16 ulp of the one before."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(1, 2, 200_000) * 2.0 ** rng.integers(-100, 101, 200_000)
         * rng.choice([-1, 1], 200_000)).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = _triple(x)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), x)
    assert torch.equal(hi + mid + lo, x)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(BF16).float(), part)
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


def test_f32_tc_bf16_control_is_further_off():
    """Against the exact (f64) product, the six part products read within
    f32 rounding, and A, W rounded once to bf16 -- what a product that keeps
    an operand to bf16 computes -- at least 100x further off and outside
    3e-5 (the limit the emulation holds)."""
    a, b = (torch.from_numpy(t) for t in _operands(5, None, 128, 512, 96))
    exact = a.double() @ b.double()
    got = emulate(a, b)
    ctl = a.to(BF16).float() @ b.to(BF16).float()
    err = float((got.double() - exact).abs().max())
    ctl_err = float((ctl.double() - exact).abs().max())
    assert ctl_err > 100 * err
    limit = C_TOL["atol"] + C_TOL["rtol"] * exact.abs()
    assert bool(((got.double() - exact).abs() <= limit).all())
    assert not bool(((ctl.double() - exact).abs() <= limit).all())


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors routed as if they lay on the card: the wrappers' device
    check says CUDA, and each entry point records its arguments instead
    of launching."""
    calls = []

    def kernel_fn(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tg, "_check_device", lambda a, name: True)
    monkeypatch.setattr(tg, "_kernel_fn", kernel_fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    return calls


@pytest.mark.parametrize("grouped", [False, True])
def test_f32_tc_wrappers_route_and_check_rows(grouped, fake_card,
                                              monkeypatch):
    """f32 operands reach repro_gemm_rng (gemm_rng.cu) and
    repro_gemm_rng_grouped (gemm_rng_grouped.cu), both instances of the
    tensor-core body gemm_tc.cuh (the SIMT body gone); bf16 ones their bf16
    entry points; K or N off a multiple of 4 (f32) or 8 (bf16) raises
    NotImplementedError before any launch, as a layout that does not tile
    its plane does."""
    name = tg.KERNEL_GROUPED if grouped else tg.KERNEL
    lib, entry, _, _ = tg._ENTRY[name]
    assert (lib, entry) == ((name, f"repro_{name}"))
    csrc = Path(build.CSRC)
    src = (csrc / f"{lib}.cu").read_text()
    assert f'extern "C" int {entry}(' in src
    assert '#include "gemm_tc.cuh"' in src and "F32Ops" in src
    assert "F32Ops" in (csrc / "gemm_tc.cuh").read_text()
    assert not (csrc / "gemm_f32.cuh").exists()
    assert "emit_blocks" not in (csrc / "gemm_emit.cuh").read_text()
    fn = tg.gemm_with_rng_grouped if grouped else tg.gemm_with_rng
    lead = (2,) if grouped else ()
    kw = _kw((64, 64, 64), (1, 2, 64, 64))
    for dtype, want in ((torch.float32, name),
                        (BF16, tg.KERNEL_GROUPED_BF16 if grouped
                         else tg.KERNEL_BF16)):
        fake_card.clear()
        a = torch.zeros((*lead, 128, 64), dtype=dtype)
        b = torch.zeros((*lead, 64, 128), dtype=dtype)
        c, mask = fn(a, b, **kw)
        assert [n for n, _ in fake_card] == [want]
        assert c.dtype == dtype and mask is not None
        args = fake_card[0][1]
        assert args[:3] == (a.data_ptr(), b.data_ptr(), c.data_ptr())
    fake_card.clear()
    per = 4  # f32 elements in TMA's 16-byte row stride
    for k, n in ((64 + per // 2, 128), (64, 128 + per // 2), (66, 130)):
        a = torch.zeros((*lead, 128, k))
        b = torch.zeros((*lead, k, n))
        with pytest.raises(NotImplementedError, match="multiples of 4"):
            fn(a, b, **_kw((64, 2 if n % 4 else 64, 2 if k % 4 else 64),
                           (1, 2, 64, 64)))
    for k, n in ((64 + 4, 128), (64, 128 + 4)):
        a = torch.zeros((*lead, 128, k), dtype=BF16)
        b = torch.zeros((*lead, k, n), dtype=BF16)
        with pytest.raises(NotImplementedError, match="multiples of 8"):
            fn(a, b, **_kw((64, 4 if n % 8 else 64, 4 if k % 8 else 64),
                           (1, 2, 64, 64)))
    assert fake_card == []
    # a layout that leaves a band of the plane unwritten
    broken = dataclasses.replace(
        tg.mask_emission_layout(8, 1, 2, 64, 64), n_valid_blocks=0)
    em = dataclasses.replace(tg._emission(
        torch.zeros((*lead, 128, 64)), torch.zeros((*lead, 64, 128)), 1, 2,
        64, 64, 0.1, 7, 3, 7, 64, 64, 64, 2048, 256, 0, 0,
        grouped=grouped)[1], layout=broken)
    fwd = tg._forward_grouped if grouped else tg._forward
    with pytest.raises(NotImplementedError, match="tiles the plane"):
        fwd(torch.zeros((*lead, 128, 64)), torch.zeros((*lead, 64, 128)), em)
    assert fake_card == []


# the fused hosts of the ported model paths at B=2, S=2048: llama2-7b's
# QKV, out-projection, gate+up and down GEMMs, moonshot-v1-16b-a3b's expert
# gate and down einsums (64 experts, capacity 480) and dense first layer,
# an RWKV channel-mix key and value GEMM at rwkv6-7b's widths (E=1) under a
# llama2-7b attention layer's plane, as in a hybrid; (E, M, K, N), plane
# (B, H, SQ, SK)
HOSTS = [((1, 4096, 4096, n), (2, 32, 2048, 2048))
         for n in (12288, 4096, 22016)] + [
    ((1, 4096, 11008, 4096), (2, 32, 2048, 2048)),
    ((64, 480, 2048, 1408), (2, 16, 2048, 2048)),
    ((64, 480, 1408, 2048), (2, 16, 2048, 2048)),
    ((1, 4096, 2048, 2 * 1408), (2, 16, 2048, 2048)),
    ((1, 4096, 4096, 14336), (2, 32, 2048, 2048)),
    ((1, 4096, 14336, 4096), (2, 32, 2048, 2048)),
]


def test_f32_tc_emission_layouts_tile_the_plane():
    """Every emission layout a fused host plans tiles its plane (whole row
    bands of column blocks, the last band the only clipped one), which the
    kernels' equal-share emission needs: the ported hosts' layouts, and
    every grid of 1 .. 4096 steps against planes of 1 .. 64 heads, SQ 32 ..
    4096 and SK 64 .. 8192. A layout that drops a band does not tile."""
    seen = 0
    for (e, m, k, n), (mb, mh, sq, sk) in HOSTS:
        bm, bn, _ = pick_gemm_blocks(m, n, k)
        lay = tg.mask_emission_layout(e * (m // bm) * (n // bn), mb, mh, sq,
                                      sk)
        assert lay is not None, (e, m, k, n)
        assert tg.layout_tiles_plane(lay)
        seen += 1
    for steps in (1, 2, 3, 7, 16, 60, 96, 128, 384, 500, 1024, 4096):
        for mb, mh, sq, sk in ((1, 1, 32, 64), (1, 2, 64, 64),
                               (2, 16, 2048, 2048), (2, 32, 2048, 2048),
                               (1, 64, 4096, 4096), (3, 5, 96, 8192),
                               (2, 40, 160, 1536)):
            lay = tg.mask_emission_layout(steps, mb, mh, sq, sk)
            if lay is not None:
                assert tg.layout_tiles_plane(lay), lay
                covered = sum((r1 - r0) * (c1 - c0)
                              for _, r0, r1, c0, c1 in lay.blocks())
                assert covered == lay.rows_valid * lay.sk
                seen += 1
                assert not tg.layout_tiles_plane(dataclasses.replace(
                    lay, n_valid_blocks=lay.n_valid_blocks - lay.n_cb))
    assert seen > 40


@pytest.mark.parametrize("reduced", [False, True])
def test_f32_tc_config_widths_take_the_kernels(reduced):
    """Every configuration's fused-host GEMM widths -- d_model (the QKV,
    out-projection and gate+up K, the out-projection and down N), the QKV
    width, d_ff and the expert d_ff -- are multiples of 4 (f32) and 8
    (bf16), so no model path meets the kernels' NotImplementedError."""
    from repro_torch.config import get_arch
    from repro_torch.config.registry import list_archs
    archs = list_archs()
    assert len(archs) >= 12
    for arch in archs:
        cfg = get_arch(arch, reduced=reduced)
        hd = getattr(cfg, "head_dim", None) or cfg.d_model // cfg.n_heads
        kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
        widths = [cfg.d_model, cfg.d_ff, (cfg.n_heads + 2 * kv) * hd,
                  cfg.n_heads * hd]
        moe = getattr(cfg, "moe", None)
        if moe is not None:
            widths.append(moe.d_ff_expert)
        assert all(w % 8 == 0 for w in widths), (arch, widths)
