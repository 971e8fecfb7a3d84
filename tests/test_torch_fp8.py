"""The port's fp8 (e4m3) producer GEMM against the JAX package: per-tile
quantization (e4m3 bytes and scales bitwise), the fused e4m3 GEMM+RNG
(C within 3e-5, the plane bitwise and equal to the f32 host's), its
Region-3 variant (no plane, C equal to JAX's plain fp8 GEMM), the
straight-through bf16 dgrad (gradients within 1e-4) and the documented
error bound (< 0.06 Frobenius-relative to f32). The cases are those of
``tests/test_fp8_gemm.py`` plus the scale-tile shapes the CUDA kernel
must get right: a logical block taller than its 128-row CTA tile (M =
192) and a k-block that is not 512 (K = 11008 gives bk = 344); the
kernels' own order of summation (``gemm_fp8_kernel_order``) against JAX's
within 1e-4 (1 + |C|), their K-major weight bitwise the transpose of JAX's,
and the operand check that refuses what they cannot take. Inputs are
made with numpy from a seed; the JAX kernels run in Pallas interpret mode
on the CPU, the port's wrappers take their plain versions there.

    PYTHONPATH=src python -m pytest -q tests/test_torch_fp8.py

The ``gpu``-marked test holds the CUDA kernel against its plain version
on the card and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core import producer as jproducer
from repro.core.overlap import plan_from_config
from repro.kernels import quant as jquant
from repro.kernels.gemm_rng import gemm_with_rng_fp8 as j_fp8
from repro.kernels.gemm_rng import gemm_with_rng_grouped_fp8 as j_grouped_fp8
from repro.kernels.ref import philox_mask_ref
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.kernels import gemm_rng as tg
from repro_torch.kernels import launch_counts, quant, reset_launch_counts
from repro_torch.kernels.ops import fused_gemm_rng_fp8

C_TOL = dict(atol=3e-5, rtol=3e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BOUND = quant.quantize_error_bound()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def _operands(seed, m, k, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((m, k)) * scale).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("shape,tile,scale", [
    ((256, 128), (64, 64), 1.0),
    ((256, 384), (64, 128), 1e-3),
    ((192, 256), (192, 256), 1e5),
    ((64, 11008), (64, 344), 1.0)])
def test_quantize_tiled_bitwise_equal_jax(shape, tile, scale):
    x = (np.random.default_rng(1).standard_normal(shape) * scale
         ).astype(np.float32)
    x[:tile[0], :tile[1]] = 0.0                  # an all-zero tile
    x[-tile[0]:, -tile[1]:] *= 1e-30             # subnormal-range values
    q, s = quant.quantize_tiled(torch.from_numpy(x), *tile)
    jq, js = jquant.quantize_tiled(jnp.asarray(x), *tile)
    assert q.dtype == quant.fp8_dtype()
    assert s.shape == (shape[0] // tile[0], shape[1] // tile[1])
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    back = quant.dequantize_tiled(q, s, *tile)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_tiled(jq, js, *tile)))
    # |x_hat - x| <= 2**-4 * (tile amax); the zero tile round-trips exactly
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        2.0 ** -4 * float(np.abs(x).max())
    assert not back[:tile[0], :tile[1]].any()


# (m, k, n), logical blocks (bm, bn, bk), plane (B, H, SQ, SK), mask cols
GEMM_CASES = [
    ((256, 128, 256), (128, 128, 128), (2, 2, 64, 128), 128),
    ((512, 512, 512), (128, 128, 128), (2, 2, 64, 128), 128),
    # a logical block of 192 rows: taller than the kernel's 128-row CTA
    # tile, so its scale rows cut across CTAs
    ((192, 64, 256), (192, 256, 64), (1, 2, 64, 128), 128),
    # ffn_down's K: bk = 344, 32 k-blocks
    ((64, 11008, 64), (64, 64, 344), (1, 1, 32, 64), 64)]


@pytest.mark.parametrize("dims,blocks,plane,cols", GEMM_CASES)
def test_fp8_gemm_equals_jax(dims, blocks, plane, cols):
    m, k, n = dims
    a, b = _operands(sum(dims), m, k, n)
    mb, mh, sq, sk = plane
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sk, p=0.25,
              seed=4, salt=2, block_m=blocks[0], block_n=blocks[1],
              block_k=blocks[2], mask_block_cols=cols)
    c, mask = fused_gemm_rng_fp8(torch.from_numpy(a), torch.from_numpy(b),
                                 **kw)
    jc, jmask = j_fp8(jnp.asarray(a), jnp.asarray(b), **kw)
    assert mask is not None and mask.shape == (mb, mh, sq // 32, sk)
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **C_TOL)
    rel = _rel_err(c.numpy(), a @ b)
    assert 0.0 < rel < BOUND, rel
    # the plane does not depend on the host dtype
    _, mask32 = tg.gemm_with_rng(torch.from_numpy(a), torch.from_numpy(b),
                                 **kw)
    assert torch.equal(mask, mask32)
    np.testing.assert_array_equal(
        _u32(mask), np.asarray(philox_mask_ref(mb, mh, sq, sk, 0.25, 4,
                                               salt=2)))


def test_fp8_region3_runs_the_plain_product():
    """Grid too small for the plane: (quantized GEMM, None), C equal to
    JAX's plain fp8 GEMM and within the error bound."""
    a, b = _operands(3, 128, 128, 128)
    kw = dict(mask_batch=8, mask_heads=16, mask_sq=2048, mask_sk=2048,
              p=0.1, seed=0, block_m=128, block_n=128, block_k=128)
    c, mask = tg.gemm_with_rng_fp8(torch.from_numpy(a), torch.from_numpy(b),
                                   **kw)
    jc, jmask = j_fp8(jnp.asarray(a), jnp.asarray(b), **kw)
    assert mask is None and jmask is None
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **C_TOL)
    assert _rel_err(c.numpy(), a @ b) < BOUND


@pytest.mark.parametrize("dims,blocks", [((128, 128, 128), (128, 128, 128)),
                                         ((192, 64, 256), (192, 256, 64))])
def test_fp8_grads_equal_jax(dims, blocks):
    """Straight-through quantization and the bf16 dgrad pair: gradients of
    sum(C**2) within 1e-4 of JAX's, and within 0.1 of the exact f32
    gradients (the fp8 forward's error budget)."""
    m, k, n = dims
    a, b = _operands(7, m, k, n)
    kw = dict(mask_batch=1, mask_heads=2, mask_sq=64, mask_sk=128, p=0.1,
              seed=3, block_m=blocks[0], block_n=blocks[1],
              block_k=blocks[2], mask_block_cols=128)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    c, _ = tg.gemm_with_rng_fp8(ta, tb, **kw)
    da, db = torch.autograd.grad(c.square().sum(), (ta, tb))

    def loss(a_, b_):
        return jnp.sum(jnp.square(j_fp8(a_, b_, **kw)[0]))

    jda, jdb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD_TOL)
    exact = a @ b
    assert _rel_err(da.numpy(), (2.0 * exact) @ b.T) < 0.1
    assert _rel_err(db.numpy(), a.T @ (2.0 * exact)) < 0.1


@pytest.mark.parametrize("how", [producer.HOW_GEMM,
                                 producer.HOW_STANDALONE])
def test_producer_routes_fp8(how):
    """``gemm_dtype="fp8"`` routes ``gemm_with_mask`` through the fp8 host:
    JAX's bits and GEMM, in the fused and the Region-3 case."""
    kw = dict(mode="overlap", p=0.25, seed=5, site="qkv", gemm_dtype="fp8")
    plan = DropoutPlan(DropoutPlanConfig(**kw))
    jplan = plan_from_config(JPlanConfig(**kw))
    b, h, s = (1, 2, 128) if how == producer.HOW_GEMM else (1, 64, 256)
    x2d, w = _operands(11, b * s, 64, 192)
    y, mask = producer.gemm_with_mask(
        torch.from_numpy(x2d), torch.from_numpy(w), plan, (b, h, s, s), 3, 7,
        how=how)
    jy, jmask, jhow = jproducer.gemm_with_mask(
        jnp.asarray(x2d), jnp.asarray(w), jplan, (b, h, s, s), 3, 7)
    assert jhow == how
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)
    assert 0.0 < _rel_err(y.numpy(), x2d @ w) < BOUND


# the e4m3 kernels' decomposition (k16 tensor-core slices, straddling
# slices issued once per k-block with A's other bytes zeroed, one rescale
# per k-block) against JAX's order: (m, k, n), (bm, bn, bk) -- bk = 344
# straddles k16 slices, 352 and 512 do not, 64 is one k-block a stage half;
# bm 192 and 240 and bn 176 cut the kernel's 128 x 128 CTA tiles
ORDER_CASES = [
    ((192, 1032, 176), (192, 176, 344)),
    ((240, 704, 352), (240, 176, 352)),
    ((192, 1024, 176), (192, 176, 512)),
    ((240, 128, 176), (240, 176, 64)),
    ((64, 11008, 64), (64, 64, 344)),
]
# f32 sums of up to 11008 products in another order, and the rescale per
# k-block: 1e-4 (1 + |C|), ten times inside the card's check of the kernel
ORDER_TOL = 1e-4


@pytest.mark.parametrize("dims,blocks", ORDER_CASES)
def test_fp8_kernel_order_equals_plain(dims, blocks):
    """``gemm_fp8_kernel_order`` -- the CUDA kernels' order of summation on
    K-major operands -- equals the plain version (JAX's order) within
    ORDER_TOL x (1 + |C|)."""
    m, k, n = dims
    bm, bn, bk = blocks
    a, b = _operands(sum(dims), m, k, n)
    a_q, a_s = quant.quantize_tiled(torch.from_numpy(a), bm, bk)
    b_q, b_s = quant.quantize_tiled(torch.from_numpy(b), bk, bn)
    bt_q, bt_s = quant.quantize_tiled(torch.from_numpy(b).T, bn, bk)
    got = tg.gemm_fp8_kernel_order(a_q, a_s, bt_q, bt_s, blocks)
    want = tg.gemm_fp8_plain(a_q, a_s, b_q, b_s, blocks)
    assert bool(((got - want).abs() <= ORDER_TOL * (1 + want.abs())).all())


@pytest.mark.parametrize("shape,tile", [((256, 384), (64, 128)),
                                        ((11008, 64), (344, 64)),
                                        ((4096, 176), (512, 176)),
                                        ((96, 240), (32, 80))])
def test_kmajor_operand_is_the_transpose(shape, tile):
    """The kernel's K-major weight: quantize_tiled of b.T, laid out
    contiguously, is bitwise b_q.T and b_s.T (the same tiles, amax and
    division)."""
    b = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    b[:tile[0], :tile[1]] = 0.0                  # an all-zero tile
    b_q, b_s = quant.quantize_tiled(torch.from_numpy(b), *tile)
    bt_q, bt_s = quant.quantize_tiled(torch.from_numpy(b).T, tile[1],
                                      tile[0])
    assert torch.equal(bt_q.contiguous().view(torch.uint8),
                       b_q.T.contiguous().view(torch.uint8))
    assert torch.equal(bt_s, b_s.T)


def _kmajor_ops(m, k, n, blocks):
    bm, bn, bk = blocks
    a, b = _operands(0, m, k, n)
    return (*quant.quantize_tiled(torch.from_numpy(a), bm, bk),
            *(t.contiguous() for t in
              quant.quantize_tiled(torch.from_numpy(b).T, bn, bk)))


def test_fp8_kernel_rejects_what_it_cannot_take():
    """The e4m3 kernel's operand check raises -- before any launch, with no
    fallback -- on K-major operands it does not take: rows not a multiple
    of 16 bytes apart (the tensor maps' row stride; K = 88 is taken once
    ``pad_k16`` pads its rows), bk not a multiple of 8, scales or bytes of
    the wrong shape, dtype or layout, an operand off 16 bytes."""
    reset_launch_counts()
    check = tg._check_fp8_kmajor
    name = tg.KERNEL_FP8
    a_q, a_s, bt_q, bt_s = _kmajor_ops(64, 88, 64, (64, 64, 88))
    with pytest.raises(ValueError, match="multiple of 16"):
        check(name, a_q, a_s, bt_q, bt_s, (64, 64, 88))     # K = 88
    assert check(name, tg.pad_k16(a_q), a_s, tg.pad_k16(bt_q), bt_s,
                 (64, 64, 88)) == 96
    a_q, a_s, bt_q, bt_s = _kmajor_ops(64, 96, 64, (64, 64, 12))
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        check(name, a_q, a_s, bt_q, bt_s, (64, 64, 12))     # bk = 12
    a_q, a_s, bt_q, bt_s = _kmajor_ops(64, 128, 64, (64, 64, 64))
    check(name, a_q, a_s, bt_q, bt_s, (64, 64, 64))         # takes these
    with pytest.raises(ValueError, match="K-major"):
        check(name, a_q, a_s, bt_q, bt_s.T, (64, 64, 64))   # scales (K, N)
    with pytest.raises(ValueError, match="K-major"):
        check(name, a_q, a_s, bt_q.T.contiguous(), bt_s, (64, 64, 64))
    with pytest.raises(ValueError, match="K-major"):
        check(name, a_q.to(torch.float32), a_s, bt_q, bt_s, (64, 64, 64))
    with pytest.raises(ValueError, match="K-major"):
        check(name, a_q, a_s, bt_q, bt_s, (32, 64, 64))     # bm != tiles
    flat = torch.zeros(64 * 128 + 16, dtype=quant.fp8_dtype())
    off_16 = flat[1:1 + 64 * 128].view(64, 128)      # contiguous, 1 byte in
    with pytest.raises(ValueError, match="16 bytes"):
        check(name, off_16, a_s, bt_q, bt_s, (64, 64, 64))
    with pytest.raises(ValueError, match="2-d"):
        check(name, a_q[None], a_s, bt_q[None], bt_s, (64, 64, 64))
    assert set(launch_counts().values()) == {0}


def test_fp8_hosts_take_k_not_a_multiple_of_16():
    """K = 344 with bk = 344 (K = 8 x an odd number), which JAX's e4m3
    kernels take: the dense and grouped hosts give JAX's C (3e-5) and
    plane (bitwise) on the CPU, and the K-major operands the wrappers hand
    the card -- each row zero-padded to 352 bytes by ``pad_k16``, the
    tensor maps' 16-byte row stride -- pass the kernels' operand check,
    hold the same values, and give the plain product in the kernels' order
    of summation (the last k16 slice straddles K)."""
    reset_launch_counts()
    m, k, n, blocks = 64, 344, 64, (64, 64, 344)
    a, b = _operands(8, m, k, n)
    kw = dict(mask_batch=1, mask_heads=1, mask_sq=32, mask_sk=64, p=0.25,
              seed=4, salt=2, block_m=64, block_n=64, block_k=344,
              mask_block_cols=64)
    c, mask = tg.gemm_with_rng_fp8(torch.from_numpy(a), torch.from_numpy(b),
                                   **kw)
    jc, jmask = j_fp8(jnp.asarray(a), jnp.asarray(b), **kw)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **C_TOL)
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    a_q, a_s = quant.quantize_tiled(torch.from_numpy(a), 64, 344)
    b_q, b_s = quant.quantize_tiled(torch.from_numpy(b), 344, 64)
    pa, pbt = tg.pad_k16(a_q), tg.pad_k16(b_q.T)
    assert pa.shape == (m, k) and pa.stride() == (352, 1)
    assert torch.equal(pa.view(torch.uint8), a_q.view(torch.uint8))
    assert torch.equal(pbt.view(torch.uint8),
                       b_q.T.contiguous().view(torch.uint8))
    bt_s = b_s.T.contiguous()
    assert tg._check_fp8_kmajor(tg.KERNEL_FP8, pa, a_s, pbt, bt_s,
                                blocks) == 352
    want = tg.gemm_fp8_plain(a_q, a_s, b_q, b_s, blocks)
    got = tg.gemm_fp8_kernel_order(pa, a_s, pbt, bt_s, blocks)
    assert bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all())
    ck, _ = tg.gemm_rng_fp8_kmajor(pa, a_s, pbt, bt_s, blocks, None)
    assert torch.equal(ck, want)
    # the grouped host, two experts
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    w = rng.standard_normal((2, k, n)).astype(np.float32)
    kwg = dict(kw, mask_sk=64)
    y, gmask = tg.gemm_with_rng_grouped_fp8(torch.from_numpy(x),
                                            torch.from_numpy(w), **kwg)
    jy, jgmask = j_grouped_fp8(jnp.asarray(x), jnp.asarray(w), **kwg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)
    np.testing.assert_array_equal(_u32(gmask), np.asarray(jgmask))
    a_q, a_s, b_q, b_s = tg.quantize_grouped(torch.from_numpy(x),
                                             torch.from_numpy(w), blocks)
    bt_q, bt_s = tg.kmajor_grouped(b_q, b_s, blocks)
    pa, pbt = tg.pad_k16(a_q), tg.pad_k16(bt_q)
    assert tg._check_fp8_kmajor(tg.KERNEL_GROUPED_FP8, pa, a_s, pbt, bt_s,
                                blocks, groups=2) == 352
    yk, _ = tg.gemm_rng_grouped_fp8_kmajor(pa, a_s, pbt, bt_s, blocks, None)
    assert torch.equal(yk, tg.gemm_grouped_fp8_plain(a_q, a_s, b_q, b_s,
                                                     blocks))
    assert set(launch_counts().values()) == {0}


def test_fp8_checks_and_cpu_launches_nothing():
    """Operands the fp8 host does not take raise (a dtype without a
    kernel, blocks that do not tile); f32 and bf16 CPU operands take the
    plain version, C in their dtype, and launch no kernel."""
    reset_launch_counts()
    a = torch.zeros((64, 32))
    c16, _ = tg.gemm_with_rng_fp8(a.to(torch.bfloat16),
                                  a.T.to(torch.bfloat16), mask_batch=1,
                                  mask_heads=1, mask_sq=32, mask_sk=32,
                                  p=0.1, seed=0)
    assert c16.dtype == torch.bfloat16 and not c16.any()
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        tg.gemm_with_rng_fp8(a.half(), a.T.half(), mask_batch=1,
                             mask_heads=1, mask_sq=32, mask_sk=32, p=0.1,
                             seed=0)
    with pytest.raises(ValueError, match="do not tile"):
        tg.gemm_with_rng_fp8(a, a.T, mask_batch=1, mask_heads=1, mask_sq=32,
                             mask_sk=32, p=0.1, seed=0, block_m=48)
    c, _ = tg.gemm_with_rng_fp8(a, a.T, mask_batch=1, mask_heads=1,
                                mask_sq=32, mask_sk=32, p=0.1, seed=0)
    assert not c.any()                 # all-zero tiles stay finite and zero
    # the K-major entry on CPU tensors: the plain version, as JAX's layout
    a_q, a_s, bt_q, bt_s = _kmajor_ops(64, 128, 64, (64, 64, 64))
    ck, _ = tg.gemm_rng_fp8_kmajor(a_q, a_s, bt_q, bt_s, (64, 64, 64), None)
    assert torch.equal(ck, tg.gemm_fp8_plain(a_q, a_s, bt_q.T, bt_s.T,
                                             (64, 64, 64)))
    assert set(launch_counts().values()) == {0}


@pytest.mark.gpu
def test_fp8_kernel_equals_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none on this machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    for (m, k, n), blocks, (mb, mh, sq, sk), cols in GEMM_CASES:
        a, b = (torch.from_numpy(t).cuda() for t in _operands(0, m, k, n))
        kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sk,
                  p=0.1, seed=torch.tensor(7), salt=3, block_m=blocks[0],
                  block_n=blocks[1], block_k=blocks[2], mask_block_cols=cols)
        c, mask = tg.gemm_with_rng_fp8(a, b, **kw)
        want_c, want = tg.gemm_with_rng_fp8_plain(a, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(mask, want)
        torch.testing.assert_close(c, want_c, atol=1e-4, rtol=1e-4)
    # bk = 344 at llama2's down-projection K (k16 slices straddle k-blocks)
    # and 256-row tiles, the product only, against the plain version
    for dims, blocks in ((256, 11008, 256), (256, 256, 344)), \
            ((256, 4096, 512), (256, 256, 512)):
        ops = tuple(t.cuda() for t in _kmajor_ops(*dims, blocks))
        c, _ = tg.gemm_rng_fp8_kmajor(*ops, blocks, None)
        want_c = tg.gemm_fp8_plain(ops[0], ops[1], ops[2].T, ops[3].T,
                                   blocks)
        torch.cuda.synchronize()
        assert bool(((c - want_c).abs() <= 1e-3 * (1 + want_c.abs())).all())
    counts = launch_counts()
    assert counts.pop("gemm_rng_fp8") == len(GEMM_CASES) + 2
    assert set(counts.values()) == {0}
