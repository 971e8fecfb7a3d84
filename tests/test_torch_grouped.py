"""The port's grouped GEMM+RNG hosts (MoE expert einsum, RWKV channel-mix
with E=1) against the JAX package, mirroring ``tests/test_grouped_host.py``
at the kernel, producer and schedule level: the grouped kernels' plain
versions (f32 and per-expert-tile e4m3) against JAX's Pallas kernels in
interpret mode (planes bitwise, C within 3e-5, e4m3 bytes and scales
equal), the producer's bits against the oracle at f32, bf16 and fp8,
the grouped e4m3 kernels' order of summation and K-major operands at
capacity 480 (1e-4 (1 + |C|); bitwise), their operand check, Region 3
falling back to the standalone producer, gradients through both grouped
hosts (1e-4), and ``explain()`` text (f32, bf16 and fp8 hosts) equal to
JAX's for the reduced moonshot and arctic, the RWKV hybrid and the
test_grouped_host.py configs, with the distinct infeasible-shape reasons.
Inputs are made with numpy from a seed and handed to both.

    PYTHONPATH=src python -m pytest -q tests/test_torch_grouped.py
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.config.base import AttentionKind as JAttentionKind
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.config.base import FFNKind as JFFNKind
from repro.config.base import ModelConfig as JModelConfig
from repro.config.base import MoEConfig as JMoEConfig
from repro.core import producer as jproducer
from repro.core.overlap import plan_from_config
from repro.core.schedule import compile_schedule as j_compile
from repro.kernels import gemm_rng as jg
from repro.kernels import quant as jquant
from repro.kernels.ref import philox_mask_ref
from repro.perfmodel.hardware import GH100 as J_GH100
from repro_torch.config import get_arch
from repro_torch.config.base import (
    AttentionKind,
    DropoutPlanConfig,
    FFNKind,
    ModelConfig,
    MoEConfig,
)
from repro_torch.core import producer
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.kernels import gemm_rng as tg
from repro_torch.kernels import launch_counts, ops, quant, reset_launch_counts
from repro_torch.perfmodel.hardware import GH100

P, SEED = 0.25, 5
C_TOL = dict(atol=3e-5, rtol=3e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BOUND = quant.quantize_error_bound()

# (E, C, K, N), logical blocks, plane (B, H, SQ, SK), mask columns: a MoE
# grid, a capacity that is not a multiple of 128 (240 rows: the kernel's
# second CTA row of an expert is 7/8 full) with scale tiles cutting the
# CTA tiles, and the E=1 channel-mix case
GROUPED_CASES = [
    ((4, 256, 64, 128), (256, 128, 64), (2, 2, 128, 128), 2048),
    ((3, 240, 96, 176), (80, 88, 32), (1, 2, 64, 64), 64),
    ((1, 256, 64, 384), (256, 128, 64), (2, 2, 64, 64), 2048),
]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _operands(seed, e, c, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, k)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32))


def _kw(blocks, plane, cols):
    mb, mh, sq, sk = plane
    return dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sk, p=0.1,
                seed=7, salt=3, block_m=blocks[0], block_n=blocks[1],
                block_k=blocks[2], mask_block_cols=cols)


def _plan_kw(site, **kw):
    return dict(mode="overlap", p=P, seed=SEED, site=site, **kw)


def _plans(site, **kw):
    return (DropoutPlan(DropoutPlanConfig(**_plan_kw(site, **kw))),
            plan_from_config(JPlanConfig(**_plan_kw(site, **kw))))


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("case", range(len(GROUPED_CASES)))
@pytest.mark.parametrize("dtype", ["f32", "fp8"])
def test_grouped_host_equals_jax(case, dtype):
    """The grouped host's plain version against JAX's kernel in interpret
    mode: the plane bitwise (and bitwise the dense host's), C within 3e-5;
    fp8 C under the e4m3 bound of the f32 product."""
    (e, c, k, n), blocks, plane, cols = GROUPED_CASES[case]
    a, b = _operands(case, e, c, k, n)
    kw = _kw(blocks, plane, cols)
    fn, jfn = ((tg.gemm_with_rng_grouped, jg.gemm_with_rng_grouped)
               if dtype == "f32" else
               (tg.gemm_with_rng_grouped_fp8, jg.gemm_with_rng_grouped_fp8))
    y, mask = fn(torch.from_numpy(a), torch.from_numpy(b), **kw)
    jy, jmask = jfn(jnp.asarray(a), jnp.asarray(b), **kw)
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)
    mb, mh, sq, sk = plane
    want = philox_mask_ref(mb, mh, sq, sk, 0.1, 7, salt=3)
    np.testing.assert_array_equal(_u32(mask), np.asarray(want))
    exact = np.einsum("ecd,edf->ecf", a, b)
    if dtype == "fp8":
        rel = np.linalg.norm(y.numpy() - exact) / np.linalg.norm(exact)
        assert 0.0 < rel < BOUND
    else:
        np.testing.assert_allclose(y.numpy(), exact, **C_TOL)


def test_grouped_fp8_quantization_equals_jax():
    """The expert folds into the scale-tile rows as in JAX: e4m3 bytes and
    scales equal, and the grouped e4m3 tile product within 3e-5 of JAX's
    expert by expert."""
    (e, c, k, n), blocks, _, _ = GROUPED_CASES[1]
    a, b = _operands(1, e, c, k, n)
    ops_t = tg.quantize_grouped(torch.from_numpy(a), torch.from_numpy(b),
                                blocks)
    bm, bn, bk = blocks
    ja_q, ja_s = jquant.quantize_tiled(jnp.asarray(a.reshape(e * c, k)), bm,
                                       bk)
    jb_q, jb_s = jquant.quantize_tiled(jnp.asarray(b.reshape(e * k, n)), bk,
                                       bn)
    for got, want in zip(ops_t, (ja_q, ja_s, jb_q, jb_s)):
        got = got.reshape(np.shape(want))
        if got.dtype == torch.float32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_array_equal(
                got.view(torch.uint8).numpy(),
                np.asarray(want).view(np.uint8))
    assert ops_t[1].shape == (e * (c // bm), k // bk)
    assert ops_t[3].shape == (e * (k // bk), n // bn)
    y = tg.gemm_grouped_fp8_plain(*ops_t, blocks)
    jy, _ = jg.gemm_with_rng_grouped_fp8(
        jnp.asarray(a), jnp.asarray(b), **_kw(blocks, (1, 2, 64, 64), 64))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)


@pytest.mark.parametrize("dtype", ["f32", "fp8"])
def test_grouped_region3_returns_plain_f32(dtype):
    """A combined expert grid too small for the plane (Region 3): no plane,
    and the f32 product -- unquantized on the fp8 host too, as JAX's
    ``_plain_gemm_grouped`` does."""
    a, b = _operands(2, 2, 128, 64, 8)
    kw = dict(mask_batch=1, mask_heads=32, mask_sq=1024, mask_sk=1024,
              p=0.25, seed=5, block_m=128, block_n=8, block_k=64)
    fn, jfn = ((tg.gemm_with_rng_grouped, jg.gemm_with_rng_grouped)
               if dtype == "f32" else
               (tg.gemm_with_rng_grouped_fp8, jg.gemm_with_rng_grouped_fp8))
    y, mask = fn(torch.from_numpy(a), torch.from_numpy(b), **kw)
    jy, jmask = jfn(jnp.asarray(a), jnp.asarray(b), **kw)
    assert mask is None and jmask is None
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)
    np.testing.assert_allclose(y.numpy(), np.einsum("ecd,edf->ecf", a, b),
                               **C_TOL)


@pytest.mark.parametrize("dtype", ["f32", "fp8"])
def test_grouped_grads_equal_jax(dtype):
    """Gradients through both grouped hosts: JAX's per-expert dgrad pairs
    (f32; bf16-rounded operands for fp8) within 1e-4."""
    import jax
    a, b = _operands(3, 4, 256, 64, 128)
    kw = _kw((256, 128, 64), (2, 2, 128, 128), 2048)
    fn, jfn = ((tg.gemm_with_rng_grouped, jg.gemm_with_rng_grouped)
               if dtype == "f32" else
               (tg.gemm_with_rng_grouped_fp8, jg.gemm_with_rng_grouped_fp8))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y, _ = fn(ta, tb, **kw)
    da, db = torch.autograd.grad(y.square().sum(), (ta, tb))

    def loss(a_, b_):
        return jnp.sum(jnp.square(jfn(a_, b_, **kw)[0]))

    jda, jdb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD_TOL)


def test_grouped_checks_and_cpu_launches_nothing():
    """Shapes and dtypes the hosts do not take raise; CPU tensors take the
    plain versions (bf16 ones too, C in bf16) and launch no kernel."""
    reset_launch_counts()
    a = torch.zeros((2, 64, 32))
    kw = dict(mask_batch=1, mask_heads=1, mask_sq=32, mask_sk=32, p=0.1,
              seed=0)
    c16, _ = tg.gemm_with_rng_grouped(a.to(torch.bfloat16),
                                      a.transpose(1, 2).to(torch.bfloat16),
                                      **kw)
    assert c16.dtype == torch.bfloat16 and not c16.any()
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        tg.gemm_with_rng_grouped(a.half(), a.transpose(1, 2).half(), **kw)
    with pytest.raises(ValueError, match="grouped GEMM shapes"):
        tg.gemm_with_rng_grouped(a, a[:1].transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="do not tile"):
        tg.gemm_with_rng_grouped_fp8(a, a.transpose(1, 2), block_m=48, **kw)
    c, _ = ops.fused_gemm_rng_grouped_fp8(a, a.transpose(1, 2), **kw)
    assert c.shape == (2, 64, 64) and not c.any()
    # the grouped e4m3 kernel's operand check: raises before any launch,
    # with no fallback, on what the kernel cannot take
    blocks = (32, 64, 64)
    x, y = (torch.from_numpy(t) for t in _operands(9, 2, 64, 128, 64))
    kops = _kmajor_ops(x, y, blocks)
    check = tg._check_fp8_kmajor
    check(tg.KERNEL_GROUPED_FP8, *kops, blocks, groups=2)   # takes these
    with pytest.raises(ValueError, match="K-major"):         # 3 experts?
        check(tg.KERNEL_GROUPED_FP8, *kops, blocks, groups=3)
    with pytest.raises(ValueError, match="K-major"):         # JAX's b_s
        check(tg.KERNEL_GROUPED_FP8, *kops[:3],
              tg.quantize_grouped(x, y, blocks)[3], blocks, groups=2)
    with pytest.raises(ValueError, match="3-d"):
        check(tg.KERNEL_GROUPED_FP8, kops[0][0], kops[1], kops[2][0],
              kops[3], blocks, groups=2)
    x, y = (torch.from_numpy(t) for t in _operands(9, 2, 64, 88, 64))
    a_q, a_s, bt_q, bt_s = _kmajor_ops(x, y, (32, 64, 88))
    with pytest.raises(ValueError, match="multiple of 16"):  # unpadded rows
        check(tg.KERNEL_GROUPED_FP8, a_q, a_s, bt_q, bt_s, (32, 64, 88),
              groups=2)
    assert check(tg.KERNEL_GROUPED_FP8, tg.pad_k16(a_q), a_s,
                 tg.pad_k16(bt_q), bt_s, (32, 64, 88), groups=2) == 96
    # on CPU tensors the K-major entry is the plain version
    y8, _ = tg.gemm_rng_grouped_fp8_kmajor(*kops, blocks, None)
    x, y = (torch.from_numpy(t) for t in _operands(9, 2, 64, 128, 64))
    assert torch.equal(y8, tg.gemm_grouped_fp8_plain(
        *tg.quantize_grouped(x, y, blocks), blocks))
    assert set(launch_counts().values()) == {0}


# the grouped e4m3 kernel's decomposition at moonshot's capacity of 480
# rows (3.75 of the kernel's 128-row CTA tiles) with bm = 240 and bn = 176
# scale tiles cutting them: (E, C, K, N), (bm, bn, bk)
ORDER_CASES = [
    ((2, 480, 1032, 176), (240, 176, 344)),
    ((2, 480, 704, 176), (240, 176, 352)),
    ((2, 480, 1024, 176), (240, 176, 512)),
    ((2, 480, 128, 352), (240, 176, 64)),
]
ORDER_TOL = 1e-4   # as tests/test_torch_fp8.py: f32 sums in another order


def _kmajor_ops(x, y, blocks):
    """The grouped e4m3 kernel's operands: JAX's quantization, the weight's
    bytes and scales made K-major by ``kmajor_grouped``."""
    a_q, a_s, b_q, b_s = tg.quantize_grouped(x, y, blocks)
    return (a_q, a_s, *tg.kmajor_grouped(b_q, b_s, blocks))


def _expert_kernel_order(ops, blocks):
    """``gemm_fp8_kernel_order`` expert by expert on the K-major operands,
    each expert's scale rows from e * gm and e * gn, as the kernel reads
    them."""
    a_q, a_s, bt_q, bt_s = ops
    bm, bn, _ = blocks
    e, c, _ = a_q.shape
    gm, gn = c // bm, bt_q.shape[1] // bn
    return torch.stack([
        tg.gemm_fp8_kernel_order(a_q[i], a_s[i * gm:(i + 1) * gm], bt_q[i],
                                 bt_s[i * gn:(i + 1) * gn], blocks)
        for i in range(e)])


@pytest.mark.parametrize("dims,blocks", ORDER_CASES)
def test_grouped_kernel_order_equals_plain(dims, blocks):
    """The grouped e4m3 kernel's order of summation (k16 slices, straddling
    slices once per k-block with A's other bytes zeroed, one rescale per
    k-block) equals the plain version, JAX's order, within ORDER_TOL x
    (1 + |C|) at capacity 480."""
    a, b = _operands(sum(dims), *dims)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _expert_kernel_order(_kmajor_ops(ta, tb, blocks),
                               blocks)
    want = tg.gemm_grouped_fp8_plain(*tg.quantize_grouped(ta, tb, blocks),
                                     blocks)
    assert bool(((got - want).abs() <= ORDER_TOL * (1 + want.abs())).all())


@pytest.mark.parametrize("dims,blocks", [((3, 240, 96, 176), (80, 88, 32)),
                                         ((1, 256, 64, 384),
                                          (256, 128, 64)),
                                         ((2, 480, 1408, 176),
                                          (240, 176, 352))])
def test_grouped_kmajor_operands_are_transposes(dims, blocks):
    """The grouped kernel's weight operand: JAX's b_q and b_s made K-major
    by ``kmajor_grouped`` -- (E, N, K) bytes, (E * N / bn, K / bk) scales,
    contiguous -- is bitwise what quantizing the transposed weight (E * N,
    K) in (bn, bk) tiles gives: b_q.T and b_s.T expert by expert."""
    e, c, k, n = dims
    _, bn, bk = blocks
    a, b = _operands(7, *dims)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _, _, b_q, b_s = tg.quantize_grouped(ta, tb, blocks)
    bt_q, bt_s = tg.kmajor_grouped(b_q, b_s, blocks)
    assert bt_q.shape == (e, n, k) and bt_s.shape == (e * n // bn, k // bk)
    assert bt_q.is_contiguous() and bt_s.is_contiguous()
    want_q, want_s = quant.quantize_tiled(
        tb.transpose(1, 2).reshape(e * n, k), bn, bk)
    assert torch.equal(bt_q.reshape(e * n, k).view(torch.uint8),
                       want_q.contiguous().view(torch.uint8))
    assert torch.equal(bt_s, want_s)


@pytest.mark.gpu
def test_grouped_kernels_equal_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none on this machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    for i, ((e, c, k, n), blocks, plane, cols) in enumerate(GROUPED_CASES):
        a, b = (torch.from_numpy(t).cuda()
                for t in _operands(i, e, c, k, n))
        kw = _kw(blocks, plane, cols)
        for fn, plain in ((tg.gemm_with_rng_grouped,
                           tg.gemm_with_rng_grouped_plain),
                          (tg.gemm_with_rng_grouped_fp8,
                           tg.gemm_with_rng_grouped_fp8_plain)):
            y, mask = fn(a, b, **kw)
            want_y, want = plain(a, b, **kw)
            torch.cuda.synchronize()
            assert torch.equal(mask, want)
            torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    # capacity 480 (3.75 CTA rows an expert) with bm = 240, bn = 176 and
    # bk = 344 (straddling k16 slices): the e4m3 product only
    for dims, blocks in ORDER_CASES[:1] + [((4, 480, 1024, 352),
                                            (240, 176, 512))]:
        x, y = (torch.from_numpy(t).cuda() for t in _operands(1, *dims))
        kops = _kmajor_ops(x, y, blocks)
        c8, _ = tg.gemm_rng_grouped_fp8_kmajor(*kops, blocks, None)
        want8 = tg.gemm_grouped_fp8_plain(*tg.quantize_grouped(x, y, blocks),
                                          blocks)
        torch.cuda.synchronize()
        assert bool(((c8 - want8).abs() <= 1e-3 * (1 + want8.abs())).all())
    counts = launch_counts()
    assert counts.pop(tg.KERNEL_GROUPED) == len(GROUPED_CASES)
    assert counts.pop(tg.KERNEL_GROUPED_FP8) == len(GROUPED_CASES) + 2
    assert set(counts.values()) == {0}


# ------------------------------------------------------------ producer

@pytest.mark.parametrize("gemm_dtype", ["f32", "bf16", "fp8"])
def test_grouped_producer_bits_match_oracle(gemm_dtype):
    """The grouped producer's plane is the oracle's whatever dtype hosts the
    GEMM; y equals JAX's (f32; bf16: both round the operands to bf16 and C
    back to f32, within 3e-2) or is within the e4m3 bound (fp8)."""
    plan, jplan = _plans("ffn_up", gemm_dtype=gemm_dtype)
    e, c, d, f = 4, 256, 64, 128
    b, h, s = 2, 2, 128
    layer, step = 2, 7
    a3, b3 = _operands(4, e, c, d, f)
    # JAX judges the producer itself; the port runs the one it planned
    jy, jmask, jhow = jproducer.grouped_gemm_with_mask(
        jnp.asarray(a3), jnp.asarray(b3), jplan, (b, h, s, s), layer, step)
    assert jhow == producer.HOW_GEMM_GROUPED
    y, mask = producer.grouped_gemm_with_mask(
        torch.from_numpy(a3), torch.from_numpy(b3), plan, (b, h, s, s),
        layer, step, how=jhow)
    want = philox_mask_ref(b, h, s, s, P, int(jplan.step_seed(step)),
                           int(jplan.salt(layer)))
    np.testing.assert_array_equal(_u32(mask), np.asarray(want))
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **(
        dict(atol=3e-2, rtol=3e-2) if gemm_dtype == "bf16" else C_TOL))
    exact = np.einsum("ecd,edf->ecf", a3, b3)
    if gemm_dtype == "fp8":
        rel = np.linalg.norm(y.numpy() - exact) / np.linalg.norm(exact)
        assert rel < BOUND


@pytest.mark.parametrize("how", [None, producer.HOW_STANDALONE,
                                 producer.HOW_XLA])
def test_grouped_region3_falls_back_to_standalone(how):
    """A combined expert grid too small to hide the plane hands the bits to
    the standalone producer (as JAX judges it with ``how=None``, or as
    planned) -- the same bits; the tensor-op producer too. The port always
    runs the producer it is given: JAX's judgment here."""
    plan, jplan = _plans("ffn_up")
    e, c, d, f = 2, 128, 64, 8
    b, h, s = 1, 32, 1024
    a3, b3 = _operands(5, e, c, d, f)
    jy, jmask, jhow = jproducer.grouped_gemm_with_mask(
        jnp.asarray(a3), jnp.asarray(b3), jplan, (b, h, s, s), 1, 0, how=how)
    assert jhow == (how or producer.HOW_STANDALONE)
    y, mask = producer.grouped_gemm_with_mask(
        torch.from_numpy(a3), torch.from_numpy(b3), plan, (b, h, s, s), 1, 0,
        how=jhow)
    want = philox_mask_ref(b, h, s, s, P, int(jplan.step_seed(0)),
                           int(jplan.salt(1)))
    np.testing.assert_array_equal(_u32(mask), np.asarray(want))
    np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)


def test_grouped_seeded_region3_and_untileable():
    """``grouped_gemm_seeded`` (the MoE dispatch's entry) runs the plan or
    raises. A Region-3 grid planned standalone gives JAX's bits (JAX
    judges it standalone itself). A ``gemm_rng_grouped`` plan on that grid
    raises, where JAX degrades; so does either plan on an untileable
    capacity, where JAX takes the tensor-op product -- never a library GEMM
    in the kernel's place."""
    plan, jplan = _plans("ffn_up")
    seed, salt = plan.step_seed(3), plan.salt(2)
    jseed = jnp.asarray(jplan.step_seed(3), jnp.uint32)
    jsalt = jnp.asarray(jplan.salt(2), jnp.uint32)
    region3 = ((2, 128, 64, 8), (1, 32, 1024, 1024))
    untileable = ((3, 11, 64, 128), (1, 2, 64, 64))
    for (e, c, d, f), shape in (region3, untileable):
        a3, b3 = (torch.from_numpy(t) for t in _operands(6, e, c, d, f))
        jy, jmask, jhow = jproducer.grouped_gemm_seeded(
            jnp.asarray(a3.numpy()), jnp.asarray(b3.numpy()), jplan, shape,
            jseed, jsalt)
        assert jhow == producer.HOW_STANDALONE
        if (e, c, d, f) == region3[0]:
            y, mask = producer.grouped_gemm_seeded(
                a3, b3, plan, shape, seed, salt, producer.HOW_STANDALONE)
            np.testing.assert_array_equal(_u32(mask), np.asarray(jmask))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **C_TOL)
            with pytest.raises(RuntimeError, match="Region 3"):
                producer.grouped_gemm_seeded(
                    a3, b3, plan, shape, seed, salt,
                    producer.HOW_GEMM_GROUPED)
        else:
            for how in (producer.HOW_GEMM_GROUPED, producer.HOW_STANDALONE):
                with pytest.raises(ValueError, match="does not tile"):
                    producer.grouped_gemm_seeded(a3, b3, plan, shape, seed,
                                                 salt, how)
    with pytest.raises(ValueError, match="no grouped producer"):
        producer.grouped_gemm_seeded(a3, b3, plan, shape, seed, salt,
                                     producer.HOW_GEMM)


def test_grouped_grads_flow_through_producer():
    """Gradients flow through the planned grouped host (the plane gets
    none) and equal the plain einsum's."""
    plan, _ = _plans("ffn_up")
    a3, b3 = (torch.from_numpy(t).requires_grad_()
              for t in _operands(7, 4, 256, 64, 128))

    def grads(hosted):
        if hosted:
            y, _ = producer.grouped_gemm_with_mask(
                a3, b3, plan, (2, 2, 128, 128), 1, 0,
                how=producer.HOW_GEMM_GROUPED)
        else:
            y = torch.einsum("ecd,edf->ecf", a3, b3)
        return torch.autograd.grad(y.square().sum(), (a3, b3))

    for got, want in zip(grads(True), grads(False)):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_capacity_and_host_shapes_equal_jax():
    for arch in ("moonshot-v1-16b-a3b", "arctic-480b", "rwkv6-7b"):
        for reduced in (True, False):
            cfg = get_arch(arch, reduced=reduced)
            jcfg = j_get_arch(arch, reduced=reduced)
            for batch, seq in ((2, 128), (2, 2048), (1, 4096)):
                assert producer.grouped_host_shapes(cfg, batch, seq) == \
                    jproducer.grouped_host_shapes(jcfg, batch, seq)
                if cfg.moe is not None:
                    assert producer.moe_expert_capacity(
                        cfg.moe, batch * seq) == \
                        jproducer.moe_expert_capacity(jcfg.moe, batch * seq)
    full = get_arch("moonshot-v1-16b-a3b")
    assert producer.grouped_host_shapes(full, 2, 2048) == {
        "ffn_up": (64, 480, 2048, 1408), "ffn_down": (64, 480, 1408, 2048)}
    assert producer.grouped_layout_feasible(64, 480, 2048, 1408, 2, 16,
                                            2048, 2048) == \
        (True, (240, 176, 512))


# ------------------------------------------------------------ schedule

def _moe_cfgs(**kw):
    """(dense, moe, moe) stack: test_grouped_host.py's config in both
    packages."""
    moe = kw.pop("moe", dict(n_experts=4, top_k=2, d_ff_expert=128,
                             first_dense_layers=1, capacity_factor=2.0))
    ffn = kw.pop("ffn", "swiglu")
    base = dict(name="dmm", family="moe", n_layers=3, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=64,
                head_dim=32, attn_dropout=P)
    base.update(kw)
    return (JModelConfig(block_pattern=(JAttentionKind.FULL,),
                         ffn=JFFNKind(ffn), moe=JMoEConfig(**moe), **base),
            ModelConfig(block_pattern=(AttentionKind.FULL,),
                        ffn=FFNKind(ffn), moe=MoEConfig(**moe), **base))


def _hybrid_cfgs(**kw):
    """(WKV, FULL) hybrid with RWKV channel-mix FFNs."""
    base = dict(name="rwkv-hyb", family="hybrid", n_layers=4, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=64,
                head_dim=32, rwkv_head_dim=32, attn_dropout=P)
    base.update(kw)
    return (JModelConfig(block_pattern=(JAttentionKind.WKV,
                                        JAttentionKind.FULL),
                         ffn=JFFNKind.RWKV_CHANNEL, **base),
            ModelConfig(block_pattern=(AttentionKind.WKV,
                                       AttentionKind.FULL),
                        ffn=FFNKind.RWKV_CHANNEL, **base))


def _assert_same_schedule(jcfg, cfg, site, batch, seq, **kw):
    want = j_compile(jcfg, JPlanConfig(**_plan_kw(site, **kw)), batch, seq,
                     attn_impl="pallas")
    got = compile_schedule(cfg, DropoutPlanConfig(**_plan_kw(site, **kw)),
                           batch, seq, attn_impl="pallas")
    assert got.explain() == want.explain()
    assert got.records() == want.records()
    assert got.summary() == want.summary()
    return got


SCHED_MODELS = {
    "moonshot": lambda: (j_get_arch("moonshot-v1-16b-a3b", reduced=True),
                         get_arch("moonshot-v1-16b-a3b", reduced=True)),
    "arctic": lambda: (j_get_arch("arctic-480b", reduced=True),
                       get_arch("arctic-480b", reduced=True)),
    "hybrid": _hybrid_cfgs,
    "dmm": _moe_cfgs,
}


@pytest.mark.parametrize("model", sorted(SCHED_MODELS))
@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("replay", ["auto", "off"])
def test_schedule_text_equals_jax(model, site, dtype, replay):
    jcfg, cfg = SCHED_MODELS[model]()
    for batch, seq in ((2, 128), (1, 64), (2, 2048)):
        _assert_same_schedule(jcfg, cfg, site, batch, seq, gemm_dtype=dtype,
                              attn_replay=replay)


def test_full_moonshot_schedule_equals_jax():
    """moonshot-v1-16b-a3b at full width, 4 layers, B=2, S=2048: L0 dense
    emits through the dense host, L1-L3 through the grouped one."""
    jcfg = dataclasses.replace(j_get_arch("moonshot-v1-16b-a3b"),
                               n_layers=4)
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"), n_layers=4)
    for site in ("ffn_up", "ffn_down"):
        for dtype in ("f32", "fp8"):
            got = _assert_same_schedule(jcfg, cfg, site, 2, 2048,
                                        gemm_dtype=dtype, attn_replay="off")
            assert [a.emit_how for a in got.assignments] == [
                producer.HOW_GEMM] + [producer.HOW_GEMM_GROUPED] * 3


@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
def test_moe_stack_plans_grouped_hosts(site):
    """The dense block emits under the dense kernel, the MoE blocks under
    the grouped one; only the bootstrap is standalone."""
    jcfg, cfg = _moe_cfgs()
    sched = _assert_same_schedule(jcfg, cfg, site, 2, 128,
                                  attn_replay="off")
    emits = [(a.emit_how, a.emit_reason) for a in sched.assignments
             if a.emit_site]
    assert emits == [(producer.HOW_GEMM, ""),
                     (producer.HOW_GEMM_GROUPED, ""),
                     (producer.HOW_GEMM_GROUPED, "")], sched.explain()
    for a in sched.assignments:
        if a.consumes and a.producer >= 0:
            assert a.how in (producer.HOW_GEMM, producer.HOW_GEMM_GROUPED)


@pytest.mark.parametrize("site", ["ffn_up", "ffn_down"])
def test_rwkv_hybrid_plans_grouped_hosts(site):
    jcfg, cfg = _hybrid_cfgs()
    sched = _assert_same_schedule(jcfg, cfg, site, 2, 128)
    emits = [a for a in sched.assignments if a.emit_site]
    assert emits
    assert {(a.emit_how, a.emit_reason) for a in emits} == {
        (producer.HOW_GEMM_GROUPED, "")}, sched.explain()


def test_infeasible_grouped_shapes_report_distinct_reasons():
    """An untileable capacity (MoE expert), an untileable channel-mix width
    (RWKV channel-mix) and a Region-3 expert grid each give JAX's reason,
    naming the block kind, in the same explain() text."""
    jcfg, cfg = _moe_cfgs(n_layers=2, moe=dict(
        n_experts=6, top_k=1, d_ff_expert=128, first_dense_layers=0,
        capacity_factor=1.0))
    sched = _assert_same_schedule(jcfg, cfg, "ffn_up", 1, 64)
    reasons = {a.emit_reason for a in sched.assignments if a.emit_site}
    assert any("MoE expert" in r and "does not tile" in r for r in reasons)
    jh, h = _hybrid_cfgs(d_ff=12)
    sched_h = _assert_same_schedule(jh, h, "ffn_up", 1, 64)
    reasons_h = {a.emit_reason for a in sched_h.assignments if a.emit_site}
    assert any("RWKV channel-mix" in r and "does not tile" in r
               for r in reasons_h)
    assert reasons.isdisjoint(reasons_h)
    jr3, r3 = _moe_cfgs(n_layers=2, n_heads=32, n_kv_heads=32, head_dim=2,
                        moe=dict(n_experts=2, top_k=1, d_ff_expert=8,
                                 first_dense_layers=0,
                                 capacity_factor=0.25))
    sched_r3 = _assert_same_schedule(jr3, r3, "ffn_up", 1, 1024,
                                     attn_replay="off")
    assert any("Region 3" in r and "MoE expert" in r
               for r in {a.emit_reason for a in sched_r3.assignments
                         if a.emit_site})


def test_first_dense_channel_mix_plans_on_its_own_grid():
    """A MoE stack whose first-dense layer carries an RWKV channel-mix FFN
    plans that layer on the E=1 grid, with the RWKV reason where it cannot
    host."""
    jcfg, cfg = _moe_cfgs(ffn="rwkv_channel")
    sched = _assert_same_schedule(jcfg, cfg, "ffn_up", 2, 128,
                                  attn_replay="off")
    emits = {a.layer: a for a in sched.assignments if a.emit_site}
    assert emits[0].emit_how == emits[1].emit_how == \
        producer.HOW_GEMM_GROUPED
    jbad, bad = _moe_cfgs(ffn="rwkv_channel", d_ff=12)
    sched_b = _assert_same_schedule(jbad, bad, "ffn_up", 2, 128,
                                    attn_replay="off")
    emits_b = {a.layer: a for a in sched_b.assignments if a.emit_site}
    assert "RWKV channel-mix" in emits_b[0].emit_reason
    assert emits_b[1].emit_reason == ""


def _abstract_policies(shape=(2, 2), axes=("data", "model")):
    """The port's and JAX's ShardingPolicy on a device-free mesh of
    ``shape`` (the schedule's planning reads only axis names and sizes)."""
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.distributed.sharding import ShardingPolicy as JPolicy
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import AbstractMesh
    return (ShardingPolicy(AbstractMesh(shape, axes)),
            JPolicy(JAbstractMesh(shape, axes)))


def test_grouped_bf16_plan_raises():
    """A grouped bf16 plan plans (its text is JAX's:
    ``test_schedule_text_equals_jax[bf16]``), ``site="auto"`` included
    since the perf model is ported (its text JAX's at the same hardware);
    under a sharding policy (it raised before multi-device was ported) its
    shard-local plan is JAX's too."""
    jcfg, cfg = _moe_cfgs()
    kw = _plan_kw("auto", gemm_dtype="bf16")
    assert compile_schedule(
        cfg, DropoutPlanConfig(**kw), 2, 128, attn_impl="pallas",
        hw=GH100).explain() == j_compile(
        jcfg, JPlanConfig(**kw), 2, 128, attn_impl="pallas",
        hw=J_GH100).explain()
    pol, jpol = _abstract_policies()
    kw = _plan_kw("ffn_up", gemm_dtype="bf16")
    got = compile_schedule(cfg, DropoutPlanConfig(**kw), 2, 128,
                           policy=pol, attn_impl="pallas")
    assert got.sharded and got.explain() == j_compile(
        jcfg, JPlanConfig(**kw), 2, 128, policy=jpol,
        attn_impl="pallas").explain()
