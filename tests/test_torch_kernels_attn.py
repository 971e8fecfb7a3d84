"""The fused GEMM+RNG and flash-attention kernels of the port against the
JAX package: keep bits, packed rows, emission layouts and GEMM+RNG planes
bitwise (Region 3 included); flash forward (with lse) and backward at the
JAX tests' tolerances, 2e-5 and 1e-4, in every dropout mode, causal, with
a local window and with GQA 2:1. Inputs are made with numpy from a seed
and handed to both; the JAX kernels run in Pallas interpret mode on the
CPU, the port's wrappers take their plain versions there.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_attn.py

The ``gpu``-marked test holds each CUDA kernel against its plain version
on the card and skips here.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm_rng as jg
from repro.kernels import philox_common as jpc
from repro.kernels import ref as jref
from repro.kernels.ref import philox_mask_ref
from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels import flash_attention_bwd as tb
from repro_torch.kernels import gemm_rng as tg
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import philox_common as tpc
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import fused_qkv_gemm_rng
from repro_torch.kernels.philox import philox_dropout_mask_plain

# ``repro.kernels`` exports a function named flash_attention, which
# shadows the submodule of that name as an attribute
jf = importlib.import_module("repro.kernels.flash_attention")
jfb = importlib.import_module("repro.kernels.flash_attention_bwd")

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------------ bits

@pytest.mark.parametrize("rounds", [3, 7, 10])
def test_tile_and_packed_row_bits_equal_jax(rounds):
    thr = tpc.threshold_from_p(0.1)
    got = tpc.tile_keep_mask(36, 5, 7, 99, 2 ** 31 + 3, 17, thr, 24, 40,
                             rounds)
    want = jpc.tile_keep_mask(36, 5, 7, 99, 2 ** 31 + 3, 17, thr, 24, 40,
                              rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpc.tile_random_u32(8, 0, 3, 1, 2, 5, 16, 12, rounds).numpy(),
        np.asarray(jpc.tile_random_u32(8, 0, 3, 1, 2, 5, 16, 12, rounds))
        .astype(np.int64))
    # rows crossing (b, h) boundaries, whole-plane and shard-local maps
    for hl, hg, off in ((0, 0, 0), (2, 6, 7)):
        got = tpc.packed_rows_tile(5, 3, 3, 77, 11, 12, thr, 10, 40, rounds,
                                   heads_local=hl, heads_global=hg,
                                   bh_offset=off)
        want = jpc.packed_rows_tile(5, 3, 3, 77, 11, 12, thr, 10, 40, rounds,
                                    heads_local=hl, heads_global=hg,
                                    bh_offset=off)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    bits = np.random.default_rng(rounds).random((64, 9)) < 0.3
    packed = tpc.pack_bits_q32(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpc.pack_bits_q32(jnp.asarray(bits)))
        .astype(np.int64))
    np.testing.assert_array_equal(
        tpc.unpack_bits_q32(tpc.to_int32_bits(packed), 64).numpy(), bits)
    np.testing.assert_array_equal(
        _u32(tpc.seed_salt_smem(torch.tensor(2 ** 33 + 5), 7, 3)),
        np.asarray(jpc.seed_salt_smem(jnp.uint32(5), 7, 3)))
    np.testing.assert_array_equal(
        _u32(tpc.seed_salt_smem(2 ** 33 + 5, 7)),
        np.asarray(jpc.seed_salt_smem(2 ** 33 + 5, 7)))


def test_ref_oracles_equal_jax():
    np.testing.assert_array_equal(
        _u32(tref.philox_mask_ref(2, 3, 64, 40, 0.2, 2 ** 32 + 9, 4)),
        np.asarray(philox_mask_ref(2, 3, 64, 40, 0.2, 2 ** 32 + 9, 4)))
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal(s).astype(np.float32)
            for s in ((48, 16), (16, 24)))
    tc, tm = tref.gemm_rng_ref(torch.from_numpy(a), torch.from_numpy(b), 1,
                               2, 32, 24, 0.1, 7, 3)
    jc, jm = jref.gemm_rng_ref(jnp.asarray(a), jnp.asarray(b), 1, 2, 32, 24,
                               0.1, 7, 3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(_u32(tm), np.asarray(jm))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 32, 8), (1, 2, 48, 8), (1, 2, 48, 8)))
    kw = dict(causal=True, dropout_p=0.1, dropout_seed=5, dropout_salt=2,
              local_window=20)
    np.testing.assert_allclose(
        tref.attention_ref(*map(torch.from_numpy, (q, k, v)), **kw).numpy(),
        np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)), **kw)),
        **FWD_TOL)


# (m, n, k, blocks, mask (b, h, s), heads_global, bh_offset); the last case
# is Region 3 (a 1-step grid cannot host 1024 packed rows)
GEMM_CASES = [
    (256, 192, 64, (128, 192, 64), (2, 4, 128), 0, 0),
    (512, 384, 64, (256, 128, 64), (2, 8, 256), 0, 0),
    (256, 384, 96, (128, 128, 32), (1, 4, 128), 8, 12),
    (256, 768, 64, (256, 256, 64), (1, 128, 256), 0, 0),
]


@pytest.mark.parametrize("case", GEMM_CASES)
def test_gemm_rng_plane_and_layout_equal_jax(case):
    m, n, k, (bm, bn, bk), (mb, mh, sq), hg, off = case
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sq, p=0.1,
              rounds=7, block_m=bm, block_n=bn, block_k=bk,
              mask_block_cols=2048, heads_global=hg)
    jc, jm = jg.gemm_with_rng(jnp.asarray(a), jnp.asarray(b),
                              seed=jnp.uint32(77), salt=jnp.uint32(5),
                              bh_offset=jnp.uint32(off), interpret=True,
                              **kw)
    tc, tm = tg.gemm_with_rng(torch.from_numpy(a), torch.from_numpy(b),
                              seed=torch.tensor(77), salt=5, bh_offset=off,
                              **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4,
                               rtol=1e-5)
    n_steps = (m // bm) * (n // bn)
    jlay = jg.mask_emission_layout(n_steps, mb, mh, sq, sq)
    tlay = tg.mask_emission_layout(n_steps, mb, mh, sq, sq)
    assert tg.mask_layout_feasible(n_steps, mb, mh, sq, sq) == \
        jg.mask_layout_feasible(n_steps, mb, mh, sq, sq)
    if jm is None:
        assert tm is None and tlay is None and jlay is None
        return
    assert list(tlay.blocks()) == list(jlay.blocks())
    assert tlay.rows_alloc == jlay.rows_alloc
    np.testing.assert_array_equal(_u32(tm), np.asarray(jm))


def test_gemm_rng_grads_are_the_dgrad_pair():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((128, 64)).astype(np.float32)
    b = rng.standard_normal((64, 192)).astype(np.float32)
    g = rng.standard_normal((128, 192)).astype(np.float32)
    ta, tbw = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    c, mask = fused_qkv_gemm_rng(ta, tbw, mask_batch=1, mask_heads=2,
                                 mask_sq=64, mask_sk=64, p=0.1, seed=3,
                                 block_m=128, block_n=192, block_k=64)
    assert not mask.requires_grad
    c.backward(torch.from_numpy(g))

    def f(a_, b_):
        return jg.gemm_with_rng(a_, b_, mask_batch=1, mask_heads=2,
                                mask_sq=64, mask_sk=64, p=0.1, seed=3,
                                block_m=128, block_n=192, block_k=64,
                                interpret=True)[0]

    _, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(da), **GRAD_TOL)
    np.testing.assert_allclose(tbw.grad.numpy(), np.asarray(db), **GRAD_TOL)


# ----------------------------------------------------------------- flash

B, S, D = 2, 128, 16


def _flash_inputs(heads, kv_heads, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, heads, S, D)).astype(np.float32)
    k = rng.standard_normal((B, kv_heads, S, D)).astype(np.float32)
    v = rng.standard_normal((B, kv_heads, S, D)).astype(np.float32)
    g = rng.standard_normal((B, heads, S, D)).astype(np.float32)
    return q, k, v, g


def _operands(mode, heads):
    """The JAX and the port operand of the mask slot for ``mode``."""
    if mode == "premask":
        plane = philox_mask_ref(B, heads, S, S, 0.1, seed=9, salt=3)
        return plane, torch.from_numpy(np.array(plane).view(np.int32))
    if mode == "replay":
        return (jpc.seed_salt_smem(jnp.uint32(9), jnp.uint32(3)),
                tpc.seed_salt_smem(torch.tensor(9), 3))
    return None, None


@pytest.mark.parametrize("mode,local,kv_heads", [
    ("none", 0, 4), ("fused", 0, 4), ("premask", 0, 4), ("replay", 0, 4),
    ("replay", 48, 4), ("premask", 0, 2), ("replay", 0, 2)])
def test_flash_fwd_bwd_equal_jax(mode, local, kv_heads):
    heads = 4
    q, k, v, g = _flash_inputs(heads, kv_heads, hash((mode, local)) % 97)
    jm, tm = _operands(mode, heads)
    args = (True, local, 0.1, mode, 9, 3, 7)

    def f(q_, k_, v_):
        return jf.flash_attention_mosaic(q_, k_, v_, jm, *args, 128, 128,
                                         True, 0)

    jo, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(g))
    _, jlse = jf.flash_attention_fwd(
        *map(jnp.asarray, (q, k, v)), jm, causal=True, local_window=local,
        dropout_p=0.1, mode=mode, seed=9, salt=3, return_lse=True)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = tf.flash_attention_mosaic(tq, tk, tv, tm, *args, 0)
    to.backward(torch.from_numpy(g))
    _, tlse = tf.flash_attention_fwd(
        tq.detach(), tk.detach(), tv.detach(), tm, causal=True,
        local_window=local, dropout_p=0.1, mode=mode, seed=9, salt=3,
        return_lse=True)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)
    for got, want in ((tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_replay_equals_premask_and_plane_bitwise():
    """The replayed keep plane is the unpacked producer plane, and the two
    modes give identical outputs and gradients."""
    heads = 4
    jsd, tsd = _operands("replay", heads)
    got = tf.replay_keep_plane(tsd, B, heads, S, S, 0.1)
    want = jf.replay_keep_plane(jsd, B, heads, S, S, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plane = philox_dropout_mask_plain(B, heads, S, S, 0.1, torch.tensor(9),
                                      3, device="cpu")
    assert torch.equal(
        got, tpc.unpack_bits_q32(plane.reshape(-1, S), B * heads * S)
        .reshape(B, heads, S, S))
    q, k, v, g = _flash_inputs(heads, 4, 5)
    outs = []
    for mode, op in (("replay", tsd), ("premask", plane)):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = tf.flash_attention_mosaic(tq, tk, tv, op, True, 0, 0.1, mode)
        o.backward(torch.from_numpy(g))
        outs.append([o.detach(), tq.grad, tk.grad, tv.grad])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_flash_bwd_kernel_formulas_equal_jax_bwd():
    """flash_attention_bwd against the JAX package's Pallas backward on the
    same (o, lse, do)."""
    heads = 4
    q, k, v, g = _flash_inputs(heads, 2, 11)
    jm, tm = _operands("premask", heads)
    jo, jlse = jf.flash_attention_fwd(
        *map(jnp.asarray, (q, k, v)), jm, causal=True, dropout_p=0.1,
        mode="premask", return_lse=True)
    want = jfb.flash_attention_bwd(
        *map(jnp.asarray, (q, k, v)), jo, jlse, jnp.asarray(g), jm,
        causal=True, dropout_p=0.1, mode="premask")
    got = tb.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse)),
        torch.from_numpy(g), tm, causal=True, dropout_p=0.1, mode="premask")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_operands_are_checked_and_cpu_launches_nothing():
    reset_launch_counts()
    q = torch.zeros((1, 2, 64, 16))
    with pytest.raises(ValueError, match="premask"):
        tf.flash_attention_fwd(q, q, q, torch.zeros((1, 2, 2, 64)),
                               dropout_p=0.1, mode="premask")
    with pytest.raises(ValueError, match="replay mode takes"):
        tf.flash_attention_fwd(q, q, q, torch.zeros(4, dtype=torch.int64),
                               dropout_p=0.1, mode="replay")
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        tg.gemm_with_rng(torch.zeros((64, 32), dtype=torch.float16),
                         torch.zeros((32, 64), dtype=torch.float16),
                         mask_batch=1, mask_heads=1, mask_sq=32, mask_sk=32,
                         p=0.1, seed=0)
    with pytest.raises(NotImplementedError, match="f32 or bf16"):
        tf.check_kernel_shapes(q.half(), q.half(), q.half())
    tf.flash_attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16())
    tf.flash_attention_fwd(q, q, q, dropout_p=0.1, mode="fused")
    tg.gemm_with_rng(torch.zeros((64, 32)), torch.zeros((32, 64)),
                     mask_batch=1, mask_heads=1, mask_sq=32, mask_sk=32,
                     p=0.1, seed=0)
    assert set(launch_counts().values()) == {0}


@pytest.mark.gpu
def test_kernels_equal_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none on this machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((512, 64), generator=gen, device="cuda")
    w = torch.randn((64, 192), generator=gen, device="cuda")
    kw = dict(mask_batch=2, mask_heads=4, mask_sq=256, mask_sk=256, p=0.1,
              seed=torch.tensor(7), salt=3, block_m=256, block_n=192,
              block_k=64)
    c, mask = tg.gemm_with_rng(a, w, **kw)
    want_c, want = tg.gemm_with_rng_plain(a, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(mask, want)
    torch.testing.assert_close(c, want_c, atol=1e-4, rtol=1e-4)
    q = torch.randn((2, 4, 256, 16), generator=gen, device="cuda")
    kv = torch.randn((2, 2, 256, 16), generator=gen, device="cuda")
    do = torch.randn((2, 4, 256, 16), generator=gen, device="cuda")
    sd = tpc.seed_salt_smem(torch.tensor(9), 3)
    kw = dict(causal=True, dropout_p=0.1, mode="replay")
    o, lse = tf.flash_attention_fwd(q, kv, kv, sd, return_lse=True, **kw)
    po, plse = tf.flash_attention_fwd_plain(q, kv, kv, sd, **kw)
    grads = tb.flash_attention_bwd(q, kv, kv, o, lse, do, sd, **kw)
    pdq, pdk, pdv = tb.flash_attention_bwd_plain(q, kv, kv, po, plse, do, sd,
                                                 **kw)
    pdk, pdv = (t.reshape(2, 2, 2, 256, 16).sum(2) for t in (pdk, pdv))
    torch.cuda.synchronize()
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, (pdq, pdk, pdv)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    counts = launch_counts()
    for name in ("gemm_rng", "flash_fwd", "flash_dq", "flash_dkv"):
        assert counts.pop(name) == 1
    assert set(counts.values()) == {0}
