"""The port's Philox bits, packed planes, salts, step seeds and mask keys
against the JAX package, bitwise. Inputs are made with numpy from a seed
and handed to both; the JAX kernel runs in Pallas interpret mode on the
CPU, the port's wrapper takes its plain version there.

    PYTHONPATH=src python -m pytest -q tests/test_torch_philox.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core import dropout_rng as jrng
from repro.core.overlap import DropoutPlan as JPlan
from repro.core.schedule import compile_schedule as j_compile
from repro.kernels import philox_common as jpc
from repro.kernels.philox import philox_dropout_mask as j_kernel
from repro.kernels.ref import philox_mask_ref
from repro.config import get_arch as j_get_arch
from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core import dropout_rng
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.producer import (
    mask_kernel_unsupported_reason,
    standalone_packed_mask,
)
from repro_torch.core.schedule import compile_schedule
from repro_torch.kernels import launch_counts, philox, reset_launch_counts
from repro_torch.kernels import philox_common as tpc
from repro_torch.kernels.ops import dropout_mask


def _u32(t: torch.Tensor) -> np.ndarray:
    """An int32 plane of the port as the uint32 words JAX holds."""
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("rounds", [3, 5, 7, 10])
def test_philox4x32_bitwise_vs_jax(rounds):
    rng = np.random.default_rng(rounds)
    ctr = [rng.integers(0, 2 ** 32, 257, dtype=np.uint64).astype(np.uint32)
           for _ in range(4)]
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    want = jpc.philox4x32(*[jnp.asarray(c) for c in ctr],
                          jnp.uint32(key[0]), jnp.uint32(key[1]), rounds)
    got = tpc.philox4x32(*[torch.from_numpy(c.astype(np.int64)) for c in ctr],
                         int(key[0]), int(key[1]), rounds)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())
    # Python-int inputs take the same path exactly
    scalar = tpc.philox4x32(*[int(c[0]) for c in ctr], int(key[0]),
                            int(key[1]), rounds)
    assert scalar == tuple(int(np.asarray(w)[0]) for w in want)


def test_seed_split_both_branches():
    big = 2 ** 40 + 12345
    assert tpc.split_seed(big) == jpc.seed_to_key(big) == (12345, 256)
    # array seeds key with key_hi = 0, as JAX's traced seeds do
    k0, k1 = jpc.split_seed(jnp.asarray(big & 0xFFFFFFFF, jnp.uint32))
    assert tpc.split_seed(torch.tensor(big)) == (int(k0), int(k1)) \
        == (12345, 0)
    for p in (0.0, 0.1, 0.5, 0.999, 1.0):
        assert tpc.threshold_from_p(p) == jpc.threshold_from_p(p)
    for step, seed in ((0, 7), (3, 2 ** 33 + 1), (2 ** 20, 0x7FFFFFFF)):
        assert tpc.fold_step_seed(step, seed) == jpc.fold_step_seed(step,
                                                                    seed)
    for layer in (0, 1, 31, 5000):
        assert tpc.fold_layer_salt(layer, 3) == jpc.fold_layer_salt(layer, 3)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_plain_plane_bitwise_vs_ref_and_pallas(p):
    """Python-int seeds above 2**32 (full 64-bit key)."""
    b, h, sq, sk = 2, 3, 64, 160
    seed = 2 ** 32 + 977 + int(p * 1000)
    got = dropout_mask(b, h, sq, sk, p, seed, salt=5, rounds=7,
                       device="cpu")
    assert got.dtype == torch.int32 and got.shape == (b, h, sq // 32, sk)
    want = np.asarray(philox_mask_ref(b, h, sq, sk, p, seed, salt=5,
                                      rounds=7))
    np.testing.assert_array_equal(_u32(got), want)
    pallas = np.asarray(j_kernel(b, h, sq, sk, p, seed, salt=5, rounds=7,
                                 rows32_blk=1, bk=32, interpret=True))
    np.testing.assert_array_equal(_u32(got), pallas)


@pytest.mark.parametrize("rounds", [3, 10])
def test_array_seed_plane_bitwise_vs_pallas(rounds):
    """0-d tensor seeds key with key_hi = 0, like JAX's array seeds."""
    seed = 0xDEADBEEF
    got = dropout_mask(1, 2, 32, 96, 0.1, torch.tensor(seed), salt=11,
                       rounds=rounds, device="cpu")
    want = np.asarray(j_kernel(1, 2, 32, 96, 0.1, jnp.uint32(seed),
                               salt=11, rounds=rounds, rows32_blk=1, bk=32,
                               interpret=True))
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("window", [(1, 4, 8, 12), (2, 2, 4, 2)])
def test_shard_window_plane_bitwise_vs_pallas(window):
    """heads_global/bh_offset tiles equal JAX's shard-local call and the
    slice of the whole plane."""
    b_loc, h_loc, h_glob, off = window
    sq, sk, seed = 64, 64, 2 ** 35 + 3
    got = dropout_mask(b_loc, h_loc, sq, sk, 0.2, seed, salt=9,
                       heads_global=h_glob, bh_offset=off, device="cpu")
    want = np.asarray(j_kernel(b_loc, h_loc, sq, sk, 0.2, seed, salt=9,
                               rows32_blk=1, bk=32, interpret=True,
                               heads_global=h_glob, bh_offset=off))
    np.testing.assert_array_equal(_u32(got), want)
    whole = _u32(dropout_mask(2, h_glob, sq, sk, 0.2, seed, salt=9,
                              device="cpu")).reshape(2 * h_glob, sq // 32, sk)
    rows = [off + lb * h_glob + lh for lb in range(b_loc)
            for lh in range(h_loc)]
    np.testing.assert_array_equal(
        _u32(got).reshape(b_loc * h_loc, sq // 32, sk), whole[rows])


@pytest.mark.parametrize("bits", [8, 32])
def test_dropout_rng_packed_mask_bitwise_vs_jax(bits):
    seed = 0x1234567
    got = dropout_rng.packed_mask(2, 2, 64, 96, 0.3, torch.tensor(seed), 17,
                                  rounds=5, bits=bits, device="cpu")
    want = np.asarray(jrng.packed_mask(2, 2, 64, 96, 0.3,
                                       jnp.uint32(seed), jnp.uint32(17),
                                       rounds=5, bits=bits))
    np.testing.assert_array_equal(_u32(got), want)
    keep = dropout_rng.keep_mask_block(2, 2, 32, 32, 96, 0.3,
                                       torch.tensor(seed), 17, 5, bits,
                                       device="cpu")
    jkeep = np.asarray(jrng.keep_mask_block(2, 2, 32, 32, 96, 0.3,
                                            jnp.uint32(seed),
                                            jnp.uint32(17), 5, bits))
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(
        dropout_rng.unpack_block(got, 64).numpy(),
        np.asarray(jrng.unpack_block(jnp.asarray(want), 64)))


@pytest.mark.parametrize("seed,layer,step", [(0, 0, 0), (7, 3, 1),
                                             (0x7FFFFFFF, 31, 12345),
                                             (2 ** 33 + 9, 2, 2 ** 31 + 5)])
def test_plan_salt_step_seed_and_mask_key_vs_jax(seed, layer, step):
    tplan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1, seed=seed))
    jplan = JPlan(JPlanConfig(mode="overlap", p=0.1, seed=seed))
    assert int(tplan.salt(layer)) == int(jplan.salt(layer))
    assert int(tplan.step_seed(step)) == int(jplan.step_seed(step))
    cfg, jcfg = get_arch("yi-6b", reduced=True), j_get_arch(
        "yi-6b", reduced=True)
    tsched = compile_schedule(cfg, tplan.cfg, 1, 64)
    jsched = j_compile(jcfg, jplan.cfg, 1, 64)
    assert tsched.mask_key(layer, step) == jsched.mask_key(layer, step)
    assert [(a.consumes, a.site, a.how) for a in tsched.assignments] == \
        [(a.consumes, a.site, a.how) for a in jsched.assignments]


def test_standalone_producer_bits_and_unsupported_reason():
    """The standalone producer equals JAX's for both Philox widths, and the
    capability predicate is JAX's verbatim."""
    for bits in (8, 32):
        tplan = DropoutPlan(DropoutPlanConfig(mode="overlap", p=0.1, seed=3,
                                              philox_bits=bits))
        jplan = JPlan(JPlanConfig(mode="overlap", p=0.1, seed=3,
                                  philox_bits=bits))
        got = standalone_packed_mask(tplan, 1, 4, 96, 96, 2, 5,
                                     device="cpu")
        want = jrng.packed_mask(1, 4, 96, 96, 0.1, jplan.step_seed(5),
                                jplan.salt(2), 7, bits)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    from repro.core.producer import \
        mask_kernel_unsupported_reason as j_reason
    for sq, sk, bits, fused in ((96, 96, 32, False), (320, 320, 32, False),
                                (64, 1000, 32, True), (64, 64, 8, False),
                                (40, 64, 32, False)):
        tp = DropoutPlan(DropoutPlanConfig(mode="overlap",
                                           philox_bits=bits))
        jp = JPlan(JPlanConfig(mode="overlap", philox_bits=bits))
        assert mask_kernel_unsupported_reason(tp, sq, sk, fused) == \
            j_reason(jp, sq, sk, fused)


def test_launch_counter_stays_zero_on_cpu():
    reset_launch_counts()
    dropout_mask(1, 2, 32, 64, 0.1, 1, device="cpu")
    out = torch.empty((1, 2, 1, 64), dtype=torch.int32)
    philox.philox_mask_into(out, key_lo=1, key_hi=0, salt=0,
                            threshold=tpc.threshold_from_p(0.1))
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        philox.philox_mask_into(out.to(torch.int64), key_lo=1, key_hi=0,
                                salt=0, threshold=0)
    with pytest.raises(ValueError):
        philox.philox_mask_into(out, key_lo=1, key_hi=0, salt=0,
                                threshold=0, rounds=4)


@pytest.mark.gpu
def test_kernel_bitwise_vs_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none on this machine")
    reset_launch_counts()
    for shape, p, seed, rounds, hg, off in (
            ((1, 32, 512, 512), 0.1, 0x1234, 7, 0, 0),
            ((2, 3, 1024, 96), 0.5, 2 ** 40 + 1, 3, 0, 0),
            ((1, 4, 256, 384), 0.1, 77, 10, 8, 12)):
        b, h, sq, sk = shape
        got = dropout_mask(b, h, sq, sk, p, seed, 3, rounds,
                           heads_global=hg, bh_offset=off, device="cuda")
        want = philox.philox_dropout_mask_plain(
            b, h, sq, sk, p, seed, 3, rounds, heads_global=hg,
            bh_offset=off, device="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape
    counts = launch_counts()
    assert counts.pop("philox_mask") == 3 and set(counts.values()) == {0}
