#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

  0. the card: name, count, ``nvidia-smi`` name and power limit;
  1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all started together) for sm_90a and print ptxas's
     register and spill lines;
  2. each kernel against its plain PyTorch version on the card, then
     timed with CUDA events beside its bound and, where one PyTorch call
     computes the same function, that call's time: the Philox kernel
     bitwise; the fused GEMM+RNG kernel at the training QKV shape (4096 x
     12288 x 4096; plane bitwise, C within 1e-3 of torch.matmul) and at a
     Region-3 shape (its plain-GEMM variant); flash forward, dq and dkv at
     B=2, H=32, S=2048, D=128 in all four dropout modes, with a local
     window and with yi-6b's GQA (32 q / 4 kv heads);
  3. serving: the reduced llama2 on the card against the same engine on
     the CPU, then ``ServeEngine`` on llama2-7b at full width and depth
     (f32 random weights from a seed): 8 requests, 4 slots, 64 new tokens
     each; every request finishes, logits stay finite, the Philox kernel
     launches exactly once per mask-cache miss (8 x 32 = 256), and every
     plane the cache created equals the plain version bitwise;
  4. training reference: ``make_train_step`` on the reduced llama2 and yi
     (B=2, S=256, site "qkv", flash kernels, replay and premask) on the
     card against the same steps on the CPU, 3 steps, allclose at 1e-4;
  5. training at width: llama2-7b at full width and 4 layers (f32 random
     weights from a seed, 1.07 B parameters), B=2, S=2048, p=0.1, site
     "qkv", remat="block": 3 steps planned "replay host=gemm_rng" and
     step 0 again planned "gemm_rng" (premask); every kernel launches as
     often as the schedule and remat imply; replay and premask give
     bitwise equal step-0 losses, gradients and updated weights; the
     plane the fused kernel emits for layer 0 equals the plain version;
     step 0 agrees with the same step through tensor ops only (site
     "xla", attn_impl "xla"); step time, tokens/s, peak memory and a
     profiler trace of one step.

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is the
``{"ok": true, "device": {...}}`` record. Every phase runs, in order.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.kernels import build, launch_counts, philox  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd  # noqa
from repro_torch.kernels import gemm_rng  # noqa: E402
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels.philox_common import (  # noqa: E402
    from_int32_bits,
    split_seed,
    threshold_from_p,
)
from repro_torch.tree import leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM data sheet, f32 without
                                   # tensor cores (the port's f32 kernels)
ISSUE_LANES_PER_SM = 128           # 4 warp schedulers x 32 lanes a clock

SERVE_SHAPE = (1, 32, 512, 512)    # llama2-7b plane at max_model_len 512
TRAIN_SHAPE = (1, 32, 4096, 4096)  # a training-size plane


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def issue_ops_per_s() -> float:
    """Thread-instructions a second: SMs x 128 issue lanes x the card's
    maximum SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def philox_bound(shape, rounds: int, ops_rate: float):
    """(bound_ms, bound_by) for one plane: 4 bytes written per packed word
    against HBM, and the fewest int32 instructions a word needs against
    the issue rate: 8 Philox calls x (4 a round: two 32x32->64 multiplies,
    each giving both words, and two three-input xors; the key schedule is
    the same for every thread) + 8 (4 compares, 4 bit merges)."""
    b, h, sq, sk = shape
    words = b * h * (sq // 32) * sk
    t_bytes = words * 4 / HBM_BYTES_PER_S
    t_ops = words * 8 * (4 * rounds + 8) / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_time_ms(fn, kernel: str, iters: int):
    """Mean device time of the kernels whose name holds ``kernel``, from a
    torch.profiler trace of ``iters`` calls; None when the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((from_int32_bits(a) - from_int32_bits(b)).abs().max())


# ------------------------------------------------------------------ phase 0
def phase_card(state) -> None:
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    state["smi"] = nvidia_smi("name,power.limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {state['kind']} x{state['count']} | nvidia-smi: "
        f"{state['smi']} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")


# ------------------------------------------------------------------ phase 1
def phase_build(state) -> None:
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f}s "
        f"-> {build.build_dir()}")
    for name in libs:
        for line in build.ptxas_report(name):
            log(f"[build] {name}: {line}")


# ------------------------------------------------------------------ phase 2
def _check_philox(state, shape, p, seed, salt, rounds,
                  heads_global=0, bh_offset=0) -> torch.Tensor:
    b, h, sq, sk = shape
    got = philox.philox_dropout_mask(b, h, sq, sk, p, seed, salt, rounds,
                                     heads_global=heads_global,
                                     bh_offset=bh_offset, device="cuda")
    want = philox.philox_dropout_mask_plain(
        b, h, sq, sk, p, seed, salt, rounds, heads_global=heads_global,
        bh_offset=bh_offset, device="cuda")
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    state["philox_err"] = max(state.get("philox_err", 0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"philox kernel != plain at {shape} p={p} "
                             f"seed={seed} rounds={rounds} "
                             f"window=({heads_global},{bh_offset})")
    return got


def phase_kernels(state) -> None:
    n = 0
    _check_philox(state, SERVE_SHAPE, 0.1, 0x1234, 7, 7); n += 1
    _check_philox(state, TRAIN_SHAPE, 0.1, 2 ** 40 + 99, 3, 7); n += 1
    _check_philox(state, (2, 3, 1024, 96), 0.1, 5, 11, 7); n += 1
    # shard window: batch row 1, heads 4..7 of a (2, 8) plane
    whole = _check_philox(state, (2, 8, 256, 384), 0.1, 77, 2, 7)
    tile = _check_philox(state, (1, 4, 256, 384), 0.1, 77, 2, 7,
                         heads_global=8, bh_offset=1 * 8 + 4)
    if not torch.equal(tile[0], whole[1, 4:8]):
        raise AssertionError("shard-window tile != slice of the plane")
    n += 2
    for rounds in (3, 5, 7, 10):
        for p in (0.0, 0.1, 1.0):
            _check_philox(state, (1, 4, 256, 640), p, 2 ** 32 + 17,
                          rounds * 1000 + 3, rounds)
            n += 1
    # an array seed keys with key_hi = 0, an int seed with its top word
    lo = _check_philox(state, (1, 2, 64, 128), 0.1, torch.tensor(2 ** 33 + 5),
                       0, 7)
    hi = _check_philox(state, (1, 2, 64, 128), 0.1, 2 ** 33 + 5, 0, 7)
    assert split_seed(torch.tensor(2 ** 33 + 5)) == (5, 0)
    if torch.equal(lo, hi):
        raise AssertionError("key_hi did not reach the kernel")
    n += 2
    log(f"[kernels] philox_mask == plain bitwise on {n} cases "
        f"(max_abs_err {state['philox_err']})")

    ops_rate = issue_ops_per_s()
    timings = {}
    for label, shape, iters, plain_iters in (("serve", SERVE_SHAPE, 200, 10),
                                             ("train", TRAIN_SHAPE, 20, 2)):
        b, h, sq, sk = shape
        out = torch.empty((b, h, sq // 32, sk), dtype=torch.int32,
                          device="cuda")
        args = dict(key_lo=0x1234, key_hi=0, salt=7,
                    threshold=threshold_from_p(0.1), rounds=7)
        launch = lambda: philox.philox_mask_into(out, **args)  # noqa: E731
        event_ms = cuda_time_ms(launch, iters)
        prof_ms = device_time_ms(launch, "philox_mask_kernel", iters)
        ms = prof_ms if prof_ms is not None else event_ms
        plain_ms = cuda_time_ms(
            lambda: philox.philox_dropout_mask_plain(
                b, h, sq, sk, 0.1, 0x1234, 7, 7, device="cuda"),
            plain_iters, warmup=1)
        bound_ms, bound_by = philox_bound(shape, 7, ops_rate)
        gelem = b * h * sq * sk / (ms * 1e-3) / 1e9
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        log(f"[kernels] philox_mask {label} plane {b}x{h}x{sq // 32}x{sk}: "
            f"device {prof_ms} ms (profiler), {event_ms:.5f} ms a launch "
            f"back to back (CUDA events); {gelem:.1f} Gelem/s; plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
            f"(issue {ops_rate / 1e12:.2f} Tinst/s), kernel at "
            f"{bound_ms / ms * 100:.1f}% of bound | {state['smi']}")
    state["philox_timing"] = timings


# GEMM+RNG at the training QKV shape (B*S, (H+2KV)*hd, d_model of llama2-7b
# at B=2, S=2048) and at a Region-3 shape; flash at the training planes
QKV_SHAPE = (4096, 12288, 4096)
QKV_MASK = (2, 32, 2048)
REGION3 = (256, 768, 64, (1, 128, 256))
FLASH_SHAPE = (2, 32, 2048, 128)
# tolerances of a kernel against its plain version on the card: f32 sums
# of 4096 (GEMM) and 2048 (attention) terms in another order than the
# plain version's cuBLAS / torch sums, on O(1) random inputs
GEMM_TOL = 1e-3
FWD_TOL = 1e-4
GRAD_TOL = 1e-3


def _close(name, got, want, tol, state, key) -> float:
    """Max |got - want|, checked against tol * (1 + |want|); a NaN or an
    infinity on either side fails the check."""
    err = (got - want).abs()
    worst = float(err.max())
    if not bool((err <= tol * (1 + want.abs())).all()):
        raise AssertionError(f"{name}: max abs err {worst} beyond tol "
                             f"{tol} x (1 + |want|), or not finite")
    state.setdefault("errs", {})
    state["errs"][key] = max(state["errs"].get(key, 0.0), worst)
    return worst


def gemm_rng_bound(m, n, k, mask_words, rounds, ops_rate):
    """(bound_ms, bound_by): operands and result read / written once, the
    plane written once, against HBM; the f32 FMAs at the f32 rate plus the
    plane's Philox instructions (8 calls x (4 a round + 8) a word) at the
    issue rate -- they share the SMs' issue slots."""
    t_bytes = 4 * (m * k + k * n + m * n + mask_words) / HBM_BYTES_PER_S
    t_ops = (2 * m * n * k / F32_FLOPS_PER_S
             + mask_words * 8 * (4 * rounds + 8) / ops_rate)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def valid_pairs(sq, sk, causal, local_window) -> int:
    """Score elements a causal / windowed attention head needs."""
    q_pos = np.arange(sq)[:, None] + (sk - sq)
    k_pos = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), bool)
    if causal:
        valid &= k_pos <= q_pos
    if local_window > 0:
        valid &= k_pos > q_pos - local_window
    return int(valid.sum())


def flash_bound(kind, b, h, s, d, pairs):
    """(bound_ms, bound_by) of one MHA replay call (no plane): the matmul
    FLOPs the valid scores need (fwd QK^T and PV: 4D a pair; dq: 6D; dkv:
    8D) at the f32 rate, against each input read once and each output
    written once."""
    per = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d
    flops = per * pairs * b * h
    q_bytes = b * h * s * d * 4
    kv_bytes = 2 * b * h * s * d * 4
    row_bytes = b * h * s * 4
    moved = {"fwd": q_bytes + kv_bytes + q_bytes + row_bytes,
             "dq": 3 * q_bytes + kv_bytes + 2 * row_bytes,
             "dkv": 2 * q_bytes + kv_bytes + 2 * row_bytes + 2 * q_bytes}
    t_bytes = moved[kind] / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels_train(state) -> None:
    """The training path's kernels against their plain versions, then
    timed at the training path's shapes."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.philox_common import seed_salt_smem
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    ops_rate = issue_ops_per_s()
    timing = state.setdefault("timing", {})

    # ---- fused GEMM + RNG, and its Region-3 plain-GEMM variant
    m, n, k = QKV_SHAPE
    mb, mh, sq = QKV_MASK
    a, w = rnd(m, k), rnd(k, n)
    kw = dict(mask_batch=mb, mask_heads=mh, mask_sq=sq, mask_sk=sq, p=0.1,
              seed=torch.tensor(77), salt=5)
    c, mask = gemm_rng.gemm_with_rng(a, w, **kw)
    want_c, want_mask = gemm_rng.gemm_with_rng_plain(a, w, **kw)
    torch.cuda.synchronize()
    if not torch.equal(mask, want_mask):
        raise AssertionError("gemm_rng plane != plain version")
    err = _close("gemm_rng C", c, want_c, GEMM_TOL, state, "gemm_rng")
    m3, n3, k3, (b3, h3, s3) = REGION3
    a3, w3 = rnd(m3, k3), rnd(k3, n3)
    c3, none = gemm_rng.gemm_with_rng(a3, w3, mask_batch=b3, mask_heads=h3,
                                      mask_sq=s3, mask_sk=s3, p=0.1, seed=1,
                                      block_m=256, block_n=256, block_k=64)
    if none is not None or gemm_rng.variant_counts()["plain"] < 1:
        raise AssertionError("Region-3 shape did not run the plain variant")
    want3, _ = gemm_rng.gemm_with_rng_plain(
        a3, w3, mask_batch=b3, mask_heads=h3, mask_sq=s3, mask_sk=s3, p=0.1,
        seed=1, block_m=256, block_n=256, block_k=64)
    err3 = _close("gemm plain variant", c3, want3, GEMM_TOL, state,
                  "gemm_rng")
    log(f"[kernels] gemm_rng {m}x{n}x{k} + plane {mb}x{mh}x{sq // 32}x{sq}"
        f": plane == plain bitwise, C max abs err {err:.3g} (tol "
        f"{GEMM_TOL} x (1+|C|): 4096-term f32 sums in another order than "
        f"cuBLAS); Region 3 {m3}x{n3}x{k3}: plane None, C max abs err "
        f"{err3:.3g}")
    launch = lambda: gemm_rng.gemm_with_rng(a, w, **kw)  # noqa: E731
    # the Region-3 variant at the same product and plane: a one-step
    # logical grid cannot host 4096 packed rows, so the emission is off
    launch_plain = lambda: gemm_rng.gemm_with_rng(  # noqa: E731
        a, w, block_m=m, block_n=n, **kw)
    before = gemm_rng.variant_counts()["plain"]
    if launch_plain()[1] is not None or \
            gemm_rng.variant_counts()["plain"] != before + 1:
        raise AssertionError("the Region-3 timing call emitted a plane")
    runs = {"rng": [], "plain": []}
    for variant in ("rng", "plain", "plain", "rng"):   # in turns
        runs[variant].append(cuda_time_ms(
            launch if variant == "rng" else launch_plain, 5))
    ms, plain3_ms = (float(np.mean(runs[v])) for v in ("rng", "plain"))
    plain_ms = cuda_time_ms(lambda: gemm_rng.gemm_with_rng_plain(a, w, **kw),
                            2, warmup=1)
    lib_ms = cuda_time_ms(lambda: a @ w, 10)
    bound_ms, bound_by = gemm_rng_bound(m, n, k, mb * mh * (sq // 32) * sq,
                                        7, ops_rate)
    plain3_bound, _ = gemm_rng_bound(m, n, k, 0, 7, ops_rate)
    timing["gemm_rng"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms,
                              plain_variant_ms=plain3_ms,
                              plain_variant_bound_ms=plain3_bound)
    log(f"[kernels] gemm_rng {m}x{n}x{k}: {ms:.4f} ms a launch (CUDA "
        f"events, in turns {runs['rng']}), {2 * m * n * k / ms / 1e9:.1f} "
        f"TFLOP/s; plain variant (Region 3, no plane) {plain3_ms:.4f} ms "
        f"(in turns {runs['plain']}, bound {plain3_bound:.4f} ms); "
        f"torch.matmul "
        f"{lib_ms:.4f} ms; plain version {plain_ms:.2f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}, kernel at "
        f"{bound_ms / ms * 100:.1f}% of bound | {state['smi']}")
    del a, w, c, mask, want_c, want_mask

    # ---- flash forward, dq, dkv
    b, h, s, d = FLASH_SHAPE
    plane = philox.philox_dropout_mask_plain(b, h, s, s, 0.1,
                                             torch.tensor(9), 3,
                                             device="cuda")
    seed_salt = seed_salt_smem(torch.tensor(9), 3)
    cases = [("none", 0, h), ("fused", 0, h), ("premask", 0, h),
             ("replay", 0, h), ("replay", 512, h), ("replay", 0, 4)]
    outs = {}
    for mode, window, kvh in cases:
        q, do = rnd(b, h, s, d), rnd(b, h, s, d)
        kk, vv = rnd(b, kvh, s, d), rnd(b, kvh, s, d)
        op = {"premask": plane, "replay": seed_salt}.get(mode)
        args = dict(causal=True, local_window=window, dropout_p=0.1,
                    mode=mode, seed=torch.tensor(9), salt=3)
        o, lse = flash.flash_attention_fwd(q, kk, vv, op, return_lse=True,
                                           **args)
        po, plse = flash.flash_attention_fwd_plain(q, kk, vv, op, **args)
        dq, dk, dv = flash_bwd.flash_attention_bwd(q, kk, vv, o, lse, do, op,
                                                   **args)
        pdq, pdk, pdv = flash_bwd.flash_attention_bwd_plain(
            q, kk, vv, po, plse, do, op, **args)
        if kvh != h:
            pdk, pdv = (t.reshape(b, kvh, h // kvh, s, d).sum(2)
                        for t in (pdk, pdv))
        torch.cuda.synchronize()
        label = f"{mode} window={window} kv_heads={kvh}"
        errs = [_close(f"flash_fwd {label}", o, po, FWD_TOL, state,
                       "flash_fwd"),
                _close(f"flash lse {label}", lse, plse, FWD_TOL, state,
                       "flash_fwd"),
                _close(f"flash_dq {label}", dq, pdq, GRAD_TOL, state,
                       "flash_dq"),
                _close(f"flash_dkv dk {label}", dk, pdk, GRAD_TOL, state,
                       "flash_dkv"),
                _close(f"flash_dkv dv {label}", dv, pdv, GRAD_TOL, state,
                       "flash_dkv")]
        outs[(mode, window, kvh)] = (q, kk, vv, do, o, lse, op)
        log(f"[kernels] flash {b}x{h}x{s}x{d} {label}: max abs err o "
            f"{errs[0]:.3g} lse {errs[1]:.3g} (tol {FWD_TOL}), dq "
            f"{errs[2]:.3g} dk {errs[3]:.3g} dv {errs[4]:.3g} (tol "
            f"{GRAD_TOL}; 2048-term f32 sums in another order than the "
            f"plain version's)")
    # replay and premask consume the same bits: equal inputs, equal outputs
    q, kk, vv = outs[("replay", 0, h)][:3]
    args = dict(causal=True, dropout_p=0.1)
    o_r = flash.flash_attention_fwd(q, kk, vv, seed_salt, mode="replay",
                                    **args)
    o_p = flash.flash_attention_fwd(q, kk, vv, plane, mode="premask",
                                    **args)
    if not torch.equal(o_r, o_p):
        raise AssertionError("flash replay != premask on the same inputs")

    # timing on the main path's mode (replay, causal, MHA)
    q, kk, vv, do, o, lse, op = outs[("replay", 0, h)]
    args = dict(causal=True, dropout_p=0.1, mode="replay")
    pairs = valid_pairs(s, s, True, 0)
    fwd = lambda: flash.flash_attention_fwd(  # noqa: E731
        q, kk, vv, op, return_lse=True, **args)
    bwd = lambda: flash_bwd.flash_attention_bwd(  # noqa: E731
        q, kk, vv, o, lse, do, op, **args)
    plain_fwd = lambda: flash.flash_attention_fwd_plain(  # noqa: E731
        q, kk, vv, op, **args)
    plain_bwd = lambda: flash_bwd.flash_attention_bwd_plain(  # noqa: E731
        q, kk, vv, o, lse, do, op, **args)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, kk, vv))
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    lib_fwd = cuda_time_ms(lambda: sdpa(q, kk, vv, is_causal=True), 10)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), do, retain_graph=True), 10)
    plain_fwd_ms = cuda_time_ms(plain_fwd, 2, warmup=1)
    plain_bwd_ms = cuda_time_ms(plain_bwd, 2, warmup=1)
    bwd_ms = cuda_time_ms(bwd, 10)
    for name, fn, plain_ms, lib_ms in (
            ("flash_fwd", fwd, plain_fwd_ms, lib_fwd),
            ("flash_dq", bwd, plain_bwd_ms, lib_bwd),
            ("flash_dkv", bwd, plain_bwd_ms, lib_bwd)):
        if name == "flash_fwd":
            ms = cuda_time_ms(fn, 10)
            how = "CUDA events"
        else:
            # both backward kernels run in one call: each one's device
            # time comes from a profiler trace of that call
            ms = device_time_ms(fn, f"{name}_kernel", 10)
            if ms is None:
                raise AssertionError("the profiler saw no device time")
            how = (f"profiler; the whole backward call {bwd_ms:.4f} ms by "
                   f"CUDA events")
        kind = name.split("_")[1]
        bound_ms, bound_by = flash_bound(kind, b, h, s, d, pairs)
        flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d * pairs * b * h
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms)
        log(f"[kernels] {name} {b}x{h}x{s}x{d} causal replay: {ms:.4f} ms "
            f"a launch ({how}), {flops / ms / 1e9:.1f} TFLOP/s; "
            f"plain {plain_ms:.2f} ms; SDPA "
            f"{'forward' if kind == 'fwd' else 'backward (dq, dk, dv)'} "
            f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}, "
            f"kernel at {bound_ms / ms * 100:.1f}% of bound | "
            f"{state['smi']}")
    for mode in ("none", "premask"):
        q, kk, vv, do, o, lse, op = outs[(mode, 0, h)]
        ms = cuda_time_ms(lambda: flash.flash_attention_fwd(
            q, kk, vv, op, causal=True, dropout_p=0.1, mode=mode), 10)
        log(f"[kernels] flash_fwd causal {mode}: {ms:.4f} ms a launch")


# ------------------------------------------------------------------ phase 3
def _run_engine(cfg, serve, params, device, plens, max_new, seed):
    from repro_torch.serve import ServeEngine
    engine = ServeEngine(cfg, serve=serve, params=params, device=device)
    rng = np.random.default_rng(seed)
    reqs = [engine.make_request(
        rng.integers(0, cfg.vocab_size, int(n)).tolist(), max_new)
        for n in plens]
    report = engine.run(reqs)
    return engine, reqs, report


def phase_serve_reference(state) -> None:
    """The reduced llama2 through the engine on the card and on the CPU."""
    from repro_torch.config import get_arch
    from repro_torch.models import Runtime, model_init, prefill
    from repro_torch.serve import ServeConfig
    cfg = get_arch("llama2-7b", reduced=True)
    params = model_init(cfg, seed=1, device="cpu")
    toks = torch.arange(40, dtype=torch.int64).reshape(1, 40) % cfg.vocab_size
    rt = Runtime(plan=None)
    ref, _ = prefill(params, cfg, rt, toks)
    got, _ = prefill(to_device(params, "cuda"), cfg, rt, toks.cuda())
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
    serve = ServeConfig(max_slots=2, page_size=16, num_pages=16,
                        max_model_len=96, prompt_bucket=8)
    runs = {dev: _run_engine(cfg, serve, to_device(params, dev), dev,
                             (10, 23, 17), 6, 3) for dev in ("cpu", "cuda")}
    (e_cpu, r_cpu, _), (e_gpu, r_gpu, _) = runs["cpu"], runs["cuda"]
    assert [r.output for r in r_cpu] == [r.output for r in r_gpu], \
        "reduced engine: card tokens != CPU tokens"
    assert e_cpu.mask_cache.stats() == e_gpu.mask_cache.stats()
    cpu_planes = dict(e_cpu.mask_cache.items())
    for key, plane in e_gpu.mask_cache.items():
        if not torch.equal(plane.cpu(), cpu_planes[key]):
            raise AssertionError(f"reduced engine plane {key} differs")
    log(f"[serve-ref] {cfg.name}: card == CPU (prefill logits allclose "
        f"1e-4; tokens, mask-cache stats {e_gpu.mask_cache.stats()} and "
        f"{len(cpu_planes)} planes equal)")


def phase_serve(state) -> None:
    from repro_torch.config import get_arch
    from repro_torch.models import model_init
    from repro_torch.serve import ServeConfig
    cfg = get_arch("llama2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size) == (32, 4096, 32, 128, 11008, 32000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(t.shape)) for t in leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.2f}B f32 params on the card "
        f"in {(time.perf_counter() - t0) * 1e3:.0f} ms")
    serve = ServeConfig(max_slots=4, page_size=16, num_pages=4 * 32 + 4,
                        max_model_len=512, mask_decode=True)
    plens = np.random.default_rng(0).integers(256, 449, size=8)
    reset_launch_counts()
    engine, reqs, report = _run_engine(cfg, serve, params, "cuda", plens,
                                       64, 1)
    torch.cuda.synchronize()
    counts = launch_counts()
    state["philox_launches"] = counts[philox.KERNEL]
    d = report.to_dict()
    assert engine.masked and engine.plan.p == cfg.attn_dropout == 0.1
    assert report.n_requests == 8 and all(len(r.output) == 64
                                          for r in reqs), "unfinished"
    assert engine.nonfinite_logits == 0, "non-finite logits"
    misses = d["mask_cache"]["misses"]
    assert counts[philox.KERNEL] == misses == 8 * cfg.n_layers, (
        counts, d["mask_cache"])
    n = 0
    for key, plane in engine.mask_cache.items():
        seed, salt, _layer, _step, thr, rounds, bits = key
        assert bits == 32 and thr == threshold_from_p(engine.plan.p)
        _, h, sq32, sk = plane.shape
        want = philox.philox_dropout_mask_plain(
            1, h, sq32 * 32, sk, engine.plan.p, torch.tensor(seed), salt,
            rounds, device="cuda")
        state["philox_err"] = max(state["philox_err"],
                                  max_abs_err(plane, want))
        if not torch.equal(plane, want):
            raise AssertionError(f"cached plane {key} != plain version")
        n += 1
    assert n == misses
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ft, ct = d["latency_first_token_s"], d["latency_completion_s"]
    log(f"[serve] prompts {plens.tolist()}; {d['total_new_tokens']} new "
        f"tokens in {d['wall_s']:.3f}s = {d['tokens_per_s']:.2f} tok/s")
    log(f"[serve] first token p50 {ft['p50'] * 1e3:.1f} ms p99 "
        f"{ft['p99'] * 1e3:.1f} ms; completion p50 {ct['p50'] * 1e3:.1f} "
        f"ms p99 {ct['p99'] * 1e3:.1f} ms; peak memory {peak:.2f} GiB")
    log(f"[serve] mask cache {d['mask_cache']}; philox launches "
        f"{counts[philox.KERNEL]}; {n} cached planes == plain bitwise "
        f"| {state['smi']}")
    _profile_serve(engine, cfg, state)


def _profile_serve(engine, cfg, state) -> None:
    """Where the serve time goes: a torch.profiler trace of the device
    over 4 more requests (prompt 256, 16 new tokens) on the same engine;
    device busy share = summed kernel and copy time over the wall time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    reqs = [engine.make_request(
        rng.integers(0, cfg.vocab_size, 256).tolist(), 16) for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
                    e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[serve-profile] 4 requests x 16 tokens: wall {wall:.3f}s, "
        f"{report.tokens_per_s:.2f} tok/s, device busy {busy:.3f}s "
        f"({busy / wall * 100:.1f}%) | {state['smi']}")
    for us, count, key in rows[:8]:
        log(f"[serve-profile]   {us / 1e3:10.2f} ms {count:7d}x "
            f"{key[:90]}")


# ------------------------------------------------------------------ phase 4
TRAIN_LAYERS, TRAIN_B, TRAIN_S = 4, 2, 2048


def _train_run(cfg, replay, batch, seq, remat="block", opt=None):
    """site "qkv" on the flash kernels. ``opt`` None is the repo's default
    OptimizerConfig (lr 3e-4 after a 100-step warm-up)."""
    from repro_torch.config.base import (
        DropoutPlanConfig,
        OptimizerConfig,
        RunConfig,
        ShapeConfig,
        ShardingConfig,
        StepKind,
        TrainConfig,
    )
    return RunConfig(
        model=cfg, shape=ShapeConfig("smoke", seq, batch, StepKind.TRAIN),
        sharding=ShardingConfig(attn_impl="pallas", remat=remat),
        dropout=DropoutPlanConfig(mode="overlap", site="qkv", p=0.1,
                                  attn_replay=replay, seed=0),
        train=TrainConfig(optimizer=opt or OptimizerConfig()))


def _batches(cfg, run, device, n):
    from repro_torch.data import batch_for_step
    return [tuple(torch.from_numpy(t).to(device)
                  for t in batch_for_step(cfg, run.shape, i, seed=0))
            for i in range(n)]


def phase_train_reference(state) -> None:
    """Reduced llama2 and yi through make_train_step on the card and on
    the CPU: 3 steps, replay and premask, allclose at 1e-4."""
    from repro_torch.config import get_arch
    from repro_torch.config.base import OptimizerConfig
    from repro_torch.optim import adamw_init
    from repro_torch.train import init_train_state, make_train_step
    for arch in ("llama2-7b", "yi-6b"):
        cfg = get_arch(arch, reduced=True)
        master = init_train_state(cfg, seed=1, device="cpu")["master"]
        for replay in ("auto", "off"):
            # the full rate from step 1, so the weights move measurably
            run = _train_run(cfg, replay, 2, 256,
                             opt=OptimizerConfig(lr=1e-3, warmup_steps=1))
            step_fn = make_train_step(cfg, run)
            runs = {}
            for dev in ("cpu", "cuda"):
                st = {"master": to_device(master, dev), "step": 0}
                st["opt"] = adamw_init(st["master"])
                ms = []
                for x, y in _batches(cfg, run, dev, 3):
                    st, m = step_fn(st, x, y)
                    ms.append((float(m["loss"]), float(m["grad_norm"])))
                runs[dev] = (st, ms)
            for (lc, gc_), (lg, gg) in zip(runs["cpu"][1], runs["cuda"][1]):
                if abs(lc - lg) > 1e-4 * (1 + abs(lc)) or \
                        abs(gc_ - gg) > 1e-4 * (1 + abs(gc_)):
                    raise AssertionError(f"{arch} {replay}: card "
                                         f"{(lg, gg)} != CPU {(lc, gc_)}")
            for a, b in zip(leaves(runs["cpu"][0]["master"]),
                            leaves(runs["cuda"][0]["master"])):
                torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
            card_losses = [round(loss, 6) for loss, _ in runs["cuda"][1]]
            log(f"[train-ref] {cfg.name} B=2 S=256 attn_replay={replay}: "
                f"3 steps card == CPU (losses {card_losses}, grad norms, "
                f"weights allclose 1e-4)")


# ------------------------------------------------------------------ phase 5
def _expected_launches(n_layers: int, remat: str, steps: int):
    """Kernel launches of ``steps`` training steps with site "qkv": each
    layer's forward runs the fused GEMM+RNG kernel (replay keeps it as the
    host, premask reads its plane) and the flash forward; remat="block"
    runs both again when the backward recomputes the unit; the backward
    runs dq and dkv once a layer. No Region 3 here, so no Philox kernel."""
    fwd = n_layers * (2 if remat == "block" else 1)
    return {"philox_mask": 0, "gemm_rng": steps * fwd,
            "flash_fwd": steps * fwd, "flash_dq": steps * n_layers,
            "flash_dkv": steps * n_layers}


def _bitwise_equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def phase_train(state) -> None:
    from repro_torch.config import get_arch
    from repro_torch.core import producer
    from repro_torch.core.overlap import DropoutPlan
    from repro_torch.models.attention import _project_qkv_fused
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.transformer import _index, embed_inputs
    from repro_torch.models import Runtime
    from repro_torch.train import (
        compile_run_schedule,
        init_train_state,
        make_grad_fn,
        make_train_step,
    )
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=TRAIN_LAYERS)
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size) == (4096, 32, 128, 11008, 32000)
    run_r = _train_run(cfg, "auto", TRAIN_B, TRAIN_S)
    run_p = _train_run(cfg, "off", TRAIN_B, TRAIN_S)
    for run, how, host in ((run_r, "replay", "gemm_rng"),
                           (run_p, "gemm_rng", "")):
        sched = compile_run_schedule(cfg, run)
        bad = [a for a in sched.assignments
               if (a.how, a.host_how) != (how, host)]
        if bad:
            raise AssertionError(f"schedule not {how}/{host}:\n"
                                 f"{sched.explain()}")
        log(f"[train] {sched.explain()}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state0 = init_train_state(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state0["master"]))
    log(f"[train] {cfg.name} x{cfg.n_layers} layers: {n_params / 1e9:.3f}B "
        f"f32 params + AdamW moments on the card in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    batches = _batches(cfg, run_r, "cuda", 3)
    x0, y0 = batches[0]

    # step 0 gradients under both plans: bitwise equal
    loss_r, _, grads_r = make_grad_fn(cfg, run_r)(state0["master"], x0, y0,
                                                  0)
    loss_p, _, grads_p = make_grad_fn(cfg, run_p)(state0["master"], x0, y0,
                                                  0)
    torch.cuda.synchronize()
    if not (torch.equal(loss_r, loss_p)
            and _bitwise_equal_trees(grads_r, grads_p)):
        raise AssertionError("replay and premask step-0 loss / gradients "
                             "differ")
    if not all(bool(torch.isfinite(g).all()) for g in leaves(grads_r)):
        raise AssertionError("non-finite step-0 gradients")
    log(f"[train] step 0: replay and premask loss {float(loss_r):.7f} and "
        f"all {len(leaves(grads_r))} gradient tensors bitwise equal, finite")
    del grads_r, grads_p

    # the plane the fused kernel emits for layer 0, on layer 0's input
    plan = DropoutPlan(run_p.dropout)
    lp = _index(state0["master"]["stacks"][0]["l0"], 0)
    with torch.no_grad():
        h = norm_apply(lp["norm_mix"],
                       embed_inputs(state0["master"], cfg, x0, Runtime()),
                       cfg)
        pos = torch.arange(TRAIN_S, dtype=torch.int32, device="cuda")
        *_, plane = _project_qkv_fused(lp["mix"], h, cfg, pos, plan, 0, 0,
                                       how=producer.HOW_GEMM)
    want = philox.philox_dropout_mask_plain(
        TRAIN_B, cfg.n_heads, TRAIN_S, TRAIN_S, plan.cfg.p,
        plan.step_seed(0), plan.salt(0), plan.cfg.philox_rounds,
        device="cuda")
    if not torch.equal(plane, want):
        raise AssertionError("layer-0 plane of the fused kernel != plain")
    log(f"[train] layer 0: the fused kernel's plane {tuple(plane.shape)} "
        "== philox_dropout_mask_plain bitwise")
    del plane, want, h

    # the main path: 3 replay steps and step 0 again under premask
    step_r = make_train_step(cfg, run_r)
    step_p = make_train_step(cfg, run_p)
    reset_launch_counts()
    torch.cuda.synchronize()
    times, losses = [], []
    st = state0
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        new, m = step_r(st, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss"]), float(m["ce"]),
                       float(m["grad_norm"])))
        if i == 0:
            new_p, m_p = step_p(state0, x, y)
            torch.cuda.synchronize()
            if not (torch.equal(m["loss"], m_p["loss"])
                    and torch.equal(m["grad_norm"], m_p["grad_norm"])
                    and _bitwise_equal_trees(new["master"],
                                             new_p["master"])):
                raise AssertionError("replay and premask step 0 differ")
            del new_p
        st = new
    counts = launch_counts()
    state["gemm_variants"] = gemm_rng.variant_counts()
    # the same step 0 without the GEMM+RNG and flash kernels: site "xla" bits
    # (the same counters) into the tensor-op attention (attn_impl "xla")
    run_x = dataclasses.replace(
        run_r, sharding=dataclasses.replace(run_r.sharding, attn_impl="xla"),
        dropout=dataclasses.replace(run_r.dropout, site="xla"))
    _, m_x = make_train_step(cfg, run_x)(state0, *batches[0])
    loss_x, gn_x = float(m_x["loss"]), float(m_x["grad_norm"])
    if abs(loss_x - losses[0][0]) > 1e-4 * abs(loss_x) or \
            abs(gn_x - losses[0][2]) > 1e-3 * abs(gn_x):
        raise AssertionError(f"step 0 on the kernels {losses[0]} != on "
                             f"tensor ops {(loss_x, gn_x)}")
    want_counts = _expected_launches(TRAIN_LAYERS, run_r.sharding.remat, 4)
    if counts != want_counts:
        raise AssertionError(f"launches {counts} != {want_counts}")
    state["train_launches"] = counts
    if not all(np.isfinite(v) for row in losses for v in row):
        raise AssertionError(f"non-finite metrics {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = float(np.mean(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    state["train"] = dict(step_s=step_s, tokens_per_s=tokens / step_s,
                          peak_gib=peak)
    log(f"[train] 3 steps (replay) + step 0 (premask): (loss, ce, grad "
        f"norm) {losses}; replay and premask step 0 bitwise equal (loss, "
        f"grad norm, updated weights)")
    log(f"[train] step 0 through tensor ops (site xla, attn_impl xla): "
        f"loss {loss_x:.7f}, grad norm {gn_x:.6f}; the kernels' step 0 "
        f"within 1e-4 (loss) and 1e-3 (grad norm) relative")
    log(f"[train] launches {counts} == 4 steps x (per layer: gemm_rng and "
        f"flash_fwd x2 for remat='block', dq and dkv x1) x "
        f"{TRAIN_LAYERS} layers")
    log(f"[train] step times {[round(t, 4) for t in times]} s (host clock "
        f"to a synchronize; step 0 includes first-call set-up); steady "
        f"step {step_s:.4f} s = {tokens / step_s:.1f} tokens/s; peak "
        f"memory {peak:.2f} GiB | {state['smi']}")
    del state0
    _profile_train(step_r, st, batches[0], state)


def _profile_train(step_fn, st, batch, state) -> None:
    """Where a training step's time goes: a torch.profiler trace of one
    more step; device busy share = summed kernel and copy time over the
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    x, y = batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(st, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
                    e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    state["train"]["busy_share"] = busy / wall
    log(f"[train-profile] one step: wall {wall:.3f}s, device busy "
        f"{busy:.3f}s ({busy / wall * 100:.1f}%) | {state['smi']}")
    for us, count, key in rows[:8]:
        log(f"[train-profile]   {us / 1e3:10.2f} ms {count:7d}x {key[:90]}")


KERNEL_RECORDS = (
    # name, source, replaced TPU kernel, the path whose run counts it
    (philox.KERNEL, "philox_mask.cu", "src/repro/kernels/philox.py:40",
     "serve"),
    (gemm_rng.KERNEL, "gemm_rng.cu", "src/repro/kernels/gemm_rng.py:143",
     "train"),
    (flash.KERNEL, "flash_fwd.cu",
     "src/repro/kernels/flash_attention.py:58", "train"),
    (flash_bwd.KERNEL_DQ, "flash_bwd.cu",
     "src/repro/kernels/flash_attention_bwd.py:77", "train"),
    (flash_bwd.KERNEL_DKV, "flash_bwd.cu",
     "src/repro/kernels/flash_attention_bwd.py:137", "train"),
)


def kernel_records(state):
    recs = []
    for name, src, replaces, path in KERNEL_RECORDS:
        if name == philox.KERNEL:
            t = dict(state["philox_timing"]["serve"], library_ms=None)
            launches, err = state["philox_launches"], state["philox_err"]
        else:
            t = state["timing"][name]
            launches = state["train_launches"][name]
            err = state["errs"][name]
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "path": path}
        if name == gemm_rng.KERNEL:
            # its plain-GEMM variant (Region 3) is the same kernel with the
            # emission switched off; checked and timed in phase 2
            launches_by = state["gemm_variants"]
            rec["variants"] = {
                "rng": {"replaces": "src/repro/kernels/gemm_rng.py:143",
                        "launches": launches_by["rng"], "ms": t["ms"]},
                "plain": {"replaces": "src/repro/kernels/gemm_rng.py:304",
                          "launches": launches_by["plain"],
                          "ms": t["plain_variant_ms"],
                          "bound_ms": t["plain_variant_bound_ms"]}}
        recs.append(rec)
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    state = {"philox_err": 0}
    t0 = time.perf_counter()
    for phase in (phase_card, phase_build, phase_kernels,
                  phase_kernels_train, phase_serve_reference, phase_serve,
                  phase_train_reference, phase_train):
        phase(state)
        log(f"[time] {phase.__name__} done at "
            f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernel_records(state)}))
    print(state["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"], "count": state["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
