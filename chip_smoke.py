#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

  0. the card: name, count, ``nvidia-smi`` name and power limit;
  1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a and print ptxas's register and spill lines;
  2. each kernel against its plain PyTorch version on the card, bitwise,
     then timed with CUDA events beside its bound;
  3. serving: the reduced llama2 on the card against the same engine on
     the CPU (tokens, mask-cache stats and planes equal, prefill logits
     allclose), then ``ServeEngine`` on llama2-7b at full width and depth
     (f32 random weights from a seed): 8 requests, 4 slots, 64 new tokens
     each; every request finishes, logits stay finite, the Philox kernel
     launches exactly once per mask-cache miss (8 x 32 = 256), and every
     plane the cache created equals the plain version bitwise.

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is the
``{"ok": true, "device": {...}}`` record. Every phase runs, in order.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

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
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels.philox_common import (  # noqa: E402
    from_int32_bits,
    split_seed,
    threshold_from_p,
)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
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
        f"cuda {torch.version.cuda}")


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


# ------------------------------------------------------------------ phase 3
def _tree_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return [_tree_to(v, device) for v in tree]


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
    got, _ = prefill(_tree_to(params, "cuda"), cfg, rt, toks.cuda())
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)
    serve = ServeConfig(max_slots=2, page_size=16, num_pages=16,
                        max_model_len=96, prompt_bucket=8)
    runs = {dev: _run_engine(cfg, serve, _tree_to(params, dev), dev,
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
    n_params = sum(int(np.prod(t.shape)) for t in _leaves(params))
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


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    state = {"philox_err": 0}
    for phase in (phase_card, phase_build, phase_kernels,
                  phase_serve_reference, phase_serve):
        phase(state)
    t = state["philox_timing"]["serve"]
    rec = {"name": philox.KERNEL, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/philox_mask.cu",
           "replaces": "src/repro/kernels/philox.py:40",
           "launches": state["philox_launches"],
           "max_abs_err": state["philox_err"],
           "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": None}
    print(json.dumps({"kernels": [rec]}))
    print(state["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"], "count": state["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
