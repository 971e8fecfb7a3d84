#!/usr/bin/env python3
"""What holds the f32 flash forward back, and how it compares with the
kernel it replaced. A probe, not part of the port: it builds
``csrc/flash_fwd_f32.cu`` as it is and three variants of it, each from a
copy of ``csrc`` with ``flash_fwd_sm90.cuh`` edited:

  one_warpgroup  F32Ops with one warpgroup a CTA (64 query rows, a K and
                 V split each) instead of two (128 rows sharing them);
  no_splits      the K and V splits of each k-block left out (O is wrong:
                 a timing only);
  no_products    the S and P V products left out (O is wrong: a timing
                 only);

and, with ``--parent DIR`` (the root of another checkout, e.g. unpacked
from ``git archive <commit>``), that checkout's f32 forward
(``flash_fwd.cu``, the SIMT kernel this one replaced, where it has one)
and bf16 forward. At B=2, H=32, S=2048, D=128, causal, it holds the
kernel's and each right variant's O and lse against the plain version at
``chip_smoke.F32_FWD_TOL`` (1e-5 (1 + |x|)), the bf16 forward's outputs
against the parent's bitwise, and times each variant in turns with the
kernel (kernel, variant, variant, kernel; CUDA events) in dropout modes
replay, premask and none.

    python3 scripts/probe_flash_fwd_f32.py [--parent DIR]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a check and a
timing, each with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, philox  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels.philox_common import seed_salt_smem  # noqa: E402

TOL = 1e-5
SHAPE = (2, 32, 2048, 128)
SKIP_PRODUCTS = """template <int D, class U>
__device__ __forceinline__ void skip_products(float (&acc)[D / 2],
                                              const uint32_t (&a)[3][4][4],
                                              U&& under) {
  under();
  uint32_t x = 0;  // the parts stay live, as the products would read them
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) x ^= a[i][j][t];
  acc[0] += __uint_as_float(x & 0x7fffffu) * 0.f;
}

template <int D>
struct F32Ops {"""
# variant -> (edits of flash_fwd_sm90.cuh, whether its O is the kernel's)
VARIANTS = {
    "one_warpgroup": ([("static constexpr int kWarpgroups = 2;",
                        "static constexpr int kWarpgroups = 1;")], True),
    "no_splits": ([("    split_tile<D, THREADS>(st, vs);\n", ""),
                   ("      split_tile<D, THREADS>(st, ks);\n", "")], False),
    "no_products": ([("template <int D>\nstruct F32Ops {", SKIP_PRODUCTS),
                     ("    score6<D>(sc, qs + (threadIdx.x / WG) * 3 * TILE, "
                      "ks);", "    zero(sc);"),
                     ("add_product6<D>(o, pa, vs, [&] {",
                      "skip_products<D>(o, pa, [&] {")], False),
}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def build_libraries(parent):
    """name -> (library, C entry): the variants and the parent's forwards,
    one nvcc each, all started together."""
    out = build.build_dir() / "probe_flash_fwd"
    shutil.rmtree(out, ignore_errors=True)
    jobs = {}
    for name, (edits, _) in VARIANTS.items():
        csrc = out / name
        shutil.copytree(build.CSRC, csrc)
        body = (csrc / "flash_fwd_sm90.cuh").read_text()
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"{name}: the edit of {old!r} does not "
                                   "apply to flash_fwd_sm90.cuh")
            body = body.replace(old, new)
        (csrc / "flash_fwd_sm90.cuh").write_text(body)
        jobs[name] = (csrc / "flash_fwd_f32.cu", "repro_flash_fwd")
    if parent is not None:
        csrc = Path(parent) / "src/repro_torch/kernels/csrc"
        f32 = csrc / "flash_fwd.cu"
        jobs["parent"] = (f32 if f32.exists() else csrc / "flash_fwd_f32.cu",
                          "repro_flash_fwd")
        jobs["parent_bf16"] = (csrc / "flash_fwd_bf16.cu",
                               "repro_flash_fwd_bf16")
    procs = {}
    for name, (src, _) in jobs.items():
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.build_all([flash.SOURCES[flash.KERNEL],
                     flash.SOURCES[flash.KERNEL_BF16]])
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        spills = sorted({int(r) for r in re.findall(
            r"(\d+) bytes spill stores", log)})
        print(f"[build] {name}: {regs[0]}-{regs[-1]} registers, spill "
              f"stores {spills[-1]} bytes at most", flush=True)
        libs[name] = (lib, jobs[name][1])
    return libs


def bind(lib, entry, like):
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return fn


def within(got, want):
    err = (got.float() - want.float()).abs()
    return float((err / (TOL * (1 + want.float().abs()))).max())


def cuda_ms(fn, iters=10, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose "
                    "forwards to build and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_fwd_f32: no CUDA device", file=sys.stderr)
        return 1
    libs = build_libraries(args.parent)
    kernel = {torch.float32: flash._kernel_fn(flash.KERNEL),
              torch.bfloat16: flash._kernel_fn(flash.KERNEL_BF16)}
    fns = {(name, torch.bfloat16 if name.endswith("bf16") else
            torch.float32): bind(lib, entry, kernel[torch.float32])
           for name, (lib, entry) in libs.items()}
    for dtype, fn in kernel.items():
        fns[("kernel", dtype)] = fn

    def fwd(which, q, k, v, op, **kw):
        flash._fns[flash.KERNELS[q.dtype]] = fns[(which, q.dtype)]
        return flash.flash_attention_fwd(q, k, v, op, return_lse=True, **kw)

    b, h, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               for _ in range(3))
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    ops = {"replay": seed_salt_smem(torch.tensor(9), 3),
           "premask": philox.philox_dropout_mask_plain(
               b, h, s, s, 0.1, torch.tensor(9), 3, device="cuda"),
           "none": None}
    card = smi()
    f32 = [n for n, dt in fns if dt == torch.float32 and n != "kernel"]
    for mode, op in ops.items():
        kw = dict(causal=True, dropout_p=0.1, mode=mode)
        po, plse = flash.flash_attention_fwd_plain(q, k, v, op, **kw)
        for which in ["kernel"] + [n for n in f32 if n not in VARIANTS
                                   or VARIANTS[n][1]]:
            o, lse = fwd(which, q, k, v, op, **kw)
            torch.cuda.synchronize()
            print(f"[check] {mode} {which}: o {within(o, po):.4g}, lse "
                  f"{within(lse, plse):.4g} of {TOL} x (1+|x|) | {card}",
                  flush=True)
        if ("parent_bf16", torch.bfloat16) in fns:
            got = fwd("kernel", q16, k16, v16, op, **kw)
            want = fwd("parent_bf16", q16, k16, v16, op, **kw)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            print(f"[check] {mode} bf16: the kernel == the parent's "
                  f"bitwise {same}", flush=True)
        for which in f32:
            times = {"kernel": [], which: []}
            for side in ("kernel", which, which, "kernel"):
                times[side].append(cuda_ms(
                    lambda: fwd(side, q, k, v, op, **kw)))
            print(f"[time] {mode}: kernel {times['kernel']} ms, {which} "
                  f"{times[which]} ms (in turns) | {card}", flush=True)
        if ("parent_bf16", torch.bfloat16) in fns:
            times = {"kernel": [], "parent_bf16": []}
            for side in ("kernel", "parent_bf16", "parent_bf16", "kernel"):
                times[side].append(cuda_ms(
                    lambda: fwd(side, q16, k16, v16, op, **kw)))
            print(f"[time] {mode} bf16: kernel {times['kernel']} ms, "
                  f"parent {times['parent_bf16']} ms (in turns) | {card}",
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
