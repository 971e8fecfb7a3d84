#!/usr/bin/env python3
"""What the design steps of the persistent bf16 GEMM+RNG kernels
(``csrc/gemm_bf16.cuh``; ``gemm_rng_bf16.cu`` dense,
``gemm_rng_grouped_bf16.cu`` grouped) each bring, and how the kernels
compare with the ones they replace. A probe, not part of the port: it
builds the two libraries as they are and variants of them, each from a
copy of ``csrc`` with one design step taken back or changed (no variant
stores C through shared memory: that epilogue was not built):

  one_tile_a_cta  one cluster a cluster tile, as many clusters as cluster
                  tiles (not persistent);
  oversubscribed  twice the clusters that can run at once, each walking
                  its share of the tiles (the late ones start as others
                  end);
  no_cluster      clusters of one CTA: each loads all of its B (no TMA
                  multicast);
  tile_n_128      128-column tiles (an m64n128k16 a warpgroup a k16
                  slice, B read twice a 128 x 256 of C; N = 1408 is 11
                  such tiles, 5.5 of 256);
  producer_emit   the plane on the producer's warps 1-3 alone (no consumer
                  units under the products);
  consumer_emit   the plane on the consumer warps alone (the plane is
                  incomplete where their stages cannot hold it);
  stagger         a consumer warpgroup's unit every other stage, the two
                  warpgroups on alternate stages, so one keeps the tensor
                  cores fed while the other makes its unit;
  producer_units_1  a producer warp's lane makes one word at a time, not
                  two (one unit a grab);
  producer_units_4  four words at a time;
  no_products     no wgmma (C is wrong: a timing of the rest);
  producer_regs_72  72 registers a producer thread, 216 a consumer
                  thread (56 and 224);

joins of them by "+" (e.g. no_products+producer_emit), and, with
``--parent DIR`` (the root of another checkout, e.g. unpacked from ``git
archive <commit>``), that checkout's bf16 libraries and its f32 and e4m3
ones. It holds every kernel's C against the plain version at
``BF16_GEMM_TOL`` (1e-2 (1 + |C|), chip_smoke.py's limit) and its plane
against the plain one bitwise -- at chip_smoke.py's four dense host shapes
(``FP8_SHAPES``), its three grouped ones (``GROUPED_SHAPES``) and its two
ragged calls (``BF16_RAGGED``) -- says whether C and the plane are bitwise
the parent's, whether the f32 and e4m3 libraries run the parent's machine
code (cuobjdump's SASS, instruction for instruction), and times, in turns
(CUDA events): the kernel and the parent's, emission on and off, beside
``torch.matmul`` / ``torch.bmm`` and the sequential yardstick (that call,
then the standalone Philox kernel for the same plane), with the SM clock
and the power draw under each at QKV and the grouped gate (nvidia-smi);
the variants in turns with the kernel at QKV, the out-projection and the
grouped gate.

    python3 scripts/probe_gemm_bf16.py [--parent DIR] [--variants a,b|none]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a check and a
timing, each with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.core.producer import pick_gemm_blocks  # noqa: E402
from repro_torch.kernels import build, gemm_rng, philox  # noqa: E402

K16, G16 = gemm_rng.KERNEL_BF16, gemm_rng.KERNEL_GROUPED_BF16
# libraries whose machine code must be the parent's: the f32 and e4m3 hosts
OTHERS = (gemm_rng.KERNEL, gemm_rng.KERNEL_GROUPED, gemm_rng.KERNEL_FP8,
          gemm_rng.KERNEL_GROUPED_FP8)
TOL = smoke.BF16_GEMM_TOL
# variant -> (edits (file, old, new), libraries built, shapes timed); a
# name joined by "+" takes the edits of each part, the first part's
# libraries and shapes
VARIANTS = {
    "one_tile_a_cta": (
        [("gemm_bf16.cuh",
          "if (cluster_tiles < clusters) clusters = static_cast<int>"
          "(cluster_tiles);",
          "clusters = static_cast<int>(cluster_tiles);")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "oversubscribed": (
        [("gemm_bf16.cuh",
          "if (cluster_tiles < clusters) clusters = static_cast<int>"
          "(cluster_tiles);",
          "clusters *= 2;\n  if (cluster_tiles < clusters) clusters = "
          "static_cast<int>(cluster_tiles);")],
        (K16,), ("qkv", "out_proj")),
    "no_cluster": (
        [("gemm_walk.cuh", "constexpr int CLUSTER = 2;",
          "constexpr int CLUSTER = 1;")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "tile_n_128": (
        [("gemm_walk.cuh", "constexpr int BN = 256;",
          "constexpr int BN = 128;")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "producer_emit": (
        [("gemm_bf16.cuh", "bool emitting = sh.first < sh.end;",
          "bool emitting = false;")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "consumer_emit": (
        [("gemm_bf16.cuh",
          "} else if (threadIdx.x >= 32 && sh.first < sh.end) {",
          "} else if (threadIdx.x >= 32 && sh.first > sh.end) {")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "stagger": (
        [("gemm_bf16.cuh",
          "      if (emitting) emitting = emit_units<ROUNDS, 1>(e, counter, "
          "sh, lane);",
          "      if (emitting && (kt & 1) == w)\n        emitting = "
          "emit_units<ROUNDS, 1>(e, counter, sh, lane);")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "producer_units_1": (
        [("gemm_bf16.cuh", "constexpr int PRODUCER_UNITS = 2;",
          "constexpr int PRODUCER_UNITS = 1;")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "producer_units_4": (
        [("gemm_bf16.cuh", "constexpr int PRODUCER_UNITS = 2;",
          "constexpr int PRODUCER_UNITS = 4;")],
        (K16, G16), ("qkv", "out_proj", "gate")),
    "no_products": (
        [("gemm_bf16.cuh",
          "        mma_slice<BN>(d, da + 2 * j, db + (2048 >> 4) * j);",
          "        d[j] += static_cast<float>(da + db);")],
        (K16,), ("qkv", "out_proj")),
    "producer_regs_72": (
        [("gemm_bf16.cuh", "constexpr int kProducerRegs = 56;",
          "constexpr int kProducerRegs = 72;"),
         ("gemm_bf16.cuh", "constexpr int kConsumerRegs = 224;",
          "constexpr int kConsumerRegs = 216;")],
        (K16,), ("qkv", "out_proj")),
}


def variant(name):
    """(edits, libraries, shapes) of a variant name, parts joined by +."""
    parts = [VARIANTS[p] for p in name.split("+")]
    return ([e for p in parts for e in p[0]], parts[0][1], parts[0][2])


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def ptxas_summary(log: str) -> str:
    """Registers, spills and the wgmma advisories of one nvcc log."""
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
    spills = sorted({int(r) for r in re.findall(r"(\d+) bytes spill", log)})
    advisories = sorted({re.sub(r" in function '[^']*'|line \d+", "",
                                ln).strip()
                         for ln in log.splitlines() if "(C75" in ln})
    return (f"{regs[0]}-{regs[-1]} registers, spill bytes at most "
            f"{spills[-1]}; ptxas advisories: {advisories or 'none'}")


def hgmma(lib) -> int:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return len(re.findall(r"\bHGMMA\.", sass))


def sass_functions(lib) -> list:
    """The library's kernels as sorted instruction sequences (cuobjdump's
    SASS without addresses, encodings or function names): two libraries
    whose lists are equal run the same machine code."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    return sorted(tuple(instruction.findall(body))
                  for body in sass.split("Function : ")[1:])


def build_libraries(parent, variants):
    """(side, kernel) -> library: the variants and the parent's libraries,
    one nvcc each, all started together with the tree's own."""
    out = build.build_dir() / "probe_gemm_bf16"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jobs = {}
    for name in variants:
        edits, kernels, _ = variant(name)
        csrc = out / name
        shutil.copytree(build.CSRC, csrc)
        for fname, old, new in edits:
            body = (csrc / fname).read_text()
            if body.count(old) != 1:
                raise RuntimeError(f"{name}: the edit of {old!r} does not "
                                   f"apply to {fname}")
            (csrc / fname).write_text(body.replace(old, new))
        for kernel in kernels:
            jobs[(name, kernel)] = csrc / f"{kernel}.cu"
    if parent is not None:
        csrc = Path(parent) / "src/repro_torch/kernels/csrc"
        for kernel in (K16, G16, *OTHERS):
            jobs[("parent", kernel)] = csrc / f"{kernel}.cu"
    procs = {}
    for (name, kernel), src in jobs.items():
        lib = out / f"lib{name}_{kernel}.so"
        procs[(name, kernel)] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.build_all([K16, G16, *OTHERS, philox.KERNEL])
    for kernel in (K16, G16):
        print(f"[build] kernel {kernel}: "
              f"{ptxas_summary(build.log_path(kernel).read_text())}; "
              f"{hgmma(build.library_path(kernel))} HGMMA", flush=True)
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        grid = ""
        if key[1] == K16 and key[0] != "parent":
            fn = ctypes.CDLL(str(lib)).repro_gemm_rng_bf16_clusters
            grid = f"; a grid of at most {fn()} clusters"
        print(f"[build] {key[0]} {key[1]}: {ptxas_summary(log)}"
              + (f"; {hgmma(lib)} HGMMA" if key[1] in (K16, G16) else "")
              + grid, flush=True)
        libs[key] = lib
    return libs


def clocks_under(fn, seconds: float = 1.5) -> str:
    """The SM clock and the board's power draw (nvidia-smi sampled every 20
    ms; medians) while ``fn`` runs back to back for about ``seconds``."""
    n = max(1, int(seconds * 1e3 / smoke.cuda_time_ms(fn, 3, warmup=2)))
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    sampler.terminate()
    rows = [ln.split(",") for ln in sampler.communicate()[0].splitlines()
            if ln.count(",") == 1]
    mhz = statistics.median(float(r[0]) for r in rows) if rows else None
    watts = statistics.median(float(r[1]) for r in rows) if rows else None
    return f"SM clock {mhz} MHz, power {watts} W (median of {len(rows)})"


def bind(lib, kernel):
    like = gemm_rng._kernel_fn(kernel)
    fn = getattr(ctypes.CDLL(str(lib)), gemm_rng._ENTRY[kernel][1])
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return fn


def within(got, want):
    err = (got.float() - want.float()).abs()
    return float((err / (TOL * (1 + want.float().abs()))).max())


def cases():
    """(label, kernel, operand shapes, logical blocks, plane (B, H, SQ,
    SK)): the smoke's dense and grouped host shapes and its ragged calls."""
    mb, mh, sq = smoke.QKV_MASK
    out = [(label, K16, ((m, k), (k, n)), pick_gemm_blocks(m, n, k),
            (mb, mh, sq, sq)) for label, (m, n, k) in smoke.FP8_SHAPES]
    out += [(label, G16, ((e, m, k), (e, k, n)), pick_gemm_blocks(m, n, k),
             (*plane, plane[2]))
            for label, (e, m, k, n), plane in smoke.GROUPED_SHAPES]
    for (e, m, k, n), blocks, plane in smoke.BF16_RAGGED:
        lead = () if e is None else (e,)
        out.append((f"ragged_{'dense' if e is None else 'grouped'}",
                    K16 if e is None else G16,
                    ((*lead, m, k), (*lead, k, n)), blocks,
                    (*plane, smoke.BF16_RAGGED_SK)))
    return out


def in_turns(fns: dict, rounds: int = 3, iters: int = 20) -> dict:
    """name -> median ms of ``rounds`` readings of each callable, taken in
    turns (the order reversed every other round)."""
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(smoke.cuda_time_ms(fns[name], iters,
                                                  warmup=5))
    return {name: (statistics.median(t), t) for name, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose GEMM "
                    "libraries to build and compare")
    ap.add_argument("--variants", default="all",
                    help="comma-separated variants to build and time, "
                    "'all' or 'none'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gemm_bf16: no CUDA device", file=sys.stderr)
        return 1
    variants = (list(VARIANTS) if args.variants == "all" else
                [] if args.variants == "none" else args.variants.split(","))
    for v in variants:
        variant(v)
    libs = build_libraries(args.parent, variants)
    fns = {key: bind(lib, key[1]) for key, lib in libs.items()}
    if args.parent is not None:
        for kernel in OTHERS:
            mine = sass_functions(build.library_path(kernel))
            theirs = sass_functions(libs[("parent", kernel)])
            print(f"[check] {kernel}: {len(mine)} kernels, "
                  f"{sum(map(len, mine))} instructions; the same machine "
                  f"code as the parent's, instruction for instruction: "
                  f"{mine == theirs}", flush=True)
    for kernel in (K16, G16):
        fns[("kernel", kernel)] = gemm_rng._kernel_fn(kernel)
    clusters = build.load(K16).repro_gemm_rng_bf16_clusters()
    card = smi()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flops_rate = smoke.BF16_FLOPS_PER_S

    def run(which, kernel, a, w, em):
        gemm_rng._fns[kernel] = fns[(which, kernel)]
        fwd = gemm_rng._forward if kernel == K16 else \
            gemm_rng._forward_grouped
        return fwd(a, w, em)

    for label, kernel, (sa, sw), blocks, plane in cases():
        a = torch.randn(sa, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(sw, generator=gen, device="cuda").to(torch.bfloat16)
        _, em = gemm_rng._emission(a, w, *plane, 0.1, torch.tensor(77), 5,
                                   7, *blocks, 2048, 256, 0, 0,
                                   grouped=kernel == G16)
        want_c = (gemm_rng.gemm_ref(a, w) if kernel == K16 else
                  gemm_rng.gemm_grouped_plain(a, w))
        want_plane = gemm_rng._plain_plane(em, a.device)
        n = sw[-1]
        flops = 2 * a.numel() * n
        sides = ["kernel"] + [s for s in ("parent",) if ("parent", kernel)
                              in fns]
        sides += [v for v in variants if label in variant(v)[2]
                  and (v, kernel) in fns]
        got = {}
        for which in sides:
            c, mask = run(which, kernel, a, w, em)
            c_off, _ = run(which, kernel, a, w, None)
            torch.cuda.synchronize()
            got[which] = (c, mask)
            ok = (within(c, want_c) <= 1 and within(c_off, want_c) <= 1
                  and torch.equal(mask, want_plane))
            print(f"[check] {kernel} {label} {tuple(sa)}x{tuple(sw)}, at "
                  f"most {clusters} clusters, {which}: C "
                  f"{within(c, want_c):.4g}, emission"
                  f" off {within(c_off, want_c):.4g} of {TOL} x (1+|C|) from "
                  f"the plain version, plane == plain "
                  f"{torch.equal(mask, want_plane)}{'' if ok else ' WRONG'} | "
                  f"{card}", flush=True)
            if not ok and which not in variants:
                raise AssertionError(f"{kernel} {label} {which}: wrong")
            if not ok and "no_products" not in which:
                del got[which]   # a wrong variant is not timed
            del c_off
        if "parent" in got:
            same = [torch.equal(x, y) for x, y in zip(got["kernel"],
                                                        got["parent"])]
            print(f"[check] {kernel} {label}: C == the parent's bitwise "
                  f"{same[0]}, plane {same[1]} | {card}", flush=True)
        right = set(got)
        del got, want_c
        if label.startswith("ragged"):
            del a, w, want_plane
            continue
        seq, seq_plane = smoke.sequential_yardstick(a, w, em, plane[:3])
        seq()
        torch.cuda.synchronize()
        if not torch.equal(seq_plane.reshape(want_plane.shape), want_plane):
            raise AssertionError(f"{label}: the Philox kernel's plane")
        library = torch.bmm if kernel == G16 else torch.matmul
        turns = {"kernel": lambda: run("kernel", kernel, a, w, em),
                 "kernel_off": lambda: run("kernel", kernel, a, w, None)}
        if "parent" in sides:
            turns["parent"] = lambda: run("parent", kernel, a, w, em)
            turns["parent_off"] = lambda: run("parent", kernel, a, w, None)
        turns["library"] = lambda: library(a, w)
        turns["sequential"] = seq
        t = in_turns(turns)
        bound = smoke.gemm_rng_bf16_bound(
            *((sa[-2], n, sa[-1]) if kernel == K16 else
              (sa[1], n, sa[2])), em.layout.rows_valid * em.layout.sk, 7,
            smoke.issue_ops_per_s(), groups=sa[0] if kernel == G16 else 1)
        line = ", ".join(
            f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
            f"{' / '.join(f'{x:.4f}' for x in runs)})"
            for name, (ms, runs) in t.items())
        print(f"[time] {kernel} {label}: {line}; bound {bound[0]:.4f} ms by "
              f"{bound[1]} (the products alone "
              f"{flops / flops_rate * 1e3:.4f}); the plane "
              f"{(t['kernel'][0] / t['kernel_off'][0] - 1) * 100:+.1f} % of "
              f"the product; kernel / sequential "
              f"{t['kernel'][0] / t['sequential'][0]:.3f} | {card}",
              flush=True)
        if label in ("qkv", "gate"):
            for name in ("kernel", "kernel_off", "library", "sequential"):
                print(f"[clock] {kernel} {label} {name}: "
                      f"{clocks_under(turns[name])} | {card}", flush=True)
        for v in [v for v in sides[1:] if v in variants and v in right]:
            vt = in_turns({
                "kernel": lambda: run("kernel", kernel, a, w, em),
                v: lambda v=v: run(v, kernel, a, w, em),
                "kernel_off": lambda: run("kernel", kernel, a, w, None),
                f"{v}_off": lambda v=v: run(v, kernel, a, w, None)})
            print(f"[time] {kernel} {label} variant {v}: " + ", ".join(
                f"{name} {ms:.4f} ms ({' / '.join(f'{x:.4f}' for x in r)})"
                for name, (ms, r) in vt.items())
                + f"; {v} / kernel {vt[v][0] / vt['kernel'][0]:.3f} "
                f"(emission off {vt[f'{v}_off'][0] / vt['kernel_off'][0]:.3f})"
                f" | {card}", flush=True)
        del a, w, want_plane, seq, seq_plane
        torch.cuda.empty_cache()
    for kernel in (K16, G16):
        gemm_rng._fns[kernel] = fns[("kernel", kernel)]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
