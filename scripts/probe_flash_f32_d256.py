#!/usr/bin/env python3
"""The f32 flash kernels at head_dim 256 on the card. A probe, not part of
the port: it builds the f32 forward, dq and dkv libraries (whose D = 256
instances are the kernels of ``csrc/flash_f32_wide.cuh``) and prints
ptxas's registers and spills by head dim; with ``--parent DIR`` (the root
of another checkout, e.g. unpacked from ``git archive <commit>`` into a
directory under ``build/``) it builds that checkout's three libraries too
and compares each kernel at head dims up to 128 with the parent's,
instruction for instruction (cuobjdump's SASS; the first difference
printed), with each library's ``chip_smoke.narrow_sass_digest`` of both
builds. Then it holds the three kernels against their plain versions at
D = 256 on a small MQA shape in every dropout mode, printing each
output's largest error against the smoke's f32 limits (F32_FWD_TOL for O
and lse, GRAD_TOL for dq, dk, dv) without stopping, and, if those pass,
runs the smoke's own D = 256 check (``chip_smoke._flash_kernels_wide`` at
f32: recurrentgemma-9b's LOCAL layer, 1 x 16 x 4096 x 256, one kv head,
window 2048, the four modes, the precision controls and the planted
fault, then the timings beside the bound and SDPA's masked call).

With ``--variants a,b`` (each joinable by "+") it also builds edited
copies of the dq and dkv libraries and, for each, prints ptxas's
registers and spills at D = 256, holds its D = 256 dq and dkv against the
plain versions at the smoke's shape (replay, the window) and times them
in turns with the tree's (the profiler's device time):

  folded  each score step's part products a fresh sum that f32 adds fold
          into the scores, not chained into them inside the tensor core;
  ahead   each step's slices loaded from device memory into registers a
          step ahead of their split, while the step before runs (the walk's
          last load repeats its last block), not when they are split.

    python3 scripts/probe_flash_f32_d256.py [--parent DIR] [--variants ..]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a check and a
timing, each with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
import probe_flash_d256 as d256  # noqa: E402
from repro_torch.kernels import build, philox  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd  # noqa
from repro_torch.kernels.philox_common import seed_salt_smem  # noqa: E402

LIBS = ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")
D = 256
# (mode, local window, kv heads, B, H, S): small shapes first
SMALL = (("none", 0, 1, 1, 2, 128), ("premask", 0, 1, 1, 2, 128),
         ("replay", 0, 1, 1, 2, 256), ("fused", 64, 1, 1, 2, 256),
         ("replay", 0, 2, 2, 4, 192))


# variant -> (file in csrc, text, its replacement)
VARIANTS = {
    "folded": [("flash_f32_wide.cuh", """    wgmma_fence();
    score_step(s, a, buf, 2 * step, 2 * step + 1, step == 0);
    wgmma_commit();
    if (step == 0) under();
    wgmma_wait0();
    fence_acc(s);""", """    float part[32];
    wgmma_fence();
    score_step(part, a, buf, 2 * step, 2 * step + 1, true);
    wgmma_commit();
    if (step == 0) under();
    wgmma_wait0();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = step == 0 ? part[i] : s[i] + part[i];""")],
    "ahead": [("flash_f32_wide.cuh", """  Load load;
  int j;
""", """  Load load;
  int j;
  Pair next;
"""), ("flash_f32_wide.cuh", """    __syncthreads();
    store_pair(load(j++), buf);""", """    if (j == 0) next = load(0);
    __syncthreads();
    store_pair(next, buf);
    next = load(++j);"""), ("flash_f32_wide.cuh",
                             "return Stream<Load>{load, 0};",
                             "return Stream<Load>{load, 0, {}};"),
              ("flash_dq_f32.cu", "const int it = j / 12, r = j % 12;",
               "const int it = min(j / 12, n - 1), r = j % 12;"),
              ("flash_dkv_f32.cu", "block(q, j / 8), r)",
               "block(q, min(j / 8, n - 1)), r)"),
              ("flash_dkv_f32.cu", "block(dout, j / 8), r - 4)",
               "block(dout, min(j / 8, n - 1)), r - 4)"),
              ("flash_dkv_f32.cu", "block(r / 4 == 1 ? dout : q, j / 12)",
               "block(r / 4 == 1 ? dout : q, min(j / 12, n - 1))")],
}


def build_variant(name: str) -> dict:
    """The dq and dkv libraries of a copy of csrc with the variant's edits
    (``name`` joined by "+"): name -> (library, ptxas report by head
    dim)."""
    out = build.build_dir() / "probe_f32_d256" / name
    if out.exists():
        shutil.rmtree(out)
    csrc = out / "csrc"
    shutil.copytree(build.CSRC, csrc)
    for part in name.split("+"):
        for fname, old, new in VARIANTS[part]:
            path = csrc / fname
            text = path.read_text()
            if old not in text:
                raise RuntimeError(f"variant {part}: text not found in "
                                   f"{fname}")
            path.write_text(text.replace(old, new))
    procs = {}
    for lib in ("flash_dq_f32", "flash_dkv_f32"):
        so = out / f"lib{lib}.so"
        procs[lib] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for lib, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} {lib}: nvcc failed\n{log}")
        regs, spills, d = [], [], None
        for line in log.splitlines():
            if "Compiling entry" in line:
                d = 256 if "_wide" in line else None
            elif d == 256 and "registers" in line:
                regs += [int(x) for x in re.findall(
                    r"Used (\d+) registers", line)]
            elif d == 256 and "spill" in line:
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill", line)]
        libs[lib] = (so, regs, spills)
    return libs


def time_variants(names, rnd, card) -> None:
    """Each variant's D = 256 dq and dkv against the plain versions, then
    timed in turns with the tree's at the smoke's shape (replay, the
    window)."""
    import ctypes
    b, h, kvh, s, d = smoke.WIDE_SHAPE
    win = smoke.WIDE_CASES[-1][1]
    q, do = rnd(b, h, s, d), rnd(b, h, s, d)
    k, v = rnd(b, kvh, s, d), rnd(b, kvh, s, d)
    op = seed_salt_smem(torch.tensor(9), 3)
    kw = dict(causal=True, local_window=win, dropout_p=0.1, mode="replay")
    o, lse = flash.flash_attention_fwd(q, k, v, op, return_lse=True, **kw)
    want = flash_bwd.flash_attention_bwd_plain(q, k, v, o, lse, do, op, **kw)
    tree = {n: flash_bwd._kernel_fn(n) for n in (flash_bwd.KERNEL_DQ,
                                                 flash_bwd.KERNEL_DKV)}
    fns = {"tree": tree}
    for name in names:
        libs = build_variant(name)
        fns[name] = {}
        for kname, lib in ((flash_bwd.KERNEL_DQ, "flash_dq_f32"),
                           (flash_bwd.KERNEL_DKV, "flash_dkv_f32")):
            so, regs, spills = libs[lib]
            fn = getattr(ctypes.CDLL(str(so)), f"repro_{kname}")
            fn.argtypes, fn.restype = tree[kname].argtypes, ctypes.c_int
            fns[name][kname] = fn
            print(f"[variant] {name} {lib} D=256: {min(regs)}-{max(regs)} "
                  f"registers, spill bytes {max(spills)} | {card}",
                  flush=True)
    bwd = lambda: flash_bwd.flash_attention_bwd_heads(  # noqa: E731
        q, k, v, o, lse, do, op, **kw)
    times = {}
    for name in ["tree", *names, *reversed(names), "tree"]:   # in turns
        flash_bwd._fns.update(fns[name])
        got = bwd()
        torch.cuda.synchronize()
        ratios = [smoke._within(g, w, smoke.GRAD_TOL)[1]
                  for g, w in zip(got, want)]
        for kind in ("dq", "dkv"):
            times.setdefault(name, {}).setdefault(kind, []).append(
                smoke.device_time_ms(bwd, f"flash_{kind}_kernel", 10))
        print(f"[variant] {name}: dq, dk, dv at "
              f"{', '.join(f'{r:.3g}' for r in ratios)} of GRAD_TOL | "
              f"{card}", flush=True)
    flash_bwd._fns.update(tree)
    for name, t in times.items():
        print(f"[variant] {name} at 1x16x4096x256 kv=1 window={win} replay: "
              f"dq {t['dq']} ms, dkv {t['dkv']} ms (profiler, in turns) | "
              f"{card}", flush=True)


def small_case(mode, window, kvh, b, h, s, rnd, card) -> bool:
    q, do = rnd(b, h, s, D), rnd(b, h, s, D)
    k, v = rnd(b, kvh, s, D), rnd(b, kvh, s, D)
    plane = philox.philox_dropout_mask_plain(b, h, s, s, 0.1,
                                             torch.tensor(9), 3,
                                             device="cuda")
    op = {"premask": plane, "replay": seed_salt_smem(torch.tensor(9),
                                                     3)}.get(mode)
    args = dict(causal=True, local_window=window, dropout_p=0.1, mode=mode,
                seed=torch.tensor(9), salt=3)
    o, lse = flash.flash_attention_fwd(q, k, v, op, return_lse=True, **args)
    po, plse = flash.flash_attention_fwd_plain(q, k, v, op, **args)
    dq, dk, dv = flash_bwd.flash_attention_bwd_heads(q, k, v, o, lse, do, op,
                                                     **args)
    pdq, pdk, pdv = flash_bwd.flash_attention_bwd_plain(q, k, v, po, plse,
                                                        do, op, **args)
    torch.cuda.synchronize()
    ok, parts = True, []
    for name, got, want, tol in (
            ("o", o, po, smoke.F32_FWD_TOL), ("lse", lse, plse,
                                              smoke.F32_FWD_TOL),
            ("dq", dq, pdq, smoke.GRAD_TOL), ("dk", dk, pdk, smoke.GRAD_TOL),
            ("dv", dv, pdv, smoke.GRAD_TOL)):
        worst, ratio, good = smoke._within(got, want, tol)
        ok = ok and good
        parts.append(f"{name} {worst:.3g} ({ratio:.3g} of the limit"
                     f"{'' if good else ', FAILS'})")
    print(f"[check] f32 D={D} {b}x{h} kv={kvh} S={s} {mode} "
          f"window={window}: max abs err {', '.join(parts)} | {card}",
          flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose f32 "
                    "flash libraries to build and compare")
    ap.add_argument("--variants", default="",
                    help="edited copies of dq and dkv to build and time, "
                    f"comma-separated, each joinable by '+': "
                    f"{', '.join(VARIANTS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_f32_d256: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.nvidia_smi("name,power.limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(list(LIBS) + [philox.KERNEL])
    parent = d256.build_parent(args.parent, LIBS) if args.parent else {}
    for name in LIBS:
        by_d = smoke._ptxas_by_head_dim(name)
        print(f"[build] {name} by head dim: " + "; ".join(
            f"D={d}: {min(r)}-{max(r)} registers, spill stores {max(st)} / "
            f"loads {max(ld)} bytes" for d, (r, st, ld) in by_d.items()),
            flush=True)
        mine = smoke.sass_by_function(build.library_path(name))
        print(f"[build] {name}: digest of D <= 128 "
              f"{smoke.narrow_sass_digest(build.library_path(name))}; "
              f"kernels by (name, D, mode): {sorted(mine)}", flush=True)
        if name in parent:
            theirs = smoke.sass_by_function(parent[name])
            same = [mine.get(key) == code for key, code in theirs.items()
                    if key[1] <= 128]
            print(f"[check] {name}: {sum(same)} of the parent's {len(same)} "
                  f"kernels run the same SASS here; parent digest "
                  f"{smoke.narrow_sass_digest(parent[name])}; first "
                  f"difference: {d256.sass_diff(mine, theirs)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ok = all([small_case(*case, rnd, card) for case in SMALL])
    if not ok:
        print("[check] a small case fails: the full check is skipped",
              flush=True)
        return 1
    if args.variants:
        time_variants(args.variants.split(","), rnd, card)
    state = {"smi": card}
    smoke._flash_kernels_wide(state, rnd, smoke.issue_ops_per_s(),
                              torch.float32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
