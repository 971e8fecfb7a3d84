#!/usr/bin/env python3
"""The split f32 flash forward, dq and dkv at head_dim 256 on the card. A
probe, not part of the port: it builds the six flash libraries and prints
ptxas's registers and spills of the f32 ones by head dim; with ``--parent
DIR`` (the root of another checkout, e.g. unpacked from ``git archive
<commit>`` into a directory under ``build/``) it builds that checkout's
six libraries beside them, one nvcc each, all started together, and
prints each library's ``chip_smoke.narrow_sass_digest`` (D <= 128) of
both builds: the values of ``chip_smoke.FLASH_NARROW_SASS``.

Then it holds the forward, dq and dkv at D = 256 against their plain
versions on small MQA / GQA shapes and at recurrentgemma-9b's LOCAL layer
(``chip_smoke.WIDE_SHAPE``: 1 x 16 x 4096 x 256, one kv head) in the four
dropout modes, with and without its window of 2048, printing each
output's share of its limit (F32_FWD_TOL for O and lse, GRAD_TOL for dq,
dk, dv) without stopping, and times the forward (CUDA events) and dq and
dkv (the profiler's device time a call; dq's is its split pass and its
products) at that shape with the window in the
four modes, in turns with the parent's (parent, tree, tree, parent) and
with edited copies of the tree (``--variants a,b``, each joinable by
"+"; their ptxas counts and checks printed too):

  serial    the forward's next step's slices split after the step's
            products are done, not while they run;
  noexp     no exponentials (the forward's softmax, dkv's P): a wrong
            output, for timing;
  noxchg    dq's partial scores not exchanged: a wrong output, for
            timing;
  nofill    no walked slice loaded or split (the products read what the
            buffers hold; dq: no triples written, no bulk copy issued, each
            part's barrier completed by an arrival): a wrong output, for
            timing.

The checks of the variants that give a wrong output by design (WRONG) are
printed and do not stop the timing.

    python3 scripts/probe_flash_f32_d256_split.py [--parent DIR]
        [--variants serial,noexp,..] [--iters N]

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
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build, philox  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd  # noqa
from repro_torch.kernels.philox_common import seed_salt_smem  # noqa: E402

F32 = ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")
LIBS = F32 + ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16")
D = 256
# (mode, local window, kv heads, B, H, S): small shapes first
SMALL = (("none", 0, 1, 1, 2, 128), ("premask", 0, 1, 1, 2, 128),
         ("replay", 0, 1, 1, 2, 256), ("fused", 64, 1, 1, 2, 256),
         ("replay", 0, 2, 2, 4, 192), ("premask", 128, 2, 1, 4, 320))
MODES = ("none", "premask", "replay", "fused")
# variants whose output is wrong by design, for timing
WRONG = ("noexp", "nofill", "noxchg")

# variant -> (file in csrc, text, its replacement, count)
VARIANTS = {
    "noexp": [("flash_fwd_f32.cu", "expf(sc[4 * g + 2 * hh + e] - m_new)",
               "(sc[4 * g + 2 * hh + e] - m_new)", 1),
              ("flash_dkv_f32.cu", "expf(x - ld_shared_f1(rows + 4 * qc))",
               "(x - ld_shared_f1(rows + 4 * qc))", 1)],
    "nofill": [("flash_f32_wide.cuh", """  for (int i = 0; i < 64 * SW / 8 / THREADS; ++i) {
    const int u = t + THREADS * i;
    store_unit(""", """  for (int i = 0; i < 0; ++i) {
    const int u = t + THREADS * i;
    store_unit(""", 1),
               ("flash_dq_f32.cu", """    mbar_expect_tx(bar, SLICE);
    bulk_load(""", """    mbar_arrive(bar);
    if (false) bulk_load(""", 1),
               ("flash_dq_f32.cu", "<<<dim3(blocks, 2), wide::THREADS",
                "<<<dim3(1, 1), wide::THREADS", 1)],
    "noxchg": [("flash_dq_f32.cu", """  for (int round = 0; round < 2; ++round) {
    if (wg == 0) {""", """  for (int round = 0; round < 0; ++round) {
    if (wg == 0) {""", 1)],
    "serial": [("flash_fwd_f32.cu", """          fill();
          wgmma_wait0();""", """          wgmma_wait0();
          fill();""", 2)]
}


def nvcc_all(csrc: Path, out: Path, names, tag: str) -> dict:
    """Each library of ``names`` from the sources in csrc into out, one
    nvcc each, started together: name -> (library, ptxas log)."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out / f"lib{tag}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{tag} {name}: nvcc failed\n{log}")
        libs[name] = (lib, log)
    return libs


def ptxas_wide(log: str) -> dict:
    """kernel name -> (registers, spill stores, spill loads, stack frame
    bytes) of its D = 256 instances in a ptxas log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(flash_\w*?kernel\w*?)ILi(\d+)E", line)
        if "Compiling entry" in line:
            name = m.group(1) if m and m.group(2) == "256" else None
            continue
        if not name:
            continue
        rec = out.setdefault(name, ([], [], [], []))
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line):
            rec[3].append(int(m.group(1)))
            rec[1].append(int(m.group(2)))
            rec[2].append(int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            rec[0].append(int(m.group(1)))
    return out


def print_ptxas(tag: str, libs: dict, card: str) -> None:
    """Registers, spills and stack frame of each f32 D = 256 kernel, and
    how many of its instances ptxas's C7518 advisory names (their wgmma
    serialized)."""
    for name in F32:
        if name not in libs:
            continue
        log = libs[name][1]
        for kernel, (regs, st, ld, frame) in ptxas_wide(log).items():
            serialized = sum(1 for line in log.splitlines()
                             if "C7518" in line and kernel in line
                             and "ILi256E" in line)
            print(f"[build] {tag} {name} {kernel} D=256: {min(regs)}-"
                  f"{max(regs)} registers, spill stores {max(st)} / loads "
                  f"{max(ld)} bytes, stack frame {max(frame)} bytes, wgmma "
                  f"serialized (C7518) in {serialized} of {len(regs)} "
                  f"instances; by instance (registers, spill stores): "
                  f"{list(zip(regs, st))} | {card}", flush=True)


def edited_csrc(name: str) -> Path:
    """A copy of csrc with the variant's edits (``name`` joined by
    "+")."""
    out = build.build_dir() / "probe_f32_d256_split" / name / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(build.CSRC, out)
    for part in name.split("+"):
        for fname, old, new, count in VARIANTS[part]:
            path = out / fname
            text = path.read_text()
            if text.count(old) != count:
                raise RuntimeError(f"variant {part}: {text.count(old)} of "
                                   f"{count} texts found in {fname}")
            path.write_text(text.replace(old, new))
    return out


def entry_points(libs: dict) -> dict:
    """The fwd, dq and dkv entry points of a build's f32 libraries, with
    the tree's argument types."""
    tree = {flash.KERNEL: flash._kernel_fn(flash.KERNEL),
            flash_bwd.KERNEL_DQ: flash_bwd._kernel_fn(flash_bwd.KERNEL_DQ),
            flash_bwd.KERNEL_DKV: flash_bwd._kernel_fn(flash_bwd.KERNEL_DKV)}
    out = {}
    for kname, lib in ((flash.KERNEL, "flash_fwd_f32"),
                       (flash_bwd.KERNEL_DQ, "flash_dq_f32"),
                       (flash_bwd.KERNEL_DKV, "flash_dkv_f32")):
        if lib not in libs:
            out[kname] = tree[kname]
            continue
        fn = getattr(ctypes.CDLL(str(libs[lib][0])), f"repro_{kname}")
        fn.argtypes, fn.restype = tree[kname].argtypes, ctypes.c_int
        out[kname] = fn
    return out


def install(fns: dict) -> None:
    flash._fns[flash.KERNEL] = fns[flash.KERNEL]
    flash_bwd._fns[flash_bwd.KERNEL_DQ] = fns[flash_bwd.KERNEL_DQ]
    flash_bwd._fns[flash_bwd.KERNEL_DKV] = fns[flash_bwd.KERNEL_DKV]


def check(label, q, k, v, do, mode, window, card) -> bool:
    """The installed kernels against the plain versions: each output's
    share of its limit."""
    op = {"premask": philox.philox_dropout_mask_plain(
        q.shape[0], q.shape[1], q.shape[2], k.shape[2], 0.1,
        torch.tensor(9), 3, device="cuda"),
          "replay": seed_salt_smem(torch.tensor(9), 3)}.get(mode)
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
            ("o", o, po, smoke.F32_FWD_TOL),
            ("lse", lse, plse, smoke.F32_FWD_TOL),
            ("dq", dq, pdq, smoke.GRAD_TOL), ("dk", dk, pdk, smoke.GRAD_TOL),
            ("dv", dv, pdv, smoke.GRAD_TOL)):
        finite = bool(torch.isfinite(got).all())
        worst, ratio, good = smoke._within(got, want, tol)
        ok = ok and good and finite
        parts.append(f"{name} {ratio:.3g}{'' if good and finite else ' FAILS'}")
    b, h, s, _ = q.shape
    print(f"[check] {label} f32 D={D} {b}x{h} kv={k.shape[1]} S={s} {mode} "
          f"window={window}: {', '.join(parts)} of the limits | {card}",
          flush=True)
    return ok


def time_builds(builds: dict, order, q, k, v, do, iters, card) -> None:
    """Each build's forward (CUDA events), dq and dkv (the profiler) at
    the smoke's shape with its window, in every mode, builds in turns."""
    win = smoke.WIDE_CASES[-1][1]
    ops = {"premask": philox.philox_dropout_mask_plain(
        q.shape[0], q.shape[1], q.shape[2], k.shape[2], 0.1,
        torch.tensor(9), 3, device="cuda"),
           "replay": seed_salt_smem(torch.tensor(9), 3)}
    times = {}
    for name in order:
        install(builds[name])
        for mode in MODES:
            op = ops.get(mode)
            kw = dict(causal=True, local_window=win, dropout_p=0.1,
                      mode=mode, seed=torch.tensor(9), salt=3)
            o, lse = flash.flash_attention_fwd(q, k, v, op, return_lse=True,
                                               **kw)
            t = times.setdefault(name, {}).setdefault(mode, {})
            t.setdefault("fwd", []).append(smoke.cuda_time_ms(
                lambda: flash.flash_attention_fwd(q, k, v, op, **kw), iters))
            for kind in ("dq", "dkv"):
                t.setdefault(kind, []).append(smoke.device_time_ms(
                    lambda: flash_bwd.flash_attention_bwd(q, k, v, o, lse,
                                                          do, op, **kw),
                    f"flash_{kind}_kernel", iters))
    b, h, s, d = q.shape
    for name, by_mode in times.items():
        for mode, t in by_mode.items():
            print(f"[time] {name} {b}x{h}x{s}x{d} kv={k.shape[1]} "
                  f"window={win} {mode}: fwd {t['fwd']} ms (events), dq "
                  f"{t['dq']} ms, dkv {t['dkv']} ms (profiler), in turns | "
                  f"{card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose flash "
                    "libraries to build, compare and time")
    ap.add_argument("--variants", default="",
                    help="edited copies of the tree to build and time, "
                    f"comma-separated, each joinable by '+': "
                    f"{', '.join(VARIANTS)}")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_f32_d256_split: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.nvidia_smi("name,power.limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = build.build_dir() / "probe_f32_d256_split"
    variants = [n for n in args.variants.split(",") if n]
    # every build's nvcc at once: the tree's (through kernels/build.py),
    # the parent's, the variants'
    import concurrent.futures as cf
    others = ([("parent", Path(args.parent) / "src/repro_torch/kernels/csrc",
                LIBS)] if args.parent else []) + [
        (n, edited_csrc(n), F32)
        for n in variants]
    with cf.ThreadPoolExecutor(1 + len(others)) as pool:
        tree = pool.submit(build.build_all, list(LIBS) + [philox.KERNEL])
        futs = {tag: pool.submit(nvcc_all, csrc, out / tag, names, tag)
                for tag, csrc, names in others}
        tree.result()
        built = {"tree": {name: (build.library_path(name),
                                 build.log_path(name).read_text())
                          for name in LIBS}}
        for tag, f in futs.items():
            try:
                built[tag] = f.result()
            except RuntimeError as err:  # a variant the compiler refuses
                if tag == "parent":
                    raise
                print(f"[build] {tag}: not built: "
                      f"{str(err).splitlines()[0]}; "
                      f"{str(err).splitlines()[-1]} | {card}", flush=True)
    for tag, libs in built.items():
        print_ptxas(tag, libs, card)
    for name in LIBS:
        mine = build.library_path(name)
        line = f"[sass] {name}: tree narrow {smoke.narrow_sass_digest(mine)}"
        if "parent" in built:
            theirs = built["parent"][name][0]
            line += f"; parent narrow {smoke.narrow_sass_digest(theirs)}"
        print(line, flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    builds = {"tree": entry_points(built["tree"])}
    builds.update({tag: entry_points(built[tag])
                   for tag in built if tag != "tree"})
    ok = True
    def gates(tag):
        return not any(part in WRONG for part in tag.split("+"))

    for tag in builds:
        install(builds[tag])
        for mode, window, kvh, b, h, s in SMALL:
            good = check(tag, rnd(b, h, s, D), rnd(b, kvh, s, D),
                         rnd(b, kvh, s, D), rnd(b, h, s, D), mode, window,
                         card)
            ok &= good or not gates(tag)
    b, h, kvh, s, d = smoke.WIDE_SHAPE
    q, do = rnd(b, h, s, d), rnd(b, h, s, d)
    k, v = rnd(b, kvh, s, d), rnd(b, kvh, s, d)
    for tag in builds:
        install(builds[tag])
        for mode, window in (smoke.WIDE_CASES if gates(tag)
                             else smoke.WIDE_CASES[-1:]):
            good = check(tag, q, k, v, do, mode, window, card)
            ok &= good or not gates(tag)
    install(builds["tree"])
    if not ok:
        print("[check] a check fails: no timing", flush=True)
        return 1
    others = [t for t in builds if t != "tree"]
    order = [*others, "tree", "tree", *reversed(others)]
    time_builds(builds, order, q, k, v, do, args.iters, card)
    install(builds["tree"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
