#!/usr/bin/env python3
"""The bf16 flash kernels at head_dim 256 on the card. A probe, not part
of the port: it builds the bf16 forward, dq and dkv (and the f32 forward,
which shares the forward's body) and prints ptxas's registers and spills
by head dim, and the registers, spills and stack frame of each D = 256
kernel; with ``--parent DIR`` (the root of another checkout, e.g.
unpacked from ``git archive <commit>`` into a directory under ``build/``)
it builds that checkout's four libraries too and compares each kernel at
head dims up to 128 with the parent's, instruction for instruction
(cuobjdump's SASS; the first difference printed), and each library's
``chip_smoke.narrow_sass_digest`` and ``wide_sass_digest`` of both
builds. Then, at D = 256, it holds the forward, dq and dkv against their
plain versions (``chip_smoke.BF16_FLASH_TOL``, lse at
``chip_smoke.FWD_TOL``) in dropout modes none, fused, premask and replay,
with MHA, GQA and recurrentgemma-9b's MQA (16 query heads, one kv head)
and its local window of 2048 at S = 4096, and at SQ = 192 and 320 (SQ %
128 == 64: the forward's last CTA has one row group), printing each
output's share of its limit and not stopping; plants the smoke's fault
in the keep bits (the checks must fail it); prints the share of O's bf16
values that differ from the plain version's at recurrentgemma's shape
(of the tree's forward and, with ``--parent``, of the parent's); and
times the three kernels there (replay) beside SDPA's causal forward and
backward on the same inputs, and, with ``--parent``, the forward in
turns with the parent's (parent, tree, tree, parent) in every mode with
the window.

    python3 scripts/probe_flash_d256.py [--parent DIR]

Needs one NVIDIA Hopper GPU and nvcc; prints one line a check and a
timing, each with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
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
from probe_flash_f32_d256_split import ptxas_wide  # noqa: E402

LIBS = ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16", "flash_fwd_f32")
D = 256
# (mode, local window, kv heads, B, H, S)
CASES = (("none", 0, 16, 1, 16, 2048), ("fused", 0, 16, 1, 16, 2048),
         ("premask", 0, 16, 1, 16, 2048), ("replay", 0, 16, 1, 16, 2048),
         ("replay", 0, 1, 1, 16, 2048), ("replay", 2048, 1, 1, 16, 4096),
         ("none", 0, 2, 2, 4, 192), ("premask", 128, 2, 1, 4, 320),
         ("replay", 64, 1, 1, 2, 320), ("fused", 0, 4, 1, 4, 192))
MODES = ("none", "premask", "replay", "fused")
FWD = flash.KERNELS[torch.bfloat16]


def build_parent(parent, names=LIBS) -> dict:
    """The parent's libraries ``names``, one nvcc each, started
    together."""
    out = build.build_dir() / "probe_flash_d256"
    out.mkdir(parents=True, exist_ok=True)
    csrc = Path(parent) / "src/repro_torch/kernels/csrc"
    procs = {}
    for name in names:
        lib = out / f"libparent_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"parent {name}: nvcc failed\n{log}")
        libs[name] = lib
    return libs


def sass_diff(mine: dict, theirs: dict, lines: int = 40) -> str:
    """The first lines of a unified diff of the first kernel at D <= 128
    whose SASS differs."""
    import difflib
    for key, code in sorted(theirs.items()):
        if key[1] <= 128 and mine.get(key) != code:
            diff = difflib.unified_diff(code, mine.get(key, ()), "parent",
                                        "tree", n=1, lineterm="")
            return f"{key}:\n" + "\n".join(list(diff)[:lines])
    return "none"


def check_case(mode, window, kvh, b, h, s, rnd, card) -> bool:
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
    tol = smoke.BF16_FLASH_TOL
    ratios, good = [], True
    for name, got, want, t, scaled in (
            ("o", o, po, tol, True), ("lse", lse, plse, smoke.FWD_TOL, False),
            ("dq", dq, pdq, tol, True), ("dk", dk, pdk, tol, True),
            ("dv", dv, pdv, tol, True)):
        finite = bool(torch.isfinite(got.float()).all())
        worst, ratio, ok = smoke._within(got.float(), want.float(), t,
                                         scaled)
        good = good and ok and finite
        ratios.append(f"{name} {ratio:.3g}{'' if ok and finite else ' FAILS'}")
    print(f"[check] D=256 {b}x{h} S={s} {mode} window={window} "
          f"kv_heads={kvh}: {', '.join(ratios)} of their limits | {card}",
          flush=True)
    if good and mode == "premask" and kvh == h:
        smoke._flash_fault("flash bf16 D=256", q, k, v, do, plane,
                           (o, dq, dk, dv), (tol, tol), True)
    return good


def fwd_fn(lib):
    """The bf16 forward's entry point in the library at ``lib``, with the
    tree's argument types."""
    tree = flash._kernel_fn(FWD)
    fn = getattr(ctypes.CDLL(str(lib)), f"repro_{FWD}")
    fn.argtypes, fn.restype = tree.argtypes, ctypes.c_int
    return fn


def rounding_share(q, k, v, op, kw) -> float:
    """The share of the installed forward's bf16 O values that differ from
    the plain version's."""
    o = flash.flash_attention_fwd(q, k, v, op, **kw)
    po, _ = flash.flash_attention_fwd_plain(q, k, v, op, **kw)
    return float((o != po).float().mean())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose flash "
                    "libraries to build and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_d256: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.nvidia_smi("name,power.limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(list(LIBS) + [philox.KERNEL])
    parent = build_parent(args.parent) if args.parent else {}
    for name in LIBS:
        for kernel, (regs, st, ld, frame) in ptxas_wide(
                build.log_path(name).read_text()).items():
            print(f"[build] {name} {kernel} D=256: {min(regs)}-{max(regs)} "
                  f"registers, spill stores {max(st)} / loads {max(ld)} "
                  f"bytes, stack frame {max(frame)} bytes; by instance "
                  f"(registers, spill stores, stack frame): "
                  f"{list(zip(regs, st, frame))} | {card}", flush=True)
        by_d = smoke._ptxas_by_head_dim(name)
        print(f"[build] {name} by head dim: " + "; ".join(
            f"D={d}: {min(r)}-{max(r)} registers, spill stores {max(st)} / "
            f"loads {max(ld)} bytes" for d, (r, st, ld) in by_d.items()),
            flush=True)
        mine = smoke.sass_by_function(build.library_path(name))
        print(f"[build] {name}: digest of D <= 128 "
              f"{smoke.narrow_sass_digest(build.library_path(name))}",
              flush=True)
        if name in parent:
            theirs = smoke.sass_by_function(parent[name])
            same = [mine.get(key) == code for key, code in theirs.items()
                    if key[1] <= 128]
            print(f"[check] {name}: {sum(same)} of the parent's {len(same)} "
                  f"kernels run the same SASS here; parent digest "
                  f"{smoke.narrow_sass_digest(parent[name])}; first "
                  f"difference: {sass_diff(mine, theirs)}", flush=True)
        line = (f"[sass] {name}: tree wide "
                f"{smoke.wide_sass_digest(build.library_path(name))}")
        if name in parent:
            line += f"; parent wide {smoke.wide_sass_digest(parent[name])}"
        print(line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    ok = True
    for case in CASES:
        ok &= check_case(*case, rnd, card)
    if not ok:
        print("[check] a check fails: no timing", flush=True)
        return 1

    # timing at recurrentgemma-9b's LOCAL layer: B=1, 16 heads, MQA, S=4096,
    # window 2048, replay
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    b, h, kvh, s, win = 1, 16, 1, 4096, 2048
    q, do = rnd(b, h, s, D), rnd(b, h, s, D)
    k, v = rnd(b, kvh, s, D), rnd(b, kvh, s, D)
    op = seed_salt_smem(torch.tensor(9), 3)
    kw = dict(causal=True, local_window=win, dropout_p=0.1, mode="replay")
    o, lse = flash.flash_attention_fwd(q, k, v, op, return_lse=True, **kw)
    fwd_ms = smoke.cuda_time_ms(lambda: flash.flash_attention_fwd(
        q, k, v, op, **kw), 10)
    bwd = lambda: flash_bwd.flash_attention_bwd(  # noqa: E731
        q, k, v, o, lse, do, op, **kw)
    dq_ms = smoke.device_time_ms(bwd, "flash_dq_kernel", 10)
    dkv_ms = smoke.device_time_ms(bwd, "flash_dkv_kernel", 10)
    pairs = smoke.valid_pairs(s, s, True, win)
    ke, ve = (t.expand(b, h, s, D) for t in (k, v))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, ke, ve))
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    lib_fwd = smoke.cuda_time_ms(lambda: sdpa(q, ke, ve, is_causal=True), 10)
    lib_bwd = smoke.cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), do, retain_graph=True), 10)
    ops_rate = smoke.issue_ops_per_s()
    for kind, ms in (("fwd", fwd_ms), ("dq", dq_ms), ("dkv", dkv_ms)):
        bound, by = smoke.flash_bound(kind, b, h, s, D, pairs, elem=2,
                                      flops_rate=smoke.BF16_FLOPS_PER_S,
                                      ops_rate=ops_rate)
        print(f"[time] D=256 {kind} {b}x{h} kv=1 S={s} window={win} replay: "
              f"{ms:.4f} ms; bound {bound:.4f} ms by {by} "
              f"({bound / ms * 100:.1f}%) | {card}", flush=True)
    print(f"[time] SDPA bf16 D=256 causal (no window, kv expanded): forward "
          f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms | {card}", flush=True)

    tree_fn = flash._kernel_fn(FWD)
    builds = {"tree": tree_fn}
    if "flash_fwd_bf16" in parent:
        builds["parent"] = fwd_fn(parent["flash_fwd_bf16"])
    try:
        for who, fn in builds.items():
            flash._fns[FWD] = fn
            share = rounding_share(q, k, v, op, kw)
            print(f"[check] {who} forward D=256 {b}x{h} kv=1 S={s} window="
                  f"{win} replay: {share * 100:.4f} % of O's bf16 values "
                  f"differ from the plain version's | {card}", flush=True)
        if "parent" in builds:
            ops = {"premask": philox.philox_dropout_mask_plain(
                b, h, s, s, 0.1, torch.tensor(9), 3, device="cuda"),
                   "replay": op}
            for mode in MODES:
                mk = dict(causal=True, local_window=win, dropout_p=0.1,
                          mode=mode, seed=torch.tensor(9), salt=3)
                times = []
                for who in ("parent", "tree", "tree", "parent"):
                    flash._fns[FWD] = builds[who]
                    times.append(smoke.cuda_time_ms(
                        lambda: flash.flash_attention_fwd(
                            q, k, v, ops.get(mode), **mk), 10))
                print(f"[time] forward D=256 {b}x{h} kv=1 S={s} window={win}"
                      f" {mode}: in turns (parent, tree, tree, parent) "
                      f"{', '.join(f'{t:.4f}' for t in times)} ms: the tree "
                      f"{(times[0] + times[3]) / (times[1] + times[2]):.3f}x "
                      f"the parent's | {card}", flush=True)
    finally:
        flash._fns[FWD] = tree_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
