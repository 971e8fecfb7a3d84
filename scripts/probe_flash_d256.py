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
``chip_smoke.narrow_sass_digest`` of both builds (the values of
``chip_smoke.FLASH_NARROW_SASS``). Then, at D = 256, it holds the
forward, dq and dkv against their plain versions
(``chip_smoke.BF16_FLASH_TOL``, lse at ``chip_smoke.FWD_TOL``) in dropout
modes none, fused, premask and replay, with MHA, GQA and
recurrentgemma-9b's MQA (16 query heads, one kv head) and its local
window of 2048 at S = 4096, and at SQ = 192 and 320 (SQ % 128 == 64: the
last CTA of the forward and dq has one row group), printing each
output's share of its limit and not stopping; plants the smoke's fault
in the keep bits (the checks must fail it); checks replay, fused and
premask bitwise equal at recurrentgemma's shape; prints the share of
the bf16 O, dq, dk and dv values that differ from the plain version's
there, replay with the window (of the tree's kernels and, with
``--parent``, of the parent's); and times the three kernels there
(replay) beside SDPA's causal forward and backward on the same inputs,
and, with ``--parent``, each of them in turns with the parent's (parent,
tree, tree, parent) in every mode with the window (the forward by CUDA
events, dq and dkv by the profiler). With ``--variants a,b`` (each
joinable by "+") it builds edited copies of the tree's dq and dkv, prints
their ptxas counts and times them in replay and none with the window,
after the tree and before it again (every output but n128's wrong by
design):

  noscores  no score product issued (S, dP; S^T, dP^T);
  noout     no output product issued (dq += dS K; dV, dK);
  noxchg    dkv's consumers not waiting for each other at the exchange;
  noload    no Q, dO (dkv) or K, V (dq) tile loaded past the first
            stages: each barrier completed by its arrival;
  noturns   dq's consumers issuing without turns;
  n128      dq += dS K as two m64n128k16 products a part and slice, not
            one m64n256k16;
  solo      dq's second consumer without rows (half of dq left unwritten).

With ``--sass`` it prints, for each D = 256 kernel of the tree (the
replay instance), its SASS as a trace of its wgmma (G and the shape),
warpgroup fences (A: WARPGROUP.ARRIVE, D: WARPGROUP.DEPBAR and its
argument) and barriers (B), with the count of other instructions between
them.

    python3 scripts/probe_flash_d256.py [--parent DIR] [--variants a,b]
        [--sass]

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
BWD = ("flash_dq_bf16", "flash_dkv_bf16")

# variant -> (file in csrc, text, its replacement, count)
VARIANTS = {
    "noscores": [
        ("flash_dkv_bf16.cu", "      wgmma_ss_n32(st, ",
         "      if (j < 0) wgmma_ss_n32(st, ", 1),
        ("flash_dkv_bf16.cu", "      wgmma_ss_n32(dpt, ",
         "      if (j < 0) wgmma_ss_n32(dpt, ", 1),
        ("flash_dq_bf16.cu", "        wgmma_ss_n64(sc, desc_k<D>(qa, jj)",
         "        if (jj < 0) wgmma_ss_n64(sc, desc_k<D>(qa, jj)", 1),
        ("flash_dq_bf16.cu", "        wgmma_ss_n64(dp, desc_k<D>(da, jj)",
         "        if (jj < 0) wgmma_ss_n64(dp, desc_k<D>(da, jj)", 1)],
    "noout": [
        ("flash_dkv_bf16.cu", "      wgmma_rs<128>(acc, ",
         "      if (i < 0) wgmma_rs<128>(acc, ", 1),
        ("flash_dq_bf16.cu", "          wgmma_rs<D>(dq, ",
         "          if (i < 0) wgmma_rs<D>(dq, ", 1)],
    "noxchg": [
        ("flash_dkv_bf16.cu", "    named_sync(kXchgBarrier, 2 * WG);\n", "",
         2)],
    "noload": [
        ("flash_dkv_bf16.cu", """        mbar_expect_tx(f, 2 * TILE + kStageRows);
        load_tile<D>(""", """        mbar_expect_tx(f, it < 2 ? 2 * TILE + kStageRows : 0);
        if (it < 2) load_tile<D>(""", 1),
        ("flash_dkv_bf16.cu", """        load_tile<D>(st + TILE, &map_do""",
         """        if (it < 2) load_tile<D>(st + TILE, &map_do""", 1),
        ("flash_dkv_bf16.cu", """        bulk_load(rows + s * kStageRows, """,
         """        if (it < 2) bulk_load(rows + s * kStageRows, """, 1),
        ("flash_dkv_bf16.cu", """        bulk_load(rows + s * kStageRows + 256,""",
         """        if (it < 2) bulk_load(rows + s * kStageRows + 256,""", 1),
        ("flash_dq_bf16.cu", """        mbar_expect_tx(full + 8 * slot, TILE);
        load_tile<D>(""", """        mbar_expect_tx(full + 8 * slot, tile < kSlots ? TILE : 0);
        if (tile < kSlots) load_tile<D>(""", 1)],
    "noturns": [
        ("flash_dq_bf16.cu", "  const bool pingpong = groups == 2;",
         "  const bool pingpong = false;", 1)],
    "n128": [
        ("flash_dq_bf16.cu",
         "          wgmma_rs<D>(dq, a[i][jj], desc_mn<D>(ks, jj), 1);",
         """          for (int hf = 0; hf < 2; ++hf)
            wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(dq + 64 * hf),
                          a[i][jj], desc_mn<D>(ks + hf * 16384, jj), 1);""",
         1)],
    "solo": [
        ("flash_dq_bf16.cu",
         "  const int groups = map::fwd_bf16_has_rows(qi, 1, p.SQ) ? 2 : 1;",
         "  const int groups = 1;", 1)],
}


def sass_trace(code, limit=6000) -> str:
    """A kernel's SASS as a trace of its wgmma, warpgroup fences and
    barriers, with the count of other instructions between them."""
    import re
    out, run = [], 0
    for ins in code:
        op = ins.split()[0] if not ins.startswith("@") else ins.split()[1]
        if op.startswith("HGMMA"):
            m = re.search(r"64x(\d+)x16", op)
            tok = f"G{m.group(1) if m else ''}"
        elif op.startswith("WARPGROUP.ARRIVE"):
            tok = "A"
        elif op.startswith("WARPGROUP.DEPBAR"):
            m = re.search(r"0x(\w+)", ins)
            tok = f"D{m.group(1) if m else ''}"
        elif op.startswith(("BAR.", "SYNCS.")):
            tok = "B"
        else:
            run += 1
            continue
        if run:
            out.append(f"({run})")
            run = 0
        out.append(tok)
    return " ".join(out)[:limit]


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


def build_variant(name: str) -> dict:
    """dq and dkv from a copy of csrc with the variant's edits (``name``
    joined by "+"): library name -> (library, ptxas log)."""
    import shutil
    from probe_flash_f32_d256_split import nvcc_all
    root = build.build_dir() / "probe_flash_d256" / name
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(build.CSRC, csrc)
    for part in name.split("+"):
        for fname, old, new, count in VARIANTS[part]:
            path = csrc / fname
            text = path.read_text()
            if text.count(old) != count:
                raise RuntimeError(f"variant {part}: {text.count(old)} of "
                                   f"{count} texts found in {fname}")
            path.write_text(text.replace(old, new))
    return nvcc_all(csrc, root, BWD, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose flash "
                    "libraries to build and compare")
    ap.add_argument("--variants", default="",
                    help=f"edited copies to time: {', '.join(VARIANTS)}")
    ap.add_argument("--sass", action="store_true",
                    help="print the D = 256 kernels' wgmma traces")
    args = ap.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    if not torch.cuda.is_available():
        print("probe_flash_d256: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.nvidia_smi("name,power.limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(list(LIBS) + [philox.KERNEL])
    parent = build_parent(args.parent) if args.parent else {}
    built = {name: build_variant(name) for name in variants}
    for name, libs in built.items():
        for lib, (_, log) in libs.items():
            for kernel, (regs, st, ld, frame) in ptxas_wide(log).items():
                print(f"[build] {name} {lib} {kernel} D=256: {min(regs)}-"
                      f"{max(regs)} registers, spill stores {max(st)}, stack "
                      f"frame {max(frame)} bytes | {card}", flush=True)
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
    for name in LIBS:
        advisories = sorted({line.split("(C75")[1][:200] for line in
                             build.log_path(name).read_text().splitlines()
                             if "(C75" in line})
        print(f"[build] {name}: ptxas advisories {advisories} | {card}",
              flush=True)
    for name, libs in built.items():
        for lib, (_, log) in libs.items():
            advisories = sorted({line.split("(C75")[1][:200] for line in
                                 log.splitlines() if "(C75" in line})
            print(f"[build] {name} {lib}: ptxas advisories {advisories}",
                  flush=True)
            for key, code in smoke.sass_by_function(libs[lib][0]).items():
                if args.sass and key[1] == D and key[2] == 2:
                    print(f"[sass] {name} {lib} {key[0]} D=256 replay: "
                          f"{sass_trace(code)}", flush=True)
    for name in LIBS if args.sass else ():
        for key, code in smoke.sass_by_function(
                build.library_path(name)).items():
            if key[1] == D and key[2] == 2:
                print(f"[sass] {name} {key[0]} D=256 replay: "
                      f"{sass_trace(code)}", flush=True)
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

    # replay, fused and premask consume the same bits: bitwise the same
    ops = {"premask": philox.philox_dropout_mask_plain(
        b, h, s, s, 0.1, torch.tensor(9), 3, device="cuda"), "replay": op}
    outs = {}
    for mode in ("premask", "replay", "fused"):
        mk = dict(causal=True, local_window=win, dropout_p=0.1, mode=mode,
                  seed=torch.tensor(9), salt=3)
        outs[mode] = smoke.flash_outputs(q, k, v, do, ops.get(mode), mk)
    same = all(torch.equal(x, y) for mode in ("replay", "fused")
               for x, y in zip(outs[mode], outs["premask"]))
    print(f"[check] D=256 {b}x{h} kv=1 S={s} window={win}: replay == fused "
          f"== premask bitwise (o, dq, dk, dv): {same} | {card}", flush=True)
    ok &= same
    del outs

    # the share of each output's bf16 values off the plain version's
    po, plse = flash.flash_attention_fwd_plain(q, k, v, op, **kw)
    want = (po, *flash_bwd.flash_attention_bwd_plain(q, k, v, po, plse, do,
                                                     op, **kw))
    libs = {"fwd": "flash_fwd_bf16", "dq": "flash_dq_bf16",
            "dkv": "flash_dkv_bf16"}
    entries = {kind: smoke.parent_kernel(kind, torch.bfloat16, parent[lib])
               for kind, lib in libs.items() if lib in parent}
    for who, swapped in (("tree", ()), ("parent", entries.values())):
        if who == "parent" and not entries:
            continue
        got = smoke.flash_outputs(q, k, v, do, op, kw, swapped)
        print(f"[check] {who} D=256 {b}x{h} kv=1 S={s} window={win} replay: "
              f"{smoke.differing_shares(got, want)} | {card}", flush=True)
    del want, po, plse

    # in turns with the parent's, every mode with the window
    for kind, (module, kname, fn) in entries.items():
        for mode in MODES:
            mk = dict(causal=True, local_window=win, dropout_p=0.1,
                      mode=mode, seed=torch.tensor(9), salt=3)
            theirs, mine = smoke.in_turns(kind, module, kname, fn, q, k, v,
                                          do, ops.get(mode), mk)
            print(f"[time] {kind} D=256 {b}x{h} kv=1 S={s} window={win} "
                  f"{mode}: in turns (parent, tree, tree, parent) "
                  f"{theirs[0]:.4f}, {mine[0]:.4f}, {mine[1]:.4f}, "
                  f"{theirs[1]:.4f} ms: the tree "
                  f"{sum(theirs) / sum(mine):.3f}x the parent's | {card}",
                  flush=True)

    # the variants, between two turns of the tree, replay and none
    for mode in ("replay", "none"):
        mk = dict(causal=True, local_window=win, dropout_p=0.1, mode=mode,
                  seed=torch.tensor(9), salt=3)
        mo, ml = flash.flash_attention_fwd(q, k, v, ops.get(mode),
                                           return_lse=True, **mk)
        for kind in ("dq", "dkv") if built else ():
            tree = flash_bwd._kernel_fn(flash_bwd.KERNELS[torch.bfloat16][
                kind == "dkv"])
            times = [("tree", smoke.time_flash(kind, q, k, v, do,
                                               ops.get(mode), mk, mo, ml))]
            for name, libs in built.items():
                module, kname, fn = smoke.parent_kernel(
                    kind, torch.bfloat16, libs[BWD[kind == "dkv"]][0])
                try:
                    module._fns[kname] = fn
                    times.append((name, smoke.time_flash(
                        kind, q, k, v, do, ops.get(mode), mk, mo, ml)))
                finally:
                    module._fns[kname] = tree
            times.append(("tree", smoke.time_flash(kind, q, k, v, do,
                                                   ops.get(mode), mk, mo,
                                                   ml)))
            print(f"[time] {kind} D=256 {b}x{h} kv=1 S={s} window={win} "
                  f"{mode}: " + ", ".join(f"{who} {ms:.4f}"
                                          for who, ms in times)
                  + f" ms | {card}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
