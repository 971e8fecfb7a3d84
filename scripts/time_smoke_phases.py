#!/usr/bin/env python3
"""Seconds of named ``chip_smoke.py`` phases for several checkouts on one
machine, in turns. A probe, not part of the port.

The smoke's CPU-bound phases (4, the card-against-CPU training runs; 10,
fused mode; 12, the f32 Griffin) take their time partly on the host, so
their seconds move between machines. To tell a change's cost from a
slower host, this runs the named phases of each checkout, in the order
the checkouts are given (parent, change, change, parent), one child
process a turn, all on the same machine, and prints each phase's seconds,
each card-against-CPU run's seconds (phase 4's ``_card_vs_cpu``), and a
host yardstick taken in every child before its phases (a fixed CPU matmul
loop on torch's threads and a fixed single-threaded Python loop: they
move with the host, never with the checkout).

    python3 scripts/time_smoke_phases.py --turns ROOT:PHASE,PHASE ...

Each ROOT is the root of a checkout (``git archive <commit> | tar -x -C
DIR``, DIR under ``build/``; ``.`` for this one), each PHASE the name of
one of its ``chip_smoke.py`` phase functions (``phase_train_reference``,
...). The checkouts share one kernel build directory (the libraries are
named by the digest of their sources, so a checkout with the same kernel
sources reuses them). Needs one NVIDIA GPU and nvcc; each child prints the
card's name and power limit (phase 0).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def yardstick() -> str:
    """Seconds of a fixed CPU matmul loop and of a fixed Python loop."""
    import torch
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(1024, 1024, generator=gen)
    torch.mm(a, a)
    t0 = time.perf_counter()
    for _ in range(300):
        torch.mm(a, a)
    mm = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = 0
    for i in range(20_000_000):
        acc += i * i % 7
    py = time.perf_counter() - t0
    return (f"host yardstick: 300 CPU matmuls 1024^2 f32 {mm:.3f} s on "
            f"{torch.get_num_threads()} threads, a Python loop of 2e7 "
            f"{py:.3f} s; {os.cpu_count()} CPUs")


def child(root: Path, phases: list[str]) -> int:
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as s
    from repro_torch.kernels import build
    state = {"philox_err": 0}
    s.phase_card(state)
    tag = root.name if root != ROOT else "this checkout"
    print(f"[phases] {tag}: {yardstick()} | {state['smi']}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[phases] {tag}: kernels built or found in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card_vs_cpu = s._card_vs_cpu

    def timed(cfg, run, master, label, **kw):
        t = time.perf_counter()
        card_vs_cpu(cfg, run, master, label, **kw)
        print(f"[phases] {tag}: {cfg.name} {label} "
              f"{time.perf_counter() - t:.1f} s", flush=True)

    s._card_vs_cpu = timed
    for name in phases:
        t = time.perf_counter()
        getattr(s, name)(state)
        print(f"[phases] {tag}: {name} {time.perf_counter() - t:.1f} s | "
              f"{state['smi']}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", nargs="+", default=[],
                    help="ROOT:PHASE,PHASE,... one a turn, in order")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phases", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(Path(args.child).resolve(), args.phases.split(","))
    if not args.turns:
        ap.error("--turns is required")
    env = dict(os.environ)
    env.setdefault("REPRO_TORCH_BUILD_DIR",
                   str(ROOT / "build" / "repro_torch"))
    rc = 0
    for turn in args.turns:
        root, _, phases = turn.partition(":")
        print(f"[phases] turn {root}: {phases}", flush=True)
        rc |= subprocess.run([sys.executable, __file__, "--child", root,
                              "--phases", phases], env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
