#!/usr/bin/env python3
"""The standalone Philox kernel (``csrc/philox_mask.cu``) on its first
launch in a fresh process, many processes in a row. A probe, not part of
the port.

``chip_smoke.py`` once saw the kernel's first launch of its run differ
from the plain version at the serving plane (1 x 32 x 512 x 512, p = 0.1,
seed 0x1234, salt 7, 7 rounds), and the same check pass in every other
run. This probe repeats that launch as the first launch of each of
``--runs`` fresh child processes (``--jobs`` of them at a time on the one
card). Each child makes the plane three ways and holds them against one
another word by word:

- the kernel, through ``philox_dropout_mask`` (its vector-store instance,
  the output from ``torch.empty``, as the smoke calls it), and through
  ``philox_mask_into`` on a view 4 bytes into a buffer (off 16 bytes: its
  scalar-store instance), filled with 0x5A5A5A5A first; even children
  launch the vector instance first, odd ones the scalar one;
- the plain version on the card (``philox_dropout_mask_plain``, int64
  tensor ops on CUDA);
- the plain version on the CPU, made once by the parent process and read
  by every child.

A child prints one JSON line: its order, the persistent grid's CTAs a SM
(``repro_philox_mask_ctas_per_sm``) and, for each comparison, the count
of differing words and up to 16 of them as (b, h, word, k), both values
and their XOR. The parent prints the children's lines, then a summary:
runs, runs with any difference, and differing words by comparison.

    python3 scripts/probe_philox_first.py [--runs 300] [--jobs 6]

Needs one NVIDIA GPU and nvcc; each line carries the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, philox  # noqa: E402

SHAPE = (1, 32, 512, 512)   # (B, H, SQ, SK): the smoke's SERVE_SHAPE
P, SEED, SALT, ROUNDS = 0.1, 0x1234, 7, 7
SENTINEL = 0x5A5A5A5A
SHOWN = 16


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def differences(got: np.ndarray, want: np.ndarray) -> dict:
    """The count of words of ``got`` != ``want`` (uint32 planes (B, H,
    SQ/32, SK)) and the first SHOWN of them."""
    bad = np.argwhere(got != want)
    return {"count": int(len(bad)), "words": [
        {"at": [int(x) for x in idx], "got": int(got[tuple(idx)]),
         "want": int(want[tuple(idx)]),
         "xor": int(got[tuple(idx)] ^ want[tuple(idx)])}
        for idx in bad[:SHOWN]]}


def child(index: int, want_path: str) -> int:
    """One fresh process: the kernel's first launch, then the rest."""
    b, h, sq, sk = SHAPE
    cpu = np.load(want_path)
    vec_first = index % 2 == 0

    def vector():
        return philox.philox_dropout_mask(b, h, sq, sk, P, SEED, SALT,
                                          ROUNDS, device="cuda")

    def scalar():
        n = b * h * (sq // 32) * sk
        buf = torch.full((n + 1,), SENTINEL, dtype=torch.int32,
                         device="cuda")
        out = buf[1:].view(b, h, sq // 32, sk)
        assert out.data_ptr() % 16 == 4
        philox.philox_mask_into(out, **philox._key_args(P, SEED, SALT, 0),
                                rounds=ROUNDS)
        return out

    first, second = (vector, scalar) if vec_first else (scalar, vector)
    got = {first.__name__: first()}
    got[second.__name__] = second()
    plain = philox.philox_dropout_mask_plain(b, h, sq, sk, P, SEED, SALT,
                                             ROUNDS, device="cuda")
    torch.cuda.synchronize()
    words = {k: v.cpu().numpy().view(np.uint32) for k, v in got.items()}
    words["cuda_plain"] = plain.cpu().numpy().view(np.uint32)
    fn = build.load(philox.KERNEL).repro_philox_mask_ctas_per_sm
    out = {"child": index, "first": first.__name__,
           "ctas_per_sm": {"vector": fn(ROUNDS, 1), "scalar": fn(ROUNDS, 0)},
           "diff": {
               "vector_vs_cpu": differences(words["vector"], cpu),
               "scalar_vs_cpu": differences(words["scalar"], cpu),
               "cuda_plain_vs_cpu": differences(words["cuda_plain"], cpu),
               "vector_vs_cuda_plain": differences(words["vector"],
                                                   words["cuda_plain"])}}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=300)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--want", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.want)
    if not torch.cuda.is_available():
        print("probe_philox_first: no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    build.build_all([philox.KERNEL])      # the children load it, built once
    out_dir = build.build_dir() / "probe_philox_first"
    out_dir.mkdir(parents=True, exist_ok=True)
    want_path = out_dir / "cpu_plain.npy"
    b, h, sq, sk = SHAPE
    cpu = philox.philox_dropout_mask_plain(b, h, sq, sk, P, SEED, SALT,
                                           ROUNDS, device="cpu")
    np.save(want_path, cpu.numpy().view(np.uint32))
    print(f"[probe] plane {SHAPE} p={P} seed={SEED:#x} salt={SALT} "
          f"rounds={ROUNDS}: the CPU plain version made once; {args.runs} "
          f"fresh processes, {args.jobs} at a time | {card}", flush=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--want",
           str(want_path), "--child"]
    pending, running, lines, failed = list(range(args.runs)), [], [], []
    while pending or running:
        while pending and len(running) < args.jobs:
            i = pending.pop(0)
            running.append((i, subprocess.Popen(
                cmd + [str(i)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        time.sleep(0.2)
        for i, proc in list(running):
            if proc.poll() is None:
                continue
            running.remove((i, proc))
            text = proc.stdout.read()
            rec = None
            for line in text.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
            if proc.returncode or rec is None:
                failed.append(i)
                print(f"[probe] child {i} exit {proc.returncode}:\n{text}",
                      flush=True)
                continue
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    kinds = ("vector_vs_cpu", "scalar_vs_cpu", "cuda_plain_vs_cpu",
             "vector_vs_cuda_plain")
    words = {k: sum(r["diff"][k]["count"] for r in lines) for k in kinds}
    runs_bad = sum(any(r["diff"][k]["count"] for k in kinds) for r in lines)
    vec_first = sum(r["first"] == "vector" for r in lines)
    print(f"[probe] summary: {len(lines)} fresh processes ran (failed to "
          f"run: {failed or 'none'}), {vec_first} "
          f"launching the vector instance first; runs with any differing "
          f"word: {runs_bad}; differing words by comparison: {words}; "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
