#!/usr/bin/env python3
"""The aten operations one training step dispatches, counted, for several
checkouts. A probe, not part of the port.

A change that adds host work to a step adds operations to it; one that
adds none leaves the count as it was, so a time that moved anyway moved
with the host. This builds the reduced models of the smoke's CPU-bound
phases (llama2 and recurrentgemma at qkv / ffn_up, f32 and bf16 compute;
llama2 in fused mode on the tensor-op attention, phase 10's host-bound
step) with each checkout's own ``src/``, one child process a checkout,
runs one ``make_train_step`` step on the CPU under a dispatch mode that
counts every aten call (forward, backward and AdamW), and prints the
count of each run and the operations by name that differ between the
first checkout and each other one.

    python3 scripts/count_step_ops.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``git archive <commit> | tar -x -C
DIR``, DIR under ``build/``; ``.`` for this one). CPU only, about 10 s a
checkout.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
from pathlib import Path

# (arch, site, gemm dtype, compute dtype, mode, attention impl)
RUNS = (("llama2-7b", "qkv", "f32", "float32", "overlap", "pallas"),
        ("llama2-7b", "qkv", "bf16", "bfloat16", "overlap", "pallas"),
        ("llama2-7b", "xla", "f32", "float32", "fused", "xla"),
        ("llama2-7b", "xla", "f32", "bfloat16", "fused", "xla"),
        ("recurrentgemma-9b", "ffn_up", "f32", "float32", "overlap",
         "pallas"),
        ("recurrentgemma-9b", "ffn_up", "bf16", "bfloat16", "overlap",
         "pallas"))


def child(root: Path) -> dict:
    sys.path[:0] = [str(root / "src")]
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.config import get_arch
    from repro_torch.config.base import (DropoutPlanConfig, OptimizerConfig,
                                         RunConfig, ShapeConfig,
                                         ShardingConfig, StepKind,
                                         TrainConfig)
    from repro_torch.data import batch_for_step
    from repro_torch.optim import adamw_init
    from repro_torch.train import init_train_state, make_train_step

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    out = {}
    for arch, site, gemm, dt, mode, impl in RUNS:
        cfg = get_arch(arch, reduced=True)
        run = RunConfig(
            model=cfg, shape=ShapeConfig("count", 256, 2, StepKind.TRAIN),
            sharding=ShardingConfig(attn_impl=impl, remat="block"),
            dropout=DropoutPlanConfig(mode=mode, site=site, p=0.1,
                                      gemm_dtype=gemm, attn_replay="auto",
                                      seed=0),
            train=TrainConfig(optimizer=OptimizerConfig()))
        step = make_train_step(cfg, run, compute_dtype=getattr(torch, dt))
        st = {"master": init_train_state(cfg, seed=1, device="cpu")["master"],
              "step": 0}
        st["opt"] = adamw_init(st["master"])
        x, y = (torch.from_numpy(t) for t in
                batch_for_step(cfg, run.shape, 0, seed=0))
        step(st, x, y)              # first call: caches and schedules
        with Count() as c:
            step(st, x, y)
        out[f"{arch} {site}/{gemm} {dt} {mode} {impl}"] = dict(c.ops)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(Path(sys.argv[2]).resolve())))
        return 0
    roots = sys.argv[1:] or ["."]
    counts = []
    for root in roots:
        res = subprocess.run([sys.executable, __file__, "--child", root],
                             check=True, capture_output=True, text=True)
        counts.append(json.loads(res.stdout.splitlines()[-1]))
    for label in counts[0]:
        line = [f"{root}: {sum(c[label].values())}"
                for root, c in zip(roots, counts)]
        print(f"[ops] {label}: aten calls a step, " + ", ".join(line))
        for root, c in zip(roots[1:], counts[1:]):
            a, b = counts[0][label], c[label]
            diff = {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)
                    if b.get(k, 0) != a.get(k, 0)}
            if diff:
                print(f"[ops]   {root} against {roots[0]}: "
                      f"{dict(sorted(diff.items()))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
