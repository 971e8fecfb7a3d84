#!/usr/bin/env python3
"""Milliseconds of the collectives behind ``chip_smoke.py`` phase 16's
two-rank runs: two gloo ranks sharing one card (``launch.mesh.run_ranks``,
``make_host_mesh(device="cuda")``, the gathers staged), each collective
on a 64 MB and a 256 MB f32 tensor, the mean of 4 calls after one
warm-up. A probe, not part of the port.

Rows: the functional all-reduce of a CUDA tensor (gloo's own CUDA path),
the same through host copies (pageable, then pinned), the host all-reduce
alone, the functional all-gather (routed through host copies by
``stage_gloo_cuda_gathers``), the functional reduce-scatter of a CUDA
tensor, and a pageable device-to-host copy. Needs one NVIDIA GPU; prints
the card's name and power limit.

    python3 scripts/probe_gloo_collectives.py
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

SIZES_MB = (64, 256)
REPS = 4


def _timed(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps


def worker(rank: int, world: int):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    from repro_torch.launch.mesh import (make_host_mesh,
                                         stage_gloo_cuda_gathers)
    stage_gloo_cuda_gathers()
    mesh = make_host_mesh((2,), ("model",), device="cuda")

    def done(r):
        return r.wait() if hasattr(r, "wait") else r

    out = {}
    for mb in SIZES_MB:
        n = mb * 2 ** 20 // 4
        x = torch.randn(n, device="cuda")
        pin = torch.empty(n, pin_memory=True)
        host = x.cpu()

        def pageable():
            h = x.cpu()
            dist.all_reduce(h)
            return h.cuda()

        def pinned():
            pin.copy_(x)
            dist.all_reduce(pin)
            return x.copy_(pin)

        out[f"{mb} MB all_reduce, gloo's CUDA path"] = _timed(
            lambda: done(fc.all_reduce(x, "sum", (mesh, 0))))
        out[f"{mb} MB all_reduce through pageable host copies"] = _timed(
            pageable)
        out[f"{mb} MB all_reduce through pinned host copies"] = _timed(
            pinned)
        out[f"{mb} MB all_reduce of a host tensor alone"] = _timed(
            lambda: dist.all_reduce(host))
        out[f"{mb} MB all_gather (through host copies)"] = _timed(
            lambda: done(fc.all_gather_tensor(x, 0, (mesh, 0))))
        out[f"{mb} MB reduce_scatter, gloo's CUDA path"] = _timed(
            lambda: done(fc.reduce_scatter_tensor(x, "sum", 0, (mesh, 0))))
        out[f"{mb} MB device-to-host copy (pageable)"] = _timed(
            lambda: x.cpu())
    return out


def main() -> int:
    import torch

    import probe_gloo_collectives
    from repro_torch.launch.mesh import run_ranks
    if not torch.cuda.is_available():
        print("probe_gloo_collectives: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    res = run_ranks(probe_gloo_collectives.worker, 2, (), backend="gloo",
                    deadline_s=200)
    for key, secs in res[0].items():
        print(f"{key}: {secs * 1e3:.1f} ms (rank 0 of two gloo ranks on one "
              f"card) | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
