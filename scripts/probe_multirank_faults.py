#!/usr/bin/env python3
"""How far a planted dropout fault moves ``chip_smoke.py`` phase 16's
tensor-parallel losses and grad norms, beside the clean run's gap: the
(model=2) runs of llama2-7b x 2 (B=2, S=2048, site "qkv", replay, 2
steps, bf16 and f32) on two gloo ranks sharing one card, against the
same steps on one device. Each runs clean, then with one fault planted
on rank 1:

- layer: its layer 1 reads layer 0's dropout bits (the salt);
- step: its step 1 reads step 0's bits (the step seed);
- window: it reads rank 0's tile of the plane (offset 0).

Prints, for each, the largest relative loss and grad-norm gap from one
device and how many flash operands ``launch.multirank.check_operands``
flags on each rank. A probe, not part of the port. Needs one NVIDIA GPU
and prints the card's name and power limit; ``--cpu`` runs reduced
llama2 (S=128) on the CPU instead.

    python3 scripts/probe_multirank_faults.py [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

FAULTS = ("clean", "layer", "step", "window")
BASE = dict(arch="llama2-7b", layers=2, batch=2, seq=2048, p=0.1, seed=3,
            device="cuda", steps=2, site="qkv", replay="auto")
DTYPES = ("bf16", "f32")


def _plant(fault: str):
    """Plant ``fault`` in this process; returns its undo."""
    from repro_torch.core import producer
    from repro_torch.core.overlap import SALT_ATTN, DropoutPlan
    if fault == "layer":
        orig = DropoutPlan.salt

        def salt(self, layer_idx, stream=SALT_ATTN):
            swap = int(layer_idx) == 1 and stream == SALT_ATTN
            return orig(self, 0 if swap else layer_idx, stream)
        DropoutPlan.salt = salt
        return lambda: setattr(DropoutPlan, "salt", orig)
    if fault == "step":
        orig = DropoutPlan.step_seed
        DropoutPlan.step_seed = lambda self, step: orig(
            self, 0 if int(step) == 1 else step)
        return lambda: setattr(DropoutPlan, "step_seed", orig)
    if fault == "window":
        orig = producer.shard_mask_tile
        producer.shard_mask_tile = lambda *a, **k: orig(*a, **k)[:2] + (0,)
        return lambda: setattr(producer, "shard_mask_tile", orig)
    return lambda: None


def worker(rank: int, world: int, items):
    """Each (fault, job) in turn; the fault on rank 1 only, lifted while
    the expected operands are made."""
    import gc

    import torch

    from repro_torch.launch import multirank
    out = []
    for fault, job in items:
        undo = _plant(fault) if rank == 1 else (lambda: None)
        expected = multirank.expected_operands

        def clean_expected(*a, **k):
            nonlocal undo
            undo()
            try:
                return expected(*a, **k)
            finally:
                undo = _plant(fault) if rank == 1 else (lambda: None)
        multirank.expected_operands = clean_expected
        try:
            out.append(multirank.train_job(rank, world, job))
        finally:
            multirank.expected_operands = expected
            undo()
        gc.collect()
        if job["device"] == "cuda":
            torch.cuda.empty_cache()
    return out


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def main() -> int:
    import torch

    import probe_multirank_faults
    from repro_torch.kernels import build
    from repro_torch.launch import multirank
    from repro_torch.launch.mesh import run_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    cpu = ap.parse_args().cpu
    base = dict(BASE)
    if cpu:
        base.update(reduced=True, seq=128, device="cpu")
        smi = "CPU"
    else:
        if not torch.cuda.is_available():
            print("probe_multirank_faults: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        t0 = time.perf_counter()
        build.build_all()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    jobs = {dt: dict(base, compute=dt, gemm_dtype=dt) for dt in DTYPES}
    refs = {dt: multirank.train_job(0, 1, dict(job, mesh=None))
            for dt, job in jobs.items()}
    if not cpu:
        torch.cuda.empty_cache()
    items = [(fault, dict(jobs[dt], mesh=((2,), ("model",))))
             for dt in DTYPES for fault in FAULTS]
    t0 = time.perf_counter()
    res = run_ranks(probe_multirank_faults.worker, 2, (items,),
                    backend="gloo", deadline_s=600 if not cpu else 300)
    print(f"two ranks ran {len(items)} jobs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for i, (fault, job) in enumerate(items):
        ref = refs[job["compute"]]
        r0, r1 = res[0][i], res[1][i]
        row = dict(dtype=job["compute"], fault=fault,
                   loss_gap=_rel(r0["losses"], ref["losses"]),
                   grad_norm_gap=_rel(r0["grad_norms"], ref["grad_norms"]),
                   flagged=[len(r0["operands"][2]), len(r1["operands"][2])],
                   operands=r0["operands"][1])
        rows.append(row)
        print(f"{row['dtype']} {fault}: loss {row['loss_gap']:.3e}, grad "
              f"norm {row['grad_norm_gap']:.3e} relative from one device; "
              f"operands flagged on ranks 0, 1: {row['flagged']} of "
              f"{row['operands']} | {smi}", flush=True)
    print(json.dumps({"rows": rows, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
