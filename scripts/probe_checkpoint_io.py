#!/usr/bin/env python3
"""Where a checkpoint's seconds go on the card's machine: the train state
of llama2-7b's width x N layers (f32 master and two moments, 12 bytes a
parameter) through each stage of ``repro_torch.checkpoint.Checkpointer``
beside numpy's own calls for the same format, timed one after another:

    python3 scripts/probe_checkpoint_io.py [--layers 4] [--dir build/ckio]

- the host gather: ``Tensor.cpu()`` leaf by leaf (pageable), and the
  Checkpointer's copies into pinned host buffers (the first save
  allocates them, the next ones reuse them);
- the write: ``np.savez``, the Checkpointer's (one write a member), and
  a plain sequential write of the same bytes;
- the read: ``np.load`` of the .npz, and the Checkpointer's (one read a
  member from its offset, its zip CRC checked);
- the copy to the card: ``torch.from_numpy(a).to("cuda")`` (pageable,
  the Checkpointer's restore), and through pinned buffers.

Prints one line a stage with seconds and GB/s, the card's name and power
limit, and the free disk; deletes its files. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    Checkpointer,
    _read_npz,
    _write_npz,
)
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


def timed(label, nbytes, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"{label}: {dt:.3f} s, {nbytes / dt / 1e9:.2f} GB/s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_checkpoint_io: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dir", default="build/ckio")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    os.makedirs(args.dir, exist_ok=True)
    print(f"{smi} | free under {args.dir}: "
          f"{shutil.disk_usage(args.dir).free / 2 ** 30:.1f} GiB", flush=True)
    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=args.layers)
    state = init_train_state(cfg, seed=0, device="cuda")
    leaves = [(p, t) for p, t in leaves_with_paths(state)
              if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    print(f"llama2-7b width x {args.layers}: {len(leaves)} tensors, "
          f"{nbytes / 1e9:.2f} GB", flush=True)
    try:
        host = timed("gather, .cpu() (pageable)", nbytes, lambda: {
            p: t.cpu().numpy() for p, t in leaves})
        ckpt = Checkpointer(args.dir, async_save=False)
        timed("gather, the Checkpointer's first (pinned buffers allocated)",
              nbytes, lambda: ckpt._gather(state))
        timed("gather, the Checkpointer's next (pinned buffers reused)",
              nbytes, lambda: ckpt._gather(state))
        path = os.path.join(args.dir, "ckpt.npz")
        timed("write, np.savez", nbytes, lambda: np.savez(path, **host))

        def write_own():
            with open(path, "wb") as f:
                _write_npz(f, host)
        timed("write, the Checkpointer's", nbytes, write_own)
        raw = os.path.join(args.dir, "raw.bin")

        def write_raw():
            with open(raw, "wb") as f:
                for a in host.values():
                    f.write(memoryview(a.reshape(-1)).cast("B"))
        timed("write, one sequential file", nbytes, write_raw)
        os.remove(raw)
        del host

        def np_load():
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        timed("read, np.load", nbytes, np_load)
        arrays = timed("read, the Checkpointer's", nbytes,
                       lambda: _read_npz(path))
        timed("to the card, pageable (the Checkpointer's restore)", nbytes,
              lambda: [torch.from_numpy(a).to("cuda")
                       for a in arrays.values()])
        pinned = {k: torch.empty(a.shape, dtype=torch.float32,
                                 pin_memory=True)
                  for k, a in arrays.items()}

        def via_pinned():
            out = []
            for k, a in arrays.items():
                pinned[k].numpy()[...] = a
                out.append(pinned[k].to("cuda", non_blocking=True))
            return out
        timed("to the card through pinned buffers (host copy included)",
              nbytes, via_pinned)
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
