#!/usr/bin/env python3
"""How exactly do Hopper's e4m3 tensor cores sum? A probe, not part of the
port: it builds ``scripts/probe_e4m3_wgmma.cu`` (wgmma m64n128k32 e4m3 ->
f32, the tensor-core sum folded into an f32 register after every 1 or 4
instructions) and holds its C against the f32 product of the same e4m3
values (``torch.matmul``, TF32 off) by the port's kernel check: |C - plain|
<= 1e-3 (1 + |plain|), the tolerance ``chip_smoke.py`` holds the e4m3
GEMM+RNG kernels to. Operands are random normal, quantized to e4m3 with one
scale a tensor; small integers, whose sums every format holds exactly, check
the probe itself.

    python3 scripts/probe_e4m3_wgmma.py

Needs one NVIDIA Hopper GPU and nvcc; prints one line a case and the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, quant  # noqa: E402

TOL = 1e-3
SHAPES = ((512, 2048, 512), (256, 11008, 256), (1024, 4096, 1024))


def _library():
    out = build.build_dir() / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libprobe_e4m3_wgmma.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(ROOT / "scripts" / "probe_e4m3_wgmma.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).probe_e4m3_wgmma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, a_q, bt_q, fold_every):
    m, k = a_q.shape
    n = bt_q.shape[0]
    c = torch.empty((m, n), dtype=torch.float32, device="cuda")
    err = fn(a_q.data_ptr(), bt_q.data_ptr(), c.data_ptr(), m, n, k,
             fold_every, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe launch failed: cudaError {err}")
    torch.cuda.synchronize()
    return c


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_e4m3_wgmma: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = _library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = quant.fp8_dtype()
    # the probe itself: integer sums are exact in any format
    a = torch.randint(-2, 3, (256, 4096), generator=gen, device="cuda")
    b = torch.randint(-2, 3, (256, 4096), generator=gen, device="cuda")
    c = _run(fn, a.to(dt), b.to(dt), 4)
    exact = (a.double() @ b.double().T).float()
    print(f"integers 256x256x4096, fold every 4: max |C - exact| "
          f"{float((c - exact).abs().max())}")
    for m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((n, k), generator=gen, device="cuda")
        a_q, s_a = quant.quantize_tiled(a, m, k)
        bt_q, s_b = quant.quantize_tiled(b, n, k)
        scale = float(s_a) * float(s_b)
        plain = (a_q.float() @ bt_q.float().T) * scale
        for fold_every in (1, 4):
            got = _run(fn, a_q, bt_q, fold_every) * scale
            rel = (got - plain).abs() / (1 + plain.abs())
            print(f"{m}x{n}x{k}, fold every {fold_every} k32: max "
                  f"|C - plain| / (1 + |plain|) {float(rel.max()):.4g}, "
                  f"{int((rel > TOL).sum())} of {rel.numel()} elements "
                  f"({float((rel > TOL).float().mean()) * 100:.2f} %) beyond "
                  f"{TOL}, mean |C - plain| "
                  f"{float((got - plain).abs().mean()):.4g} against mean |C| "
                  f"{float(plain.abs().mean()):.4g}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() or
          torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
