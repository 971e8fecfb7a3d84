"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

philox_common.py       -- Philox-4x32 counter math (plain mirror of
                          csrc/philox.cuh) and the tile / packed-row helpers
philox.py              -- standalone dropout-RNG kernel (packed keep plane)
gemm_rng.py            -- fused GEMM + dropout RNG (and its Region-3 plain
                          GEMM variant)
flash_attention.py     -- flash-attention forward, dropout none / fused /
                          premask / replay; the differentiable
                          flash_attention_mosaic
flash_attention_bwd.py -- flash-attention backward (dq and dkv kernels)
ref.py                 -- plain oracles the plain versions are built from
ops.py                 -- public entry points
build.py               -- nvcc at first use, ctypes binding

Each kernel wrapper counts its launches; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0.
"""
from typing import Dict

from repro_torch.kernels import flash_attention, flash_attention_bwd
from repro_torch.kernels import gemm_rng, philox


def launch_counts() -> Dict[str, int]:
    return {philox.KERNEL: philox.launch_count(),
            gemm_rng.KERNEL: gemm_rng.launch_count(),
            flash_attention.KERNEL: flash_attention.launch_count(),
            **flash_attention_bwd.launch_counts()}


def reset_launch_counts() -> None:
    philox.reset_launch_count()
    gemm_rng.reset_launch_count()
    flash_attention.reset_launch_count()
    flash_attention_bwd.reset_launch_count()
