"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

philox_common.py — Philox-4x32 counter math (plain mirror of csrc/philox.cuh)
philox.py        — standalone dropout-RNG kernel (packed keep plane)
ops.py           — public entry points
build.py         — nvcc at first use, ctypes binding

Each kernel wrapper counts its launches; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0.
"""
from typing import Dict

from repro_torch.kernels import philox


def launch_counts() -> Dict[str, int]:
    return {philox.KERNEL: philox.launch_count()}


def reset_launch_counts() -> None:
    philox.reset_launch_count()
