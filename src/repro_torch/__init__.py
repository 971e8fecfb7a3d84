"""repro_torch — the PyTorch/CUDA port of the ``repro`` package for NVIDIA
Hopper. Module names mirror ``src/repro/``; every Pallas kernel on a ported
path is a hand-written CUDA kernel here, beside a plain PyTorch version.
The port imports neither JAX nor ``repro``.
"""

__version__ = "0.1.0"
