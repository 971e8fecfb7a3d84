"""Per-call cost features of the port's kernels: the counterpart of the JAX
package's ``roofline/hlo.py::feature_vector``, which reads them off the
compiled HLO.

``feature_vector(fn, *args)`` runs ``fn`` on fake copies of its
arguments (nothing launches or allocates) under
``torch.utils.flop_counter.FlopCounterMode`` and a mode of its own:

  * ``flops`` -- the FLOP counter's count. A kernel operator is opaque to
    it (it would count 0), so each ``repro_torch`` operator has a formula
    registered here: 2 M N K a product (times E grouped), the flash
    forward's two score-sized products (4 B H SQ SK D), dq's three and
    dkv's four (the counter's own convention for attention: the whole
    score square, causal or not);
  * ``bytes`` -- what the kernel operators must move, each operand read
    once and each result written once (their tensors' bytes);
  * ``rng_ops`` -- the analytic Philox count of the plane ``plane`` =
    (B, H, SQ, SK): elements x ``perfmodel.model.rng_ops_per_elem``.

``tune/calibrate.py`` pairs these with the card's measured times.
``roofline/analysis.py`` and ``report.py`` of the JAX package read
dry-run artifacts and come with the multi-device port.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from repro_torch.perfmodel.model import rng_ops_per_elem

KERNEL_NAMESPACE = "repro_torch"


def _gemm_flops(a_shape, b_shape, *_, **__) -> int:
    """2 M N K a product: a (M, K) x b (K, N), or E of them grouped."""
    e = a_shape[0] if len(a_shape) == 3 else 1
    m, k = a_shape[-2:]
    return 2 * e * m * k * b_shape[-1]


def _fp8_flops(a_shape, a_s_shape, bt_shape, *_, **__) -> int:
    """The e4m3 host on K-major operands: bt (N, K), or (E, N, K)."""
    e = a_shape[0] if len(a_shape) == 3 else 1
    m, k = a_shape[-2:]
    return 2 * e * m * k * bt_shape[-2]


def _attn_flops(products: int):
    def formula(q_shape, k_shape, *_, **__) -> int:
        b, h, sq, d = q_shape
        return 2 * products * b * h * sq * k_shape[2] * d
    return formula


_FORMULAS = {"gemm_rng": _gemm_flops, "gemm_rng_fp8": _fp8_flops,
             "flash_fwd": _attn_flops(2), "flash_dq": _attn_flops(3),
             "flash_dkv": _attn_flops(4)}
_registered = False


def register_formulas() -> None:
    """Register the kernel operators' flop formulas (once; importing the
    kernels' modules defines the operators)."""
    global _registered
    if _registered:
        return
    import repro_torch.kernels.flash_attention_bwd  # noqa: F401
    import repro_torch.kernels.gemm_rng  # noqa: F401
    for name, formula in _FORMULAS.items():
        register_flop_formula(getattr(torch.ops.repro_torch, name))(formula)
    _registered = True


class _KernelBytes(TorchDispatchMode):
    """Sums the bytes of every kernel operator's tensors, operands and
    results."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == KERNEL_NAMESPACE:
            leaves, _ = tree_flatten((args, kwargs or {}, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def feature_vector(fn: Callable, *args,
                   plane: Optional[Tuple[int, int, int, int]] = None,
                   rounds: int = 7) -> Dict[str, float]:
    """Cost features of ``fn(*args)``: flops (the FLOP counter), the
    kernel operators' bytes and the plane's RNG operations. ``fn`` runs
    on fake copies of ``args``: no kernel launches."""
    register_formulas()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args]
    counter = FlopCounterMode(display=False)
    kbytes = _KernelBytes()
    with mode, counter, kbytes:
        fn(*fake)
    rng = 0.0
    if plane is not None:
        b, h, sq, sk = plane
        rng = float(b) * h * sq * sk * rng_ops_per_elem(rounds)
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(kbytes.bytes), "rng_ops": rng}
