"""Architecture + shape registries.

Every assigned architecture registers itself on import of ``repro_torch.configs``.
``get_arch(id)`` returns the full-size ModelConfig; ``get_arch(id,
reduced=True)`` returns a small same-family config for CPU smoke tests.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.config.base import (
    AttentionKind,
    ModelConfig,
    ShapeConfig,
    StepKind,
)

_ARCHS: Dict[str, Tuple[Callable[[], ModelConfig], Callable[[], ModelConfig]]] = {}

ALL_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind=StepKind.TRAIN),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind=StepKind.PREFILL),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind=StepKind.DECODE),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind=StepKind.DECODE),
}


def register_arch(arch_id: str, full: Callable[[], ModelConfig],
                  reduced: Callable[[], ModelConfig]) -> None:
    _ARCHS[arch_id] = (full, reduced)


def get_arch(arch_id: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    full, red = _ARCHS[arch_id]
    return red() if reduced else full()


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_ARCHS)


def get_shape(name: str) -> ShapeConfig:
    return ALL_SHAPES[name]


def _is_subquadratic(cfg: ModelConfig) -> bool:
    """True if the arch never materializes an O(SQ^2) attention state in
    decode — i.e. every layer is recurrent/wkv/local-window."""
    kinds = set(cfg.layer_kinds())
    return AttentionKind.FULL not in kinds


def applicable_shapes(arch_id: str) -> List[str]:
    """Shape cells that run for this arch. long_500k requires sub-quadratic
    attention (SSM / hybrid-with-local-window / linear attention); pure
    full-attention archs skip it (recorded in EXPERIMENTS.md)."""
    cfg = get_arch(arch_id)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if _is_subquadratic(cfg):
        shapes.append("long_500k")
    return shapes


def _ensure_loaded() -> None:
    if not _ARCHS:
        import repro_torch.configs  # noqa: F401  (registers everything)


# Populated after repro.configs import; kept for introspection.
ALL_ARCHS = _ARCHS
