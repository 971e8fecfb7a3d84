"""Typed configuration system for the repro framework.

``ModelConfig`` describes an architecture; ``ShapeConfig`` describes one
workload cell (seq_len x global_batch x step kind); ``RunConfig`` bundles a
model, a shape, a mesh and the dropout-overlap plan into a launchable unit.
"""
from repro_torch.config.base import (
    AttentionKind,
    BlockPattern,
    DropoutPlanConfig,
    FFNKind,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    ShardingConfig,
    StepKind,
    TrainConfig,
)
from repro_torch.config.registry import (
    ALL_ARCHS,
    ALL_SHAPES,
    applicable_shapes,
    get_arch,
    get_shape,
    list_archs,
    register_arch,
)

__all__ = [
    "AttentionKind",
    "BlockPattern",
    "DropoutPlanConfig",
    "FFNKind",
    "MeshConfig",
    "ModelConfig",
    "MoEConfig",
    "OptimizerConfig",
    "RunConfig",
    "ShapeConfig",
    "ShardingConfig",
    "StepKind",
    "TrainConfig",
    "ALL_ARCHS",
    "ALL_SHAPES",
    "applicable_shapes",
    "get_arch",
    "get_shape",
    "list_archs",
    "register_arch",
]
