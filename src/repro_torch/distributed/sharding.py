"""Logical-axis sharding rules (the JAX package's, on a torch
``DeviceMesh``).

Model code annotates activations with logical axis names
(``constrain(x, "batch", "seq", "embed")``); a ``ShardingPolicy``
installed for the step (``use_policy``) maps logical names to mesh axes.
Outside a policy the annotations are no-ops, so the same model code runs
on one device. Under a policy the model's tensors are DTensors and
``constrain`` redistributes one to the spec's placements, as JAX's
``with_sharding_constraint`` pins a layout for GSPMD.

The arithmetic (``spec``, ``mesh_axes_for``, ``mask_plane_shards``) reads
only the mesh's axis names and sizes, so an ``AbstractMesh``
(``launch/mesh.py``) serves it without devices.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.compat import P, mesh_axis_names, mesh_sizes, placements

_state = threading.local()

# Logical axis vocabulary used across the model zoo (the JAX package's):
#   batch -> ("pod", "data"); seq, embed -> None; heads, kv_heads, kv_seq,
#   mlp, vocab, recur, qkv, kv_proj, heads_flat -> "model"; expert ->
#   "data" (EP groups == DP groups); expert_cap -> ("pod", "data");
#   stack -> None; fsdp -> ("pod", "data") for ZeRO-3 weight dims.
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "kv_seq": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("data",),
    "expert_cap": ("pod", "data"),
    "expert_fsdp": None,
    "recur": ("model",),
    "qkv": ("model",),
    "kv_proj": ("model",),
    "heads_flat": ("model",),
    "stack": None,
    "fsdp": ("pod", "data"),
}

# Layout presets for the production mesh: "tp" (Megatron: batch on
# (pod, data), TP + SP on model) and "fsdp" (pure data parallel over every
# axis with ZeRO-3 parameters).
LAYOUT_PRESETS: Dict[str, Dict[str, Optional[Tuple[str, ...]]]] = {
    "tp": {"seq": ("model",)},
    "fsdp": {
        "batch": ("pod", "data", "model"),
        "seq": ("model",),
        "heads": None, "kv_heads": None, "mlp": None, "vocab": None,
        "recur": None, "qkv": None, "kv_proj": None, "heads_flat": None,
        "fsdp": ("pod", "data", "model"),
    },
}


class ShardingPolicy:
    """Maps logical axis names to mesh axis names for one mesh (a
    ``DeviceMesh`` or an ``AbstractMesh``)."""

    def __init__(self, mesh, rules: Optional[Dict] = None,
                 fsdp_params: bool = False):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.fsdp_params = fsdp_params
        self.axis_names = mesh_axis_names(mesh)
        self.sizes = mesh_sizes(mesh)
        self._mesh_axes = set(self.axis_names)

    def mesh_axes_for(self, logical: Optional[str],
                      dim_size: Optional[int] = None):
        if logical is None:
            return None
        axes = self.rules.get(logical)
        if axes is None:
            return None
        present = tuple(a for a in axes if a in self._mesh_axes)
        # an axis that does not divide the dim is dropped (explicit
        # replication for small dims such as kv_heads=8)
        return self._fit_axes(present, dim_size)

    def spec(self, logical_axes: Tuple[Optional[str], ...],
             shape: Optional[Tuple[int, ...]] = None) -> P:
        """Cross-dim conflict-aware: a mesh axis consumed by an earlier
        dim is dropped from later dims."""
        parts = []
        used = set()
        for i, name in enumerate(logical_axes):
            dim = None if shape is None else shape[i]
            axes = self.rules.get(name) if name else None
            if axes is None:
                parts.append(None)
                continue
            avail = tuple(a for a in axes
                          if a in self._mesh_axes and a not in used)
            picked = self._fit_axes(avail, dim)
            for a in (picked if isinstance(picked, tuple)
                      else ((picked,) if picked else ())):
                used.add(a)
            parts.append(picked)
        return P(*parts)

    def _fit_axes(self, axes: Tuple[str, ...], dim_size: Optional[int]):
        if not axes:
            return None
        if dim_size is not None:
            keep, prod = [], 1
            for a in axes:
                sz = self.sizes[a]
                if dim_size % (prod * sz) == 0:
                    keep.append(a)
                    prod *= sz
            axes = tuple(keep)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def sharding(self, logical_axes: Tuple[Optional[str], ...],
                 shape: Optional[Tuple[int, ...]] = None) -> list:
        """The DTensor placements of ``spec(logical_axes, shape)``."""
        return placements(self.spec(logical_axes, shape), self.mesh)


def mask_plane_shards(policy: Optional[ShardingPolicy], batch: int,
                      n_heads: int):
    """How a (batch, n_heads) dropout-mask plane splits under ``policy``:
    ((batch_axes, n_batch_shards), (head_axes, n_head_shards)), axes as
    tuples of mesh-axis names (empty = replicated). The one source for the
    schedule compiler's ShardInfo and the producers' shard-local context,
    derived through ``spec`` so a mesh axis the batch rule claims is never
    reused for heads."""
    if policy is None:
        return ((), 1), ((), 1)
    spec = policy.spec(("batch", "heads"), (batch, n_heads))

    def one(axes):
        axes = (() if axes is None
                else (axes,) if isinstance(axes, str) else tuple(axes))
        n = 1
        for a in axes:
            n *= policy.sizes[a]
        return axes, n

    return one(spec[0]), one(spec[1])


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    prev = getattr(_state, "policy", None)
    _state.policy = policy
    try:
        yield
    finally:
        _state.policy = prev


def current_policy() -> Optional[ShardingPolicy]:
    return getattr(_state, "policy", None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def constrain(x, *logical_axes):
    """Redistribute ``x`` to the spec of ``logical_axes`` under the active
    policy (a plain tensor counts as replicated); a no-op otherwise."""
    policy = current_policy()
    if policy is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{logical_axes} for a tensor of shape "
                         f"{tuple(x.shape)}")
    spec = policy.spec(tuple(logical_axes), tuple(x.shape))
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, policy.mesh,
                               [Replicate()] * policy.mesh.ndim,
                               run_check=False)
    return x.redistribute(policy.mesh, placements(spec, policy.mesh))


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (a value every rank holds) as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor; ``t`` itself otherwise. For
    the constants a layer makes (positions, frequencies) before it meets
    a sharded activation."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def distribute(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The DTensor of ``spec`` whose global value is ``t``, which every
    rank holds whole: each rank keeps its own slice (no communication, so
    the shards are bitwise ``t``'s)."""
    from torch.distributed.tensor import DTensor
    sizes = mesh_sizes(mesh)
    local = t
    for d, part in enumerate(spec):
        axes = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        if local.shape[d] % n:
            raise ValueError(f"dim {d} of size {local.shape[d]} does not "
                             f"split {n} ways (spec {tuple(spec)})")
        step = local.shape[d] // n
        local = local.narrow(d, idx * step, step)
    return DTensor.from_local(local.contiguous(), mesh,
                              placements(spec, mesh), run_check=False)


def gather_full(t):
    """The global value of a DTensor (every rank gets it whole); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t
