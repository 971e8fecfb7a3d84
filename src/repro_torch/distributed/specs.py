"""Partition specs for every tree in the system (the JAX package's rules,
keyed by the port's tree paths, which render as ``jax.tree_util.keystr``
renders JAX's: ``['stacks'][0]['l0']['mix']['w_q']``).

  params     -- Megatron TP layout on 'model' (column-parallel up
                projections, row-parallel down projections, vocab-sharded
                embeddings, the expert dim on 'data' for EP);
  master/opt -- the params layout plus ZeRO: 'data' on the first
                divisible unsharded dim;
  caches     -- batch on ('pod', 'data'); kv-heads on 'model' when they
                divide, else the cache *sequence* dim (flash-decoding);
  batches    -- batch on ('pod', 'data').

Stacked leaves get a leading None for the stack dim. ``place_tree`` puts a
tree whose leaves every rank holds whole onto the mesh by a spec tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.compat import P, placements
from repro_torch.config.base import ModelConfig
from repro_torch.distributed.sharding import ShardingPolicy, distribute
from repro_torch.tree import leaves_with_paths, tree_map, unflatten_like

# leaf-name -> logical axes, aligned to the LAST ndim dims of the leaf
_PARAM_RULES = [
    # attention
    ("w_q", ("fsdp", "qkv")),
    ("w_k", ("fsdp", "kv_proj")),
    ("w_v", ("fsdp", "kv_proj")),
    ("w_o", ("qkv", "fsdp")),
    ("b_q", ("qkv",)),
    ("b_k", ("kv_proj",)),
    ("b_v", ("kv_proj",)),
    ("q_norm", (None,)),
    ("k_norm", (None,)),
    # moe (leading expert dim)
    ("router", (None, None)),
    ("w_gate", ("fsdp", "mlp")),
    ("w_up", ("fsdp", "mlp")),
    ("w_down", ("mlp", "fsdp")),
    ("b_up", ("mlp",)),
    ("b_down", (None,)),
    # rwkv
    ("w_r", ("fsdp", "heads_flat")),
    ("w_g", ("fsdp", "heads_flat")),
    ("w_key", ("fsdp", "mlp")),
    ("w_value", ("mlp", "fsdp")),
    ("w_recept", ("fsdp", None)),
    ("lora_a", (None, None)),
    ("lora_b", (None, None)),
    ("ln_x", ("heads", None)),
    ("u", ("heads", None)),
    # rglru
    ("w_x", ("fsdp", "recur")),
    ("conv_w", (None, "recur")),
    ("conv_b", ("recur",)),
    ("w_a", (None, "recur")),
    ("w_i", (None, "recur")),
    ("b_a", ("recur",)),
    ("b_i", ("recur",)),
    ("lambda", ("recur",)),
    ("w_out", ("recur", "fsdp")),
    # embeddings
    ("unembed", ("fsdp", "vocab")),
    ("embed", ("vocab", "fsdp")),
]

# longest key first so "unembed" wins over "u", "w_out" over "w_o", etc.
_PARAM_RULES.sort(key=lambda kv: -len(kv[0]))


def leaf_name(path: str) -> str:
    """The last key of a ``keystr`` path (``...['mix']['w_q']`` ->
    ``w_q``), as the JAX package reads it."""
    return path.rsplit("'", 2)[-2] if "'" in path else path


def _logical_to_axes(policy: ShardingPolicy, logical: Optional[str],
                     dim: int, fsdp: bool):
    if logical is None:
        return None
    if logical == "fsdp" and not fsdp:
        return None
    return policy.mesh_axes_for(logical, dim)


def _param_spec_for(path: str, shape: Tuple[int, ...],
                    policy: ShardingPolicy, fsdp: bool,
                    in_stack: bool) -> P:
    name = leaf_name(path)
    core_ndim = len(shape) - (1 if in_stack else 0)
    logical: Tuple[Optional[str], ...] = (None,) * core_ndim
    is_moe = "'moe'" in path
    for key, rule in _PARAM_RULES:
        if name.startswith(key) or name == key:
            logical = rule
            break
    # MoE expert weights carry a leading expert dim sharded over data (EP)
    if is_moe and name in ("w_gate", "w_up", "w_down") and core_ndim == 3:
        if policy.rules.get("expert") == ("model",):
            # the ep_model layout: experts over 'model', the d_model dim
            # FSDP'd over 'data', d_ff intact
            logical = (("expert", None, "expert_fsdp")
                       if name == "w_down"
                       else ("expert", "expert_fsdp", None))
        elif name == "w_down":
            logical = ("expert", "mlp", None)
        else:
            logical = ("expert", None, "mlp")
    if len(logical) != core_ndim:
        logical = (None,) * core_ndim
    core_shape = shape[1:] if in_stack else shape
    parts = []
    used = set()
    for lg, dim in zip(logical, core_shape):
        picked = _logical_to_axes(policy, lg, dim, fsdp)
        if picked is not None:
            as_tuple = picked if isinstance(picked, tuple) else (picked,)
            as_tuple = tuple(a for a in as_tuple if a not in used)
            used.update(as_tuple)
            picked = (as_tuple if len(as_tuple) > 1
                      else (as_tuple[0] if as_tuple else None))
        parts.append(picked)
    if in_stack:
        parts = [None] + parts
    return P(*parts)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def param_specs(params_shapes, policy: ShardingPolicy, fsdp: bool = False):
    """A tree of ``P`` matching a params (or master) tree; leaves need only
    a ``shape``."""
    return unflatten_like(params_shapes, [
        _param_spec_for(path, _shape(leaf), policy, fsdp,
                        "stacks" in path)
        for path, leaf in leaves_with_paths(params_shapes)])


def zero_extend(spec: P, shape: Tuple[int, ...],
                policy: ShardingPolicy) -> P:
    """Add ZeRO 'data' (+ 'pod') sharding on the first divisible unsharded
    dim. Specs already sharded over 'data' pass through."""
    data_axes = tuple(a for a in ("pod", "data") if a in policy.axis_names)
    if not data_axes:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for pt in parts:
        if pt is None:
            continue
        for a in (pt if isinstance(pt, tuple) else (pt,)):
            used.add(a)
    if "data" in used:
        return spec
    n = 1
    for a in data_axes:
        n *= policy.sizes[a]
    for i, pt in enumerate(parts):
        if pt is None and shape[i] % n == 0 and shape[i] > 1:
            parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return P(*parts)
    return spec


def train_state_specs(state_shapes, policy: ShardingPolicy, fsdp: bool,
                      zero1: bool = True):
    """Specs for {"master", "opt", "step"}."""
    m_specs = param_specs(state_shapes["master"], policy, fsdp)
    if zero1:
        m_specs = tree_map(
            lambda sp, leaf: zero_extend(sp, _shape(leaf), policy),
            m_specs, state_shapes["master"])
    return {"master": m_specs, "opt": {"m": m_specs, "v": m_specs},
            "step": P()}


def cache_specs(cache_shapes, cfg: ModelConfig, policy: ShardingPolicy):
    """Specs for decode caches (stacked)."""
    kv_on_model = (policy.mesh_axes_for("kv_heads", cfg.n_kv_heads)
                   is not None)

    def spec_for(path: str, shape):
        core = shape[1:]  # strip the stack dim
        if path.endswith("_scale']"):   # int8 cache scales (B,KV,S,1)
            b, kv, sl = core[0], core[1], core[2]
            if kv_on_model:
                return P(None, policy.mesh_axes_for("batch", b),
                         policy.mesh_axes_for("kv_heads", kv), None, None)
            return P(None, policy.mesh_axes_for("batch", b), None,
                     policy.mesh_axes_for("kv_seq", sl), None)
        if path.endswith("'k']") or path.endswith("'v']"):
            b, kv, s, hd = core
            if kv_on_model:
                return P(None, policy.mesh_axes_for("batch", b),
                         policy.mesh_axes_for("kv_heads", kv), None, None)
            return P(None, policy.mesh_axes_for("batch", b), None,
                     policy.mesh_axes_for("kv_seq", s), None)
        if path.endswith("'s']"):      # rwkv state (B,H,K,V)
            b, h = core[0], core[1]
            return P(None, policy.mesh_axes_for("batch", b),
                     policy.mesh_axes_for("heads", h), None, None)
        if path.endswith("'h']"):      # rglru state (B,R)
            b, r = core
            return P(None, policy.mesh_axes_for("batch", b),
                     policy.mesh_axes_for("recur", r))
        if path.endswith("'conv']"):   # (B,3,R)
            b, _, r = core
            return P(None, policy.mesh_axes_for("batch", b), None,
                     policy.mesh_axes_for("recur", r))
        if "shift" in path:            # (B,D)
            b = core[0]
            return P(None, policy.mesh_axes_for("batch", b), None)
        if path.endswith("'len']"):
            return P(None)
        return P(*([None] * len(shape)))

    return unflatten_like(cache_shapes, [
        spec_for(path, _shape(leaf))
        for path, leaf in leaves_with_paths(cache_shapes)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): where one leaf goes."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def to_shardings(spec_tree, mesh):
    """A tree of ``NamedSharding`` for a tree of ``P``."""
    return tree_map(lambda sp: NamedSharding(mesh, sp), spec_tree)


def place_tree(tree, spec_tree, mesh):
    """``tree``'s tensors as DTensors of ``spec_tree``'s specs: each rank
    keeps its slice of the whole tensor it holds (bitwise, no
    communication). Non-tensor leaves pass through."""
    import torch
    return tree_map(
        lambda t, sp: (distribute(t, sp, mesh)
                       if isinstance(t, torch.Tensor) else t),
        tree, spec_tree)


def choose_fsdp(cfg: ModelConfig, policy: ShardingPolicy,
                bytes_per_param: int = 2, hbm_budget: float = 4e9) -> bool:
    """FSDP the compute params when a TP-only shard would not leave room
    for activations (> hbm_budget bytes per device)."""
    tp = policy.sizes.get("model", 1)
    return cfg.param_count() * bytes_per_param / tp > hbm_budget
