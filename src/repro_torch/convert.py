"""Parameters of the JAX package -> parameters of the port.

The port keeps the JAX layout (``(d_in, d_out)`` weights used as
``x @ w``, stacks carrying a leading ``count`` axis), so the conversion is
a plain copy of every array, with the tree's structure checked against
the config.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import build_stacks


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return torch.from_numpy(np.array(node, copy=True)).to(device)


def params_from_jax(np_tree: Any, cfg: ModelConfig,
                    device: DeviceLike = None) -> Any:
    """``np_tree``: the JAX parameter pytree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``). Returns the port's parameters
    on ``device``."""
    specs = build_stacks(cfg)
    stacks = np_tree["stacks"]
    if len(stacks) != len(specs):
        raise ValueError(f"{len(stacks)} stacks for {len(specs)} in "
                         f"{cfg.name}")
    for spec, stack in zip(specs, stacks):
        if sorted(stack) != [f"l{j}" for j in range(len(spec.unit))]:
            raise ValueError(f"stack keys {sorted(stack)} do not match the "
                             f"unit of {cfg.name}")
        for leaf in _leaves(stack):
            if np.shape(leaf)[0] != spec.count:
                raise ValueError(f"stacked leaf {np.shape(leaf)} lacks the "
                                 f"leading count {spec.count}")
    return _convert(np_tree, resolve_device(device))


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node
