"""Parameters of the JAX package -> parameters of the port.

The port keeps the JAX layout (``(d_in, d_out)`` weights used as
``x @ w``, stacks carrying a leading ``count`` axis), so the conversion is
a plain copy of every array, with the tree's structure checked against
the config: the stacks' units and counts, each RG-LRU layer's leaves, and
the token embedding's (vocab, d_model) shape (tied embeddings carry no
separate unembedding).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config.base import AttentionKind, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import build_stacks
from repro_torch.tree import leaves


# the JAX package's RG-LRU layer (models/rglru.py::rglru_init)
RGLRU_LEAVES = ("b_a", "b_i", "conv_b", "conv_w", "lambda", "w_a", "w_gate",
                "w_i", "w_out", "w_x")


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
        for leaf in leaves(stack):
            if np.shape(leaf)[0] != spec.count:
                raise ValueError(f"stacked leaf {np.shape(leaf)} lacks the "
                                 f"leading count {spec.count}")
        for j, (kind, _) in enumerate(spec.unit):
            mix = sorted(stack[f"l{j}"]["mix"])
            if kind == AttentionKind.RECURRENT and mix != list(RGLRU_LEAVES):
                raise ValueError(f"RG-LRU layer l{j} of {cfg.name} has "
                                 f"leaves {mix}, not {list(RGLRU_LEAVES)}")
    if cfg.frontend == "token":
        shape = tuple(np.shape(np_tree["embed"]))
        if shape != (cfg.vocab_size, cfg.d_model):
            raise ValueError(f"embed {shape} is not (vocab, d_model) = "
                             f"{(cfg.vocab_size, cfg.d_model)}")
        if cfg.tie_embeddings and "unembed" in np_tree:
            raise ValueError(f"{cfg.name} ties its embeddings, but the tree "
                             "carries an unembedding")
    return _convert(np_tree, resolve_device(device))

