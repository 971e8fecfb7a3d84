"""GPipe-style pipeline parallelism over a 'pp' mesh axis (the JAX
package's ``distributed/pipeline``).

Each pipeline rank holds one stage's parameters (the stacked stage dim is
sharded over 'pp'). Microbatches stream through the skewed schedule: at
tick t, rank s processes microbatch t - s; activations hop rank to rank
with ``ppermute``. The bubble fraction is (S - 1) / (T + S - 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.compat import (P, axis_index, mesh_sizes, ppermute, psum,
                                shard_map)
from repro_torch.tree import leaves, unflatten_like


def pipeline_apply(stage_fn: Callable, stacked_params, x_micro, mesh,
                   pp_axis: str = "pp"):
    """Run ``n_micro`` microbatches through S pipeline stages.

    stage_fn(params_for_one_stage, x) -> y with y.shape == x.shape;
    stacked_params: a tree with leading dim S (sharded over ``pp_axis``);
    x_micro: (n_micro, mb, ...) microbatches (replicated).
    Returns the (n_micro, mb, ...) outputs, replicated on every rank."""
    n_stages = mesh_sizes(mesh)[pp_axis]
    n_micro = x_micro.shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    flat = leaves(stacked_params)

    def body(xs, *flat_stk):
        s = axis_index(pp_axis)
        params = unflatten_like(stacked_params, [a[0] for a in flat_stk])
        act = torch.zeros_like(xs[0])
        banked = []
        for t in range(n_micro + n_stages - 1):
            mb_idx = t - s
            active = 0 <= mb_idx < n_micro
            # stage 0 injects a fresh microbatch; the others use the arrival
            x_in = xs[min(max(t, 0), n_micro - 1)] if s == 0 else act
            y = stage_fn(params, x_in) if active else x_in
            if active and s == n_stages - 1:
                banked.append((mb_idx, y))     # the last stage banks it
            act = ppermute(y, pp_axis, perm)   # hop rightward
        outs = torch.zeros_like(xs)
        for i, y in banked:
            outs = outs.index_copy(0, torch.tensor([i], device=xs.device),
                                   y[None])
        # broadcast the last rank's bank to every rank
        return psum(outs, pp_axis)

    specs = (P(),) + tuple(P(pp_axis) for _ in flat)
    return shard_map(body, mesh=mesh, in_specs=specs,
                     out_specs=P())(x_micro, *flat)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
