"""Nested dict / list parameter trees: the port's stand-in for JAX
pytrees. Leaves are visited in JAX's order (dict keys sorted, lists in
order), and a leaf's path renders as ``jax.tree_util.keystr`` renders it
(``['stacks'][0]['l0']['mix']['w_q']``), so rules keyed on paths behave
as in the JAX package."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, node in enumerate(tree):
            out += leaves_with_paths(node, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-structured
    ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten_like(tree, flat: List[Any]):
    """A tree of ``tree``'s structure holding ``flat`` (in
    ``leaves_with_paths`` order)."""
    it = iter(flat)
    order = {path: next(it) for path, _ in leaves_with_paths(tree)}
    return _rebuild(tree, order, "")


def _rebuild(tree, order, prefix):
    if isinstance(tree, dict):
        return {k: _rebuild(v, order, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, order, f"{prefix}[{i}]")
                for i, v in enumerate(tree)]
    return order[prefix]
