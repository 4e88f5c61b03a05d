"""Nested dict/list parameter trees: the port's stand-in for ``jax.tree``.

The port keeps parameters as plain dicts holding tensors or lists of
per-layer dicts (:mod:`repro_torch.models.model`); these two helpers walk
them in a fixed order (dict insertion order, list order).
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in a fixed order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise over ``tree`` and same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
