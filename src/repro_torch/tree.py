"""Parameter and state trees: the port's stand-in for ``jax.tree``.

The port keeps parameters as plain dicts holding tensors or lists of
per-layer dicts (:mod:`repro_torch.models.model`); ``tree_leaves`` and
``tree_map`` walk them in a fixed order (dict insertion order, list order).

``tree_flatten_with_path`` / ``tree_unflatten`` walk the wider trees that
checkpoints and engine snapshots hold: dict, list and tuple nodes,
``NamedTuple`` nodes (``AdamWState``, ``PagedSlab``), ``None`` as an empty
node, and any other object (a tensor, an array, a Python ``int``) as a
leaf. A leaf's path names each step as ``jax.tree_util`` does: a dict key
or list index bare, a ``NamedTuple`` field with a leading ``.``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


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


_LEAF = None   # the treedef of a leaf; None (the empty node) is ("none",)


def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[Tuple[str, ...],
                                                          Any]], Any]:
    """``([(path, leaf), ...], treedef)``: every leaf of ``tree`` with its
    path, a tuple of strings (``("opt", ".m", "layers", "0", "w")``), in
    the order ``tree_unflatten`` takes them back."""
    flat: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(node, path):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            return (dict, tuple(node), tuple(
                walk(v, path + (str(k),)) for k, v in node.items()))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (type(node), None, tuple(
                walk(v, path + ("." + f,))
                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return (type(node), None, tuple(
                walk(v, path + (str(i),)) for i, v in enumerate(node)))
        flat.append((path, node))
        return _LEAF

    return flat, walk(tree, ())


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """The tree of ``treedef`` (from :func:`tree_flatten_with_path`) with
    ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(d):
        if d is _LEAF:
            return next(it)
        if d == ("none",):
            return None
        kind, keys, children = d
        vals = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, vals))
        if kind in (list, tuple):
            return kind(vals)
        return kind(*vals)                     # a NamedTuple

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("tree_unflatten: more leaves than the treedef has")
    return out


_END = object()
