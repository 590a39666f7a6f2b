"""Nested-container trees in JAX's flattening order, without JAX.

The port's param, optimizer and trainer states are trees of dicts,
lists, tuples and NamedTuples over tensors, as the reference's pytrees
are.  JAX flattens a dict in sorted key order at every level, a
sequence in index order and a NamedTuple field by field; ``None`` is an
empty subtree.  The trainer's checkpoints list their leaves in that
order (``train.checkpoint``), so both packages restore each other's
files against a template; ``leaf_paths`` also names each leaf by its
path of keys, indices and field names, as
``jax.tree_util.tree_flatten_with_path`` does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaf_paths", "leaves", "tree_map", "unflatten"]


def _children(node):
    """``[(key, child)]`` of a container in JAX's order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaf_paths(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in JAX's flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, child in kids:
        out.extend(leaf_paths(child, path + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def unflatten(template, flat) -> Any:
    """A tree shaped like ``template`` whose leaves are ``flat`` in
    JAX's order (dict key order preserved as in the template)."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            built = {k: build(c) for k, c in kids}
            return {k: built[k] for k in node}
        vals = [build(c) for _, c in kids]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat[1:]):
        raise ValueError("trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
