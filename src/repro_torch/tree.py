"""Nested containers of tensors (the port's parameter and state trees).

A tree is a dict, tuple or list of trees, or a leaf (a tensor, an array or
a scalar).  Dicts are walked in sorted key order, as ``jax.tree`` walks
them, so a sum over leaves adds them in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """Every leaf of ``tree``, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` over ``tree``'s structure.  The trees in
    ``rest`` are walked only as deep as ``tree``: where ``tree`` has a leaf,
    ``fn`` gets their whole subtree (a quantized moment's ``(q, scale)``
    tuple), as ``treedef.flatten_up_to`` does.  Leaves are visited in
    ``leaves`` order; dicts keep their key order."""
    if isinstance(tree, dict):
        out = {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_up_to(structure: Any, tree: Any) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure``, in ``leaves``
    order (``treedef.flatten_up_to``)."""
    out: list = []
    map_tree(lambda _, sub: out.append(sub), structure, tree)
    return out


def unflatten(tree: Any, values: list) -> Any:
    """``tree``'s structure with its leaves replaced, in ``leaves`` order,
    by ``values``."""
    it = iter(values)

    def rebuild(node):
        if isinstance(node, dict):
            built = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(tree)
