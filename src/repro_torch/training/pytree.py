"""Nested dicts of tensors as the JAX package's pytrees.

A tree is a dict whose values are trees or leaves (tensors, numpy
arrays, Python numbers).  Leaves come in sorted-key order, as
``jax.tree_util`` flattens a dict, so a tree's i-th leaf here is the
i-th leaf of the same tree in JAX: checkpoints written by either package
list their leaves in one order.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """Every leaf of ``tree``, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    return [tree]


def unflatten(tree_like, flat) -> Any:
    """A tree shaped like ``tree_like`` whose leaves are ``flat``, in
    sorted-key order."""
    flat = list(flat)
    n = len(leaves(tree_like))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a tree of {n}")
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)
    return build(tree_like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` on every leaf of ``tree`` and the leaves at the same place
    in ``rest`` (trees of the same shape)."""
    flats = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("trees of different shapes")
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])
