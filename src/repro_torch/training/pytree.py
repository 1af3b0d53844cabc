"""Nested dicts and lists of tensors as the JAX package's pytrees.

A tree is a dict or a list whose values are trees or leaves (tensors,
numpy arrays, Python numbers).  Leaves come in sorted-key order inside a
dict and in index order inside a list, as ``jax.tree_util`` flattens
them, so a tree's i-th leaf here is the i-th leaf of the same tree in JAX:
checkpoints written by either package list their leaves in one order.
"""

from __future__ import annotations

from typing import Any, Callable


def children(node) -> list | None:
    """``(key, child)`` pairs of a dict (sorted keys) or a list (indices)
    in flattening order; None for a leaf."""
    if isinstance(node, dict):
        return [(key, node[key]) for key in sorted(node)]
    if isinstance(node, list):
        return list(enumerate(node))
    return None


def leaves(tree) -> list:
    """Every leaf of ``tree``, in flattening order."""
    kids = children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in leaves(child)]


def unflatten(tree_like, flat) -> Any:
    """A tree shaped like ``tree_like`` whose leaves are ``flat``, in
    flattening order."""
    flat = list(flat)
    n = len(leaves(tree_like))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a tree of {n}")
    return _build(tree_like, iter(flat))


def _build(node, it):
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle that would hold ``it``, and with it every leaf
    # (a step's gradients), until the cyclic collector runs
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    if isinstance(node, list):
        return [_build(child, it) for child in node]
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` on every leaf of ``tree`` and the leaves at the same place
    in ``rest`` (trees of the same shape)."""
    flats = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("trees of different shapes")
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])
