"""Sharding rules: PartitionSpec trees per architecture family and step
kind (counterpart of ``repro.distributed.sharding``).

Policies, as in the reference:

* **LM train**  -- FSDP over the data axes (``("pod","data")`` multi-pod)
  x tensor parallel over ``model``; MoE experts sharded over ``model``
  (EP); AdamW moments sharded as the params.
* **LM serve**  -- TP over ``model`` only; int8 weights; KV cache batch ->
  data, sequence -> ``model`` (split-K decode attention).
* **GNN**       -- edges sharded over every device, node features
  replicated.
* **Recsys**    -- embedding tables row-sharded over every device; batch
  sharded over every device for the dense side.

A spec is :class:`P`, which reads like JAX's ``PartitionSpec``: per tensor
dim ``None``, an axis name or a tuple of names, canonicalised as JAX does
(an empty tuple is ``None``, a 1-tuple its one name), so a spec tree
compares leaf for leaf with JAX's.  :func:`to_placements` turns a spec
into the DTensor placements of a mesh: a dim sharded over ``("pod",
"data")`` is ``Shard(d)`` on both mesh dims, the first one major, as in
JAX.

The rules match on leaf path names, the keys and list indices of a tree
joined by ``"/"`` as the reference joins JAX key paths; a
``TransformerParams`` is read through its ``tree()``, so ``"embed"``,
``"head"``, ``"wq"`` and ``"scale"`` hit the same leaves.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.launch.mesh import all_axes, axis_names, axis_size, dp_axes


def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """``PartitionSpec``: one entry per leading tensor dim (trailing dims
    replicate)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canon(e) for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _names(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise NotImplementedError(
                f"{spec}: a dim sharded over mesh axes out of mesh order")
        for a in axes:
            if a in owner:
                raise ValueError(f"{spec}: mesh axis {a!r} used twice")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def _tree(tree):
    return tree.tree() if hasattr(tree, "tree") else tree


def _spec_tree_from_rules(tree: Any, rule_fn, prefix: str = "") -> Any:
    """Map (path, leaf) -> P over a tree of dicts and lists."""
    tree = _tree(tree)
    if isinstance(tree, dict):
        return {k: _spec_tree_from_rules(v, rule_fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree_from_rules(v, rule_fn, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return rule_fn(prefix[:-1], tree)


def _map_leaves(fn, tree):
    tree = _tree(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _dims(leaf) -> int:
    return len(leaf.shape)


def divisible_axes(n: int, axes: tuple[str, ...], mesh):
    """Longest prefix of ``axes`` whose total size divides ``n``, or None.

    Falls back toward replication so any global dim (odd vocab, 10^6
    candidates, batch=1) shards as much as it evenly can."""
    for k in range(len(axes), 0, -1):
        sub = axes[:k]
        if n % math.prod(axis_size(mesh, a) for a in sub) == 0:
            return sub
    return None


# ---------------------------------------------------------------------------
# LM params
# ---------------------------------------------------------------------------

def lm_param_specs(params: Any, mesh, *, train: bool,
                   moe_megatron: bool = False) -> Any:
    """Spec tree matching ``transformer.init_params``'s layout.

    Quantized leaves ({"q", "scale"}) inherit the q spec; scales
    replicate.  ``moe_megatron`` shards expert FFN weights Megatron-style
    (column/row-parallel over the non-contraction dims) instead of FSDP
    over the contraction dim."""
    dp = dp_axes(mesh) if train else None  # FSDP only in training

    def rule(name: str, leaf) -> P:
        nd = _dims(leaf)
        if name.endswith("/scale"):
            return P()
        if "embed" in name:                      # (V, d)
            return P(dp, "model")
        if "head" in name:                       # (d, V)
            return P(dp, "model")
        if "ln" in name:                         # (d,) or (L, d)
            return P()
        if "router" in name:                     # (L, d, E)
            return P(None, dp, None)
        if "w_gate" in name or "w_up" in name:
            if nd == 4:                          # MoE (L, E, d, f)
                if moe_megatron:                 # column-parallel on f
                    return P(None, "model", None, dp)
                return P(None, "model", dp, None)
            return P(None, dp, "model")          # dense (L, d, f)
        if "w_down" in name:
            if nd == 4:                          # MoE (L, E, f, d)
                return P(None, "model", dp, None)
            return P(None, "model", dp)          # dense (L, f, d)
        if "wq" in name or "wk" in name or "wv" in name:
            return P(None, dp, "model")          # (L, d, H*Dh)
        if "wo" in name:
            return P(None, "model", dp)          # (L, H*Dh, d)
        return P()

    return _spec_tree_from_rules(params, rule)


def lm_cache_specs(cache: Any, mesh) -> Any:
    """KV cache (L, B, S, H_kv, D): batch -> data axes, sequence -> model."""
    def spec(leaf):
        dp = divisible_axes(leaf.shape[1], dp_axes(mesh), mesh)
        return P(None, dp, "model", None, None)
    return _map_leaves(spec, cache)


def lm_batch_specs(mesh, batch: int) -> P:
    return P(divisible_axes(batch, dp_axes(mesh), mesh), None)


def lm_decode_io_specs(mesh, batch: int) -> dict:
    dp = divisible_axes(batch, dp_axes(mesh), mesh)
    return {"token": P(dp), "pos": P(dp), "logits": P(dp, "model")}


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_specs(mesh) -> dict:
    ax = all_axes(mesh)
    return {
        "params": P(),                            # replicated (tiny)
        "x": P(),                                 # node features replicated
        "edges": P(None, ax),                     # (2, E) edges sharded
        "edge_mask": P(ax),
        "labels": P(),
        "label_mask": P(),
        "graph_ids": P(),
        "out": P(),
    }


# ---------------------------------------------------------------------------
# Recsys
# ---------------------------------------------------------------------------

def recsys_specs(mesh) -> dict:
    ax = all_axes(mesh)

    def param_rule(name: str, leaf) -> P:
        last = name.split("/")[-1]
        if "table" in last or last in ("tables", "linear"):
            if _dims(leaf) == 2:                  # (rows, dim) row-sharded
                return P(ax, None)
        return P()                                # MLPs and misc replicated

    return {"param_rule": param_rule, "batch": P(ax), "candidates": P(ax),
            "out": P(ax)}


def recsys_param_specs(params: Any, mesh) -> Any:
    return _spec_tree_from_rules(params, recsys_specs(mesh)["param_rule"])


def recsys_batch_specs(batch: Any, mesh) -> Any:
    ax = all_axes(mesh)
    return _map_leaves(lambda leaf: P(ax, *([None] * (_dims(leaf) - 1))),
                       batch)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def is_spec(x) -> bool:
    return isinstance(x, P)


def map_specs(fn, spec_tree: Any) -> Any:
    """``fn`` on every :class:`P` of a tree of dicts, lists and tuples."""
    if is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def to_named(spec_tree: Any, mesh) -> Any:
    """The tree of placements of a spec tree (JAX: of ``NamedSharding``s)."""
    return map_specs(lambda s: to_placements(s, mesh), spec_tree)
