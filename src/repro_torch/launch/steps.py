"""Cell programs: (step fn, specs, abstract inputs) per (arch x shape)
(counterpart of ``repro.launch.steps``).

The dry-run (``launch/dryrun.py``) runs exactly these programs on meta
DTensors over a fake process group; the card and the tests run the same
builders with concrete tensors on a 1 x 1 mesh, so the program lowered
and the program executed are one code path.

Where JAX's programs are pure, these follow the port's model functions:
a train step updates the state's tensors IN PLACE (its parameter leaves
are made autograd leaves over the same storage, as
``training.train_loop.init_state`` does) and returns the same state; the
decode step writes its cache in place.  ``donate`` is kept as metadata.
``abstract_inputs`` are trees of meta tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.hints import sharding_hints
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import all_axes, axis_size, dp_axes
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr
from repro_torch.retrieval.exact import top_k
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        init_opt_state)
from repro_torch.training.pytree import tree_map
from repro_torch.training.train_loop import value_and_grad


@dataclass
class CellProgram:
    name: str
    fn: Callable               # fn(*args)
    abstract_inputs: tuple     # trees of meta tensors, aligned to args
    in_specs: tuple            # spec trees, aligned to args
    out_specs: Any
    donate: tuple[int, ...] = ()


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _trainable(params):
    """The parameter leaves as autograd leaves over the same storage."""
    return tree_map(
        lambda t: t.detach().requires_grad_(t.is_floating_point()), params)


def _train_step(grad_fn, opt_cfg: AdamWConfig, hints: dict | None = None):
    """step(state, batch, mark=None) -> (state, {"loss", "grad_norm"}):
    ``grad_fn(params, batch) -> (loss, grads)``, then AdamW, in place.
    ``mark``, when given, is called with no argument between the two (a
    timer's boundary, e.g. a CUDA event's ``record``)."""
    def step(state, batch, mark=None):
        params = _trainable(state["params"])
        with sharding_hints(**(hints or {})):
            loss_val, grads = grad_fn(params, batch)
        if mark is not None:
            mark()
        _, opt, gnorm = adamw_update(grads, state["opt"], params, opt_cfg)
        return ({"params": params, "opt": opt},
                {"loss": loss_val, "grad_norm": gnorm})
    return step


def _state_spec(pspec) -> dict:
    return {"params": pspec, "opt": {"m": pspec, "v": pspec, "step": P()}}


_METRICS_SPEC = {"loss": P(), "grad_norm": P()}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cfg(arch: ArchSpec, shape: ShapeSpec) -> tr.TransformerConfig:
    cfg = arch.config
    if shape.variant:
        cfg = replace(cfg, **shape.variant)
    return cfg


def _head_hints(cfg: tr.TransformerConfig, mesh, bx, seq_len: int) -> dict:
    """The ``"q_proj"`` / ``"kv_proj"`` hints of ``tr._qkv`` for heads
    that do not divide the "model" axis.  DTensor cannot view such a
    projection, sharded on its features over "model", as (heads, d_head),
    nor, in the backward, the repeated KV heads' gradient as (H_kv,
    q_per_kv) or the output projection's input gradient as heads; XLA
    tiles them with replication instead.  Here they are
    sharded on the sequence over "model" (replicated there when the
    sequence does not divide either, as a decode step's one position); a
    head count that divides the axis gets no hint.  The spec names the
    (batch, sequence) dims only, so it fits the projection and the heads."""
    m = axis_size(mesh, "model")
    spec = P(bx, "model" if seq_len % m == 0 else None)
    return {"q_proj": spec if cfg.n_heads % m else None,
            "kv_proj": spec if cfg.n_kv_heads % m else None}


def _serving_params_abs(cfg) -> dict:
    return tr.quantize_for_serving(tr.abstract_params(cfg)).tree()


def build_lm_cell(arch: ArchSpec, shape: ShapeSpec, mesh,
                  opt_cfg: AdamWConfig = AdamWConfig(),
                  microbatches: int = 1,
                  sequence_parallel: bool = True) -> CellProgram:
    cfg = _lm_cfg(arch, shape)
    dp = dp_axes(mesh)
    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]
    name = f"{arch.arch_id}:{shape.name}"

    if shape.step == "train":
        params_abs = tr.abstract_params(cfg, torch.float32).tree()
        state_abs = {"params": params_abs, "opt": init_opt_state(params_abs)}
        batch_abs = {"tokens": _sds((B, S), torch.int32),
                     "labels": _sds((B, S), torch.int32)}
        pspec = sh.lm_param_specs(params_abs, mesh, train=True)
        batch_spec = {"tokens": sh.lm_batch_specs(mesh, B),
                      "labels": sh.lm_batch_specs(mesh, B)}
        sp_spec = P(dp, "model", None) if sequence_parallel else None
        mb = microbatches
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of {mb} "
                             "microbatches")
        bx = sh.divisible_axes(B // mb, dp, mesh)
        moe_spec = P(bx, "model", None, None)
        step_hints = {"moe_dispatch": moe_spec,
                      **_head_hints(cfg, mesh, bx, S)}

        def loss(p, batch):
            return tr.loss_fn(p, batch["tokens"], batch["labels"], cfg,
                              remat=True, sp_spec=sp_spec)

        grad_fn = value_and_grad(loss)

        def accumulated(p, batch):
            # gradient accumulation over microbatches (JAX: a scan), one
            # backward each, so one microbatch's activations live at a time
            if mb == 1:
                return grad_fn(p, batch)
            toks = batch["tokens"].reshape(mb, B // mb, S)
            labs = batch["labels"].reshape(mb, B // mb, S)
            total, acc = 0.0, None
            for i in range(mb):
                l, g = grad_fn(p, {"tokens": toks[i], "labels": labs[i]})
                total = total + l
                acc = g if acc is None else tree_map(torch.add, acc, g)
            return total / mb, tree_map(lambda g: g / mb, acc)

        return CellProgram(name, _train_step(accumulated, opt_cfg,
                                             step_hints),
                           (state_abs, batch_abs),
                           (_state_spec(pspec), batch_spec),
                           (_state_spec(pspec), _METRICS_SPEC),
                           donate=(0,))

    params_abs = _serving_params_abs(cfg)
    pspec = sh.lm_param_specs(params_abs, mesh, train=False)
    bx = sh.divisible_axes(B, dp, mesh)
    moe_spec = P(bx, "model", None, None)

    if shape.step == "prefill":
        tokens_abs = _sds((B, S), torch.int32)
        step_hints = _head_hints(cfg, mesh, bx, S)

        def step(params, tokens):
            with sharding_hints(moe_dispatch=moe_spec, **step_hints):
                return tr.prefill(params, tokens, cfg)

        cache_abs = tr.abstract_cache(cfg, B, S)
        return CellProgram(
            name, step, (params_abs, tokens_abs),
            (pspec, sh.lm_batch_specs(mesh, B)),
            (P(bx, "model"), sh.lm_cache_specs(cache_abs, mesh)))

    if shape.step == "decode":
        cache_abs = tr.abstract_cache(cfg, B, S)
        cache_spec = sh.lm_cache_specs(cache_abs, mesh)
        io = sh.lm_decode_io_specs(mesh, B)
        step_hints = _head_hints(cfg, mesh, bx, 1)

        def step(params, cache, token, pos):
            with sharding_hints(moe_dispatch=moe_spec, **step_hints):
                return tr.decode_step(params, cache, token, pos, cfg)

        return CellProgram(
            name, step,
            (params_abs, cache_abs, _sds((B,), torch.int32),
             _sds((B,), torch.int32)),
            (pspec, cache_spec, io["token"], io["pos"]),
            (io["logits"], cache_spec),
            donate=(1,))

    raise ValueError(shape.step)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _pad512(n: int) -> int:
    return -(-n // 512) * 512


def gnn_batch_abstract(shape: ShapeSpec) -> tuple[dict, dict | None]:
    """Returns (batch of meta tensors, static metadata).

    Node AND edge arrays are padded to a 512-multiple so they shard over
    any mesh.  Conventions: padded edges carry edge_mask=0 and point at a
    pad node; pad nodes have zero features, label_mask=0 and (molecule)
    graph_id == n_graphs (out of range -> dropped by segment_sum)."""
    d = shape.dims
    f32, i32 = torch.float32, torch.int32
    if shape.name == "minibatch_lg":
        b, (f1, f2) = d["batch_nodes"], d["fanout"]
        n_sub = _pad512(b * (1 + f1 + f1 * f2))
        e_sub = _pad512(b * f1 + b * f1 * f2)
        return ({"x": _sds((n_sub, d["d_feat"]), f32),
                 "edges": _sds((2, e_sub), i32),
                 "edge_mask": _sds((e_sub,), f32),
                 "labels": _sds((n_sub,), i32),
                 "label_mask": _sds((n_sub,), f32)}, None)
    if shape.name == "molecule":
        n = _pad512(d["batch"] * d["n_nodes"])
        e = _pad512(d["batch"] * d["n_edges"])
        return ({"x": _sds((n, d["d_feat"]), f32),
                 "edges": _sds((2, e), i32),
                 "edge_mask": _sds((e,), f32),
                 "graph_ids": _sds((n,), i32),
                 "y": _sds((d["batch"],), f32)},
                {"n_graphs": d["batch"]})
    e = _pad512(d["n_edges"])
    n = _pad512(d["n_nodes"])
    return ({"x": _sds((n, d["d_feat"]), f32),
             "edges": _sds((2, e), i32),
             "edge_mask": _sds((e,), f32),
             "labels": _sds((n,), i32),
             "label_mask": _sds((n,), f32)}, None)


def _replicated(tree):
    return tree_map(lambda _: P(), tree)


def build_gnn_cell(arch: ArchSpec, shape: ShapeSpec, mesh,
                   opt_cfg: AdamWConfig = AdamWConfig()) -> CellProgram:
    from repro_torch.configs.pna import config_for_shape
    cfg = config_for_shape(shape)
    ax = all_axes(mesh)
    name = f"{arch.arch_id}:{shape.name}"
    batch_abs, meta = gnn_batch_abstract(shape)
    n_graphs = (meta or {}).get("n_graphs")

    params_abs = gnn.abstract_params(cfg)
    state_abs = {"params": params_abs, "opt": init_opt_state(params_abs)}
    state_spec = _state_spec(_replicated(params_abs))

    n_nodes = batch_abs["x"].shape[0]
    n_edges = batch_abs["edges"].shape[1]
    node_ax = sh.divisible_axes(n_nodes, ax, mesh)
    edge_ax = sh.divisible_axes(n_edges, ax, mesh)

    def batch_spec_of(k):
        if k == "edges":
            return P(None, edge_ax)
        if k == "edge_mask":
            return P(edge_ax)
        if k == "x":
            return P(node_ax, None)
        if k in ("labels", "label_mask", "graph_ids"):
            return P(node_ax)
        return P()

    batch_spec = {k: batch_spec_of(k) for k in batch_abs}

    def loss(p, batch):
        b = dict(batch)
        if n_graphs is not None:
            b["n_graphs"] = n_graphs
        return gnn.loss_fn(p, b, cfg)

    hints = {"gnn_nodes": P(node_ax, None), "gnn_edges": P(edge_ax, None)}
    return CellProgram(name, _train_step(value_and_grad(loss), opt_cfg,
                                         hints),
                       (state_abs, batch_abs), (state_spec, batch_spec),
                       (state_spec, _METRICS_SPEC), donate=(0,))


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------

_RECSYS = {
    "dlrm-rm2": {
        "init": recsys.dlrm_init, "loss": recsys.dlrm_loss,
        "fwd": lambda p, b, c: recsys.dlrm_forward(p, b["dense"],
                                                   b["sparse"], c),
        "score": lambda p, b, c: list(top_k(
            recsys.dlrm_score_candidates(p, b["dense"], b["sparse"],
                                         b["candidates"], c), 100)),
    },
    "two-tower-retrieval": {
        "init": recsys.two_tower_init, "loss": recsys.two_tower_loss,
        "fwd": lambda p, b, c: recsys.user_tower(p, b["user_ids"],
                                                 b["hist_ids"], c),
        "score": lambda p, b, c: list(recsys.two_tower_score_candidates(
            p, b["user_ids"], b["hist_ids"], b["candidates"], c, 100)),
    },
    "xdeepfm": {
        "init": recsys.xdeepfm_init, "loss": recsys.xdeepfm_loss,
        "fwd": lambda p, b, c: recsys.xdeepfm_forward(p, b["sparse"], c),
        "score": lambda p, b, c: list(top_k(
            recsys.xdeepfm_score_candidates(p, b["sparse"], b["candidates"],
                                            c), 100)),
    },
    "mind": {
        "init": recsys.mind_init, "loss": recsys.mind_loss,
        "fwd": lambda p, b, c: recsys.mind_interests(p, b["hist_ids"], c),
        "score": lambda p, b, c: list(recsys.mind_score_candidates(
            p, b["hist_ids"], b["candidates"], c, 100)),
    },
}


def recsys_batch_abstract(arch_id: str, cfg, shape: ShapeSpec) -> dict:
    B = shape.dims["batch"]
    n_cand = shape.dims.get("n_candidates", 0)
    f32, i32 = torch.float32, torch.int32
    if arch_id == "dlrm-rm2":
        b = {"dense": _sds((B, cfg.n_dense), f32),
             "sparse": _sds((B, cfg.n_sparse), i32)}
    elif arch_id == "two-tower-retrieval":
        b = {"user_ids": _sds((B,), i32),
             "hist_ids": _sds((B, cfg.hist_len), i32)}
        if shape.step == "train":
            b["item_ids"] = _sds((B,), i32)
            b["log_q"] = _sds((B,), f32)
    elif arch_id == "xdeepfm":
        b = {"sparse": _sds((B, cfg.n_sparse), i32)}
    elif arch_id == "mind":
        b = {"hist_ids": _sds((B, cfg.hist_len), i32)}
        if shape.step == "train":
            b["item_ids"] = _sds((B,), i32)
    else:
        raise KeyError(arch_id)
    if shape.step == "train" and arch_id in ("dlrm-rm2", "xdeepfm"):
        b["labels"] = _sds((B,), f32)
    if shape.step == "score":
        b["candidates"] = _sds((n_cand,), i32)
    return b


def build_recsys_cell(arch: ArchSpec, shape: ShapeSpec, mesh,
                      opt_cfg: AdamWConfig = AdamWConfig()) -> CellProgram:
    cfg = arch.config
    ops = _RECSYS[arch.arch_id]
    ax = all_axes(mesh)
    name = f"{arch.arch_id}:{shape.name}"
    batch_abs = recsys_batch_abstract(arch.arch_id, cfg, shape)
    params_abs = ops["init"](torch.Generator(), cfg, device="meta")
    pspec = sh.recsys_param_specs(params_abs, mesh)

    def batch_spec_of(k, leaf):
        if shape.step == "score":
            if k == "candidates":
                return P(sh.divisible_axes(leaf.shape[0], ax, mesh))
            return P(*([None] * len(leaf.shape)))    # single user, replicated
        bx = sh.divisible_axes(leaf.shape[0], ax, mesh)
        return P(bx, *([None] * (len(leaf.shape) - 1)))

    batch_spec = {k: batch_spec_of(k, v) for k, v in batch_abs.items()}
    # xDeepFM's CIN input sharded as its rows (the batch, or the candidates)
    n_rows = shape.dims["n_candidates" if shape.step == "score" else "batch"]
    cell_hints = {"cin_in": P(sh.divisible_axes(n_rows, ax, mesh), None,
                              None)}

    if shape.step == "train":
        state_abs = {"params": params_abs, "opt": init_opt_state(params_abs)}

        def loss(p, batch):
            return ops["loss"](p, batch, cfg)

        return CellProgram(name, _train_step(value_and_grad(loss), opt_cfg,
                                             cell_hints),
                           (state_abs, batch_abs),
                           (_state_spec(pspec), batch_spec),
                           (_state_spec(pspec), _METRICS_SPEC),
                           donate=(0,))

    if shape.step == "forward":
        def step(params, batch):
            with sharding_hints(**cell_hints):
                return ops["fwd"](params, batch, cfg)

        with torch.no_grad():
            out_abs = step(params_abs, batch_abs)
        out_spec = tree_map(
            lambda leaf: P(sh.divisible_axes(leaf.shape[0], ax, mesh),
                           *([None] * (len(leaf.shape) - 1))), out_abs)
        return CellProgram(name, step, (params_abs, batch_abs),
                           (pspec, batch_spec), out_spec)

    if shape.step == "score":
        def step(params, batch):
            with sharding_hints(**cell_hints):
                return ops["score"](params, batch, cfg)

        return CellProgram(name, step, (params_abs, batch_abs),
                           (pspec, batch_spec), [P(), P()])

    raise ValueError(shape.step)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def build_cell(arch: ArchSpec, shape: ShapeSpec, mesh,
               **kw) -> CellProgram:
    if arch.family == "lm":
        return build_lm_cell(arch, shape, mesh, **kw)
    if arch.family == "gnn":
        return build_gnn_cell(arch, shape, mesh, **kw)
    if arch.family == "recsys":
        return build_recsys_cell(arch, shape, mesh, **kw)
    raise ValueError(arch.family)
