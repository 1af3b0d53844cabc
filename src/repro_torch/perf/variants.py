"""Perf-iteration cell variants (counterpart of ``repro.perf.variants``).

Each builder mirrors a baseline cell of ``launch.steps`` with one change:

  LM decode  v1  split-K attention (``distributed.decode_attn``)
             v2  + int8 KV cache with per-(token, head) scales
  MoE train  v1  gradient-accumulation microbatching
             v2  Megatron-style expert FFN sharding
  GNN train  v1  dst-partitioned shard-local aggregation

As in ``launch.steps``, the decode variant writes its cache IN PLACE and
the train steps update their state in place.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.decode_attn import make_distributed_decode_attn
from repro_torch.distributed.hints import sharding_hints
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import all_axes, axes_group, dp_axes
from repro_torch.launch.steps import (_METRICS_SPEC, CellProgram,
                                      _replicated, _sds, _serving_params_abs,
                                      _state_spec, _train_step,
                                      build_lm_cell, gnn_batch_abstract)
from repro_torch.models import transformer as tr
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.pytree import leaves
from repro_torch.training.train_loop import value_and_grad


# ---------------------------------------------------------------------------
# LM decode variants
# ---------------------------------------------------------------------------

def quantized_cache_abstract(cfg: tr.TransformerConfig, batch: int,
                             s_max: int) -> dict:
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    scale = (cfg.n_layers, batch, s_max, cfg.n_kv_heads)
    return {"k": _sds(shape, torch.int8), "v": _sds(shape, torch.int8),
            "k_scale": _sds(scale, torch.bfloat16),
            "v_scale": _sds(scale, torch.bfloat16)}


def _quantize_token(x: torch.Tensor):
    """x: (B, KV, D) -> int8 codes + (B, KV) bf16 scale; the division in
    x's dtype, as the reference divides."""
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = (amax / 127.0 + 1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale[..., None].to(x.dtype)),
                    -127, 127).to(torch.int8)
    return q, scale


def decode_step_variant(params, cache: dict, token: torch.Tensor,
                        pos: torch.Tensor, cfg, attn_impl, int8_kv: bool,
                        compute_dtype=torch.bfloat16):
    """``decode_step`` with injected split-K attention and optional int8 KV.

    cache: {"k", "v"} (L, B, S, H_kv, D), plus {"k_scale", "v_scale"} (L,
    B, S, H_kv) bf16 with ``int8_kv``.  Row b's K/V goes to position
    ``pos[b]``; a row at ``pos >= S`` writes nothing (JAX drops it).  The
    cache is updated in place.  Returns (logits (B, V), cache)."""
    B = token.shape[0]
    s_max = cache["k"].shape[2]
    x = tr._embed(params, token, compute_dtype)[:, None, :]
    b_idx = torch.arange(B, device=token.device)
    pos_l = pos.long()
    at = torch.clamp(pos_l, max=s_max - 1)
    keep = (pos_l < s_max)[:, None]

    def put(c, new):
        # write position `at` of each row, or its old value back
        c[b_idx, at] = torch.where(keep.reshape(
            (B,) + (1,) * (new.dim() - 1)), new.to(c.dtype), c[b_idx, at])

    cache_len = (pos + 1).to(torch.int32)

    def attend(i, q, k, v):
        kc, vc = cache["k"][i], cache["v"][i]
        if not int8_kv:
            put(kc, k[:, 0])
            put(vc, v[:, 0])
            return attn_impl(q, kc.to(compute_dtype), vc.to(compute_dtype),
                             cache_len)
        ks, vs = cache["k_scale"][i], cache["v_scale"][i]
        kq, ks_new = _quantize_token(k[:, 0])
        vq, vs_new = _quantize_token(v[:, 0])
        put(kc, kq)
        put(vc, vq)
        put(ks, ks_new)
        put(vs, vs_new)
        return attn_impl(q, kc, vc, ks, vs, cache_len)

    x = tr._layers(x, params, cfg, pos[:, None], compute_dtype, attend)
    return tr._logits(params, x, cfg, compute_dtype)[:, 0], cache


def build_lm_decode_variant(arch: ArchSpec, shape: ShapeSpec, mesh,
                            splitk: bool = True,
                            int8_kv: bool = False) -> CellProgram:
    if not splitk:
        raise ValueError("the decode variant is the split-K program; the "
                         "baseline decode is launch.steps.build_lm_cell")
    cfg = arch.config
    if shape.variant:
        cfg = replace(cfg, **shape.variant)
    dp = dp_axes(mesh)
    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]
    params_abs = _serving_params_abs(cfg)
    pspec = sh.lm_param_specs(params_abs, mesh, train=False)
    io = sh.lm_decode_io_specs(mesh, B)
    bx = sh.divisible_axes(B, dp, mesh)
    moe_spec = P(bx, "model", None, None)
    attn = make_distributed_decode_attn(mesh, cfg.q_per_kv,
                                        quantized=int8_kv)

    if int8_kv:
        cache_abs = quantized_cache_abstract(cfg, B, S)
        cache_spec = {
            "k": P(None, bx, "model", None, None),
            "v": P(None, bx, "model", None, None),
            "k_scale": P(None, bx, "model", None),
            "v_scale": P(None, bx, "model", None)}
    else:
        cache_abs = tr.abstract_cache(cfg, B, S)
        cache_spec = sh.lm_cache_specs(cache_abs, mesh)

    def step(params, cache, token, pos):
        with sharding_hints(moe_dispatch=moe_spec):
            return decode_step_variant(params, cache, token, pos, cfg,
                                       attn, int8_kv)

    name = (f"{arch.arch_id}:{shape.name}:"
            f"{'splitk_int8kv' if int8_kv else 'splitk'}")
    return CellProgram(
        name, step,
        (params_abs, cache_abs, _sds((B,), torch.int32),
         _sds((B,), torch.int32)),
        (pspec, cache_spec, io["token"], io["pos"]),
        (io["logits"], cache_spec), donate=(1,))


# ---------------------------------------------------------------------------
# MoE train variants (microbatching / Megatron expert sharding)
# ---------------------------------------------------------------------------

def build_lm_train_variant(arch: ArchSpec, shape: ShapeSpec, mesh,
                           microbatches: int = 1,
                           moe_megatron: bool = False,
                           sequence_parallel: bool = True) -> CellProgram:
    prog = build_lm_cell(arch, shape, mesh, microbatches=microbatches,
                         sequence_parallel=sequence_parallel)
    if moe_megatron:
        pspec = sh.lm_param_specs(prog.abstract_inputs[0]["params"], mesh,
                                  train=True, moe_megatron=True)
        prog.in_specs = (_state_spec(pspec), prog.in_specs[1])
        prog.out_specs = (_state_spec(pspec), prog.out_specs[1])
    prog.name = (f"{arch.arch_id}:{shape.name}:mb{microbatches}"
                 + ("_megatron" if moe_megatron else "")
                 + ("" if sequence_parallel else "_nosp"))
    return prog


# ---------------------------------------------------------------------------
# GNN dst-partitioned variant
# ---------------------------------------------------------------------------

def build_gnn_partitioned_variant(arch: ArchSpec, shape: ShapeSpec,
                                  mesh) -> CellProgram:
    """Each rank runs the step on its shards (nodes, and the edges whose
    dst it owns, dst local); the loss shares and the parameter gradients
    are summed over the shards' axes before AdamW, as the reference's
    transpose of its replicated parameters sums them."""
    from repro_torch.configs.pna import config_for_shape
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models.gnn_partitioned import loss_partitioned
    cfg = config_for_shape(shape)
    ax = all_axes(mesh)
    batch_abs, _ = gnn_batch_abstract(shape)
    batch_abs.pop("graph_ids", None)
    batch_abs.pop("y", None)
    n_nodes = batch_abs["x"].shape[0]
    n_edges = batch_abs["edges"].shape[1]
    node_ax = sh.divisible_axes(n_nodes, ax, mesh)
    edge_ax = sh.divisible_axes(n_edges, ax, mesh)
    # the partitioned contract needs nodes and edges sharded the same way
    axes = node_ax if node_ax == edge_ax else ("data",)

    params_abs = gnn_mod.abstract_params(cfg)
    state_abs = {"params": params_abs, "opt": init_opt_state(params_abs)}
    state_spec = _state_spec(_replicated(params_abs))
    batch_spec = {"x": P(axes, None), "edges": P(None, axes),
                  "edge_mask": P(axes), "labels": P(axes),
                  "label_mask": P(axes)}
    grads_of = value_and_grad(
        lambda p, b: loss_partitioned(p, b, cfg, mesh, axes))
    _, group = axes_group(mesh, axes)

    def grad_fn(p, batch):
        loss, grads = grads_of(p, batch)
        if group is not None:
            for t in [loss] + leaves(grads):
                torch.distributed.all_reduce(t, group=group)
        return loss, grads

    return CellProgram(f"{arch.arch_id}:{shape.name}:dst_partitioned",
                       _train_step(grad_fn, AdamWConfig()),
                       (state_abs, batch_abs), (state_spec, batch_spec),
                       (state_spec, _METRICS_SPEC), donate=(0,))
