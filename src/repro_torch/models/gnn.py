"""PNA (Principal Neighbourhood Aggregation) GNN  [arXiv:2004.05718]
(mirror of ``repro.models.gnn``).

Message passing is built from edge-index gathers and segment scatters
(``models.embedding.take`` / ``segment_*``, with the reference's index
rules).  Aggregators: mean / max / min / std.  Scalers: identity /
amplification / attenuation (degree-based, normalized by the train-set
mean log-degree).

Graphs are flat tensors: ``x (N, F)``, ``edges (2, E)`` (src, dst) with an
optional ``graph_ids (N,)`` for batched disjoint-union small graphs
(molecule shape).  Padding convention: padded edges point at node index
``N-1`` of a zero-feature pad node with ``edge_mask`` zeroing their
messages; pad nodes carry ``graph_id == n_graphs``, which the graph
readout drops.  Degree counts edges weighted by ``edge_mask``, while a
masked edge's zero message still enters the max and min at its
destination, as in the reference.

Node and edge tensors are pinned to a mesh layout with
``hints.constrain`` (``"gnn_nodes"``, ``"gnn_edges"``), as in the
reference: DTensors are redistributed, plain tensors left alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed import hints
from repro_torch.models.embedding import (init_device, mlp_apply, mlp_init,
                                          segment_max, segment_min,
                                          segment_sum, take)


@dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 1433
    n_classes: int = 7
    aggregators: tuple[str, ...] = ("mean", "max", "min", "std")
    scalers: tuple[str, ...] = ("identity", "amplification", "attenuation")
    mean_log_degree: float = 2.0   # delta: avg of log(d+1) over train graphs
    graph_level: bool = False      # molecule: graph readout + regression head

    @property
    def n_towers(self) -> int:
        return len(self.aggregators) * len(self.scalers)


def init_params(generator: torch.Generator, cfg: PNAConfig,
                dtype=torch.float32, device=None) -> dict:
    device = init_device(generator, device)
    d = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            # message MLP on concat(h_src, h_dst)
            "msg": mlp_init(generator, (2 * d, d), dtype, device),
            # post-aggregation: concat(h_i, n_towers * d) -> d
            "upd": mlp_init(generator, ((1 + cfg.n_towers) * d, d), dtype,
                            device),
            "ln": torch.ones((d,), dtype=dtype, device=device),
        })
    return {
        "encoder": mlp_init(generator, (cfg.d_feat, d), dtype, device),
        "layers": layers,
        "head": mlp_init(generator, (d, cfg.n_classes), dtype, device),
    }


def abstract_params(cfg: PNAConfig, dtype=torch.float32) -> dict:
    """``init_params``'s tree on the meta device: shapes and dtypes, no
    storage (the counterpart of the reference's ``jax.eval_shape``)."""
    return init_params(torch.Generator(), cfg, dtype, device="meta")


def _aggregate(msg: torch.Tensor, dst: torch.Tensor, n_nodes: int,
               degree: torch.Tensor, cfg: PNAConfig) -> list[torch.Tensor]:
    outs = []
    safe_deg = torch.clamp(degree, min=1.0)[:, None]
    has_edges = degree[:, None] > 0
    zero = torch.zeros((), dtype=msg.dtype, device=msg.device)
    s = None
    for agg in cfg.aggregators:
        if agg in ("mean", "std") and s is None:
            s = segment_sum(msg, dst, n_nodes)
        if agg == "mean":
            outs.append(s / safe_deg)
        elif agg == "std":
            sq = segment_sum(msg * msg, dst, n_nodes)
            mean = s / safe_deg
            outs.append(torch.sqrt(torch.relu(sq / safe_deg - mean * mean)
                                   + 1e-5))
        elif agg == "max":
            m = segment_max(msg, dst, n_nodes)
            outs.append(torch.where(has_edges, m, zero))
        elif agg == "min":
            m = segment_min(msg, dst, n_nodes)
            outs.append(torch.where(has_edges, m, zero))
        else:
            raise ValueError(agg)
    return outs


def _scale(aggs: list[torch.Tensor], degree: torch.Tensor,
           cfg: PNAConfig) -> torch.Tensor:
    logd = torch.log(degree + 1.0)[:, None]
    towers = []
    for a in aggs:
        for sc in cfg.scalers:
            if sc == "identity":
                towers.append(a)
            elif sc == "amplification":
                towers.append(a * (logd / cfg.mean_log_degree))
            elif sc == "attenuation":
                towers.append(a * (cfg.mean_log_degree
                                   / torch.clamp(logd, min=1e-5)))
            else:
                raise ValueError(sc)
    return torch.cat(towers, dim=-1)


def forward(params: dict, x: torch.Tensor, edges: torch.Tensor,
            cfg: PNAConfig, edge_mask: torch.Tensor | None = None,
            graph_ids: torch.Tensor | None = None,
            n_graphs: int | None = None) -> torch.Tensor:
    """x: (N, F) float; edges: (2, E) int.  Returns per-node logits
    (N, n_classes) or per-graph outputs (n_graphs, n_classes)."""
    n_nodes = x.shape[0]
    src, dst = edges[0], edges[1]
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    if edge_mask is not None:
        ones = ones * edge_mask
    degree = segment_sum(ones, dst, n_nodes)

    h = hints.constrain(mlp_apply(params["encoder"], x, final_act=True),
                        "gnn_nodes")
    for lp in params["layers"]:
        h_src = take(h, src)
        h_dst = take(h, dst)
        msg = hints.constrain(
            mlp_apply(lp["msg"], torch.cat([h_src, h_dst], -1),
                      final_act=True), "gnn_edges")
        if edge_mask is not None:
            msg = msg * edge_mask[:, None]
        aggs = _aggregate(msg, dst, n_nodes, degree, cfg)
        towers = _scale(aggs, degree, cfg)
        upd = mlp_apply(lp["upd"], torch.cat([h, towers], -1))
        # residual + RMS-ish norm for stability
        h = h + upd
        h = h * torch.rsqrt(torch.mean(h * h, -1, keepdim=True) + 1e-6) \
            * lp["ln"]
        h = hints.constrain(h, "gnn_nodes")
    if cfg.graph_level:
        if graph_ids is None or n_graphs is None:
            raise ValueError("a graph-level PNA needs graph_ids and n_graphs")
        pooled = segment_sum(h, graph_ids, n_graphs)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], h)


def loss_fn(params: dict, batch: dict, cfg: PNAConfig) -> torch.Tensor:
    out = forward(params, batch["x"], batch["edges"], cfg,
                  edge_mask=batch.get("edge_mask"),
                  graph_ids=batch.get("graph_ids"),
                  n_graphs=batch.get("n_graphs"))
    if cfg.graph_level:
        return torch.mean(torch.square(out[..., 0] - batch["y"]))
    logits = out.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    mask = batch.get("label_mask")
    per = logz - gold
    if mask is not None:
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(per)
