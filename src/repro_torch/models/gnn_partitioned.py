"""Dst-partitioned PNA (counterpart of ``repro.models.gnn_partitioned``).

Baseline PNA shards edges arbitrarily, so every ``segment_*`` op scatters
into a full (N, d) node array on every device, which is then all-reduced.
This variant changes the input contract: the data loader delivers edges
**partitioned by destination shard**, with dst indices local to the shard
and src indices global.  Aggregation then stays shard-local; the only
traffic is one all-gather of node features per layer (forward) and its
transpose in the backward: 2 x (N x d) per layer.

Where the reference's ``shard_map`` hands each device its block, each
rank here calls these functions on its own shards, and the all-gather is
the functional collective ``all_gather_single_autograd`` over the
``axes`` process group, whose backward is the reduce-scatter of the
reference's count: every rank's cotangent summed into the block's owner.
On axes of one device there is no collective.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import axes_group
from repro_torch.models import gnn
from repro_torch.models.embedding import mlp_apply, segment_sum, take


def _gather_nodes(h_local: torch.Tensor, group) -> torch.Tensor:
    """Every shard's node block, in shard order (JAX: tiled all_gather)."""
    if group is None:
        return h_local
    from torch.distributed._functional_collectives import (
        all_gather_single_autograd, wait_tensor)
    return wait_tensor(all_gather_single_autograd(h_local, 0, group))


def forward_partitioned(params: dict, x_local, edges_local, cfg, mesh, axes,
                        edge_mask_local=None, compute_dtype=torch.float32):
    """x_local: (N/shards, F) node shard; edges_local: (2, E/shards) with
    src GLOBAL ids and dst LOCAL ids.  Returns local logits."""
    _, group = axes_group(mesh, axes)
    src, dst = edges_local[0], edges_local[1]
    n_local = x_local.shape[0]
    ml = edge_mask_local
    if ml is None:
        ml = torch.ones(edges_local.shape[1], dtype=torch.float32,
                        device=edges_local.device)
    degree = segment_sum(ml, dst, n_local)

    h_local = mlp_apply(params["encoder"], x_local.to(compute_dtype),
                        final_act=True)
    for lp in params["layers"]:
        # one all-gather per layer: every shard needs remote sources
        h_full = _gather_nodes(h_local, group)
        h_src = take(h_full, src)
        h_dst = take(h_local, dst)
        msg = mlp_apply(lp["msg"], torch.cat([h_src, h_dst], -1),
                        final_act=True)
        msg = msg * ml[:, None]
        aggs = gnn._aggregate(msg, dst, n_local, degree, cfg)
        towers = gnn._scale(aggs, degree, cfg)
        upd = mlp_apply(lp["upd"], torch.cat([h_local, towers], -1))
        h_local = h_local + upd
        h_local = h_local * torch.rsqrt(
            torch.mean(h_local * h_local, -1, keepdim=True) + 1e-6) \
            * lp["ln"]
    return mlp_apply(params["head"], h_local)


def loss_partitioned(params, batch, cfg, mesh, axes):
    """This rank's share of the global masked cross entropy: the sum of
    its nodes' losses over the global count of labelled nodes.  The
    shares sum to the reference's loss over the whole graph, and so do
    the ranks' parameter gradients (the step sums both over ``axes``)."""
    out = forward_partitioned(params, batch["x"], batch["edges"], cfg,
                              mesh, axes,
                              edge_mask_local=batch.get("edge_mask"))
    logits = out.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    per = logz - gold
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones_like(per)
    count = torch.sum(mask).detach()
    _, group = axes_group(mesh, axes)
    if group is not None:
        torch.distributed.all_reduce(count, group=group)
    return torch.sum(per * mask) / torch.clamp(count, min=1.0)
