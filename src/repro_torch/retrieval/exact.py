"""Brute-force kNN (mirror of ``repro.retrieval.exact``)."""

from __future__ import annotations

import torch


def top_k(scores: torch.Tensor, k: int):
    """The k largest entries along the last axis, best first; ties go to
    the lower index, as ``jax.lax.top_k`` orders them (``torch.topk``
    leaves tie order unspecified).  Returns (values, indices)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return torch.gather(scores, -1, idx), idx


def knn(queries: torch.Tensor, database: torch.Tensor, k: int = 5,
        metric: str = "l2"):
    """queries (Q, D) x database (N, D) -> (scores (Q, k), idx (Q, k))."""
    if metric == "ip":
        scores = queries @ database.T
    elif metric == "cosine":
        qn = queries / (torch.linalg.norm(queries, dim=-1, keepdim=True) + 1e-9)
        dn = database / (torch.linalg.norm(database, dim=-1, keepdim=True)
                         + 1e-9)
        scores = qn @ dn.T
    else:  # negative L2 distance
        d2 = (torch.sum(queries ** 2, -1)[:, None]
              - 2.0 * queries @ database.T
              + torch.sum(database ** 2, -1)[None, :])
        scores = -d2
    return top_k(scores, k)
