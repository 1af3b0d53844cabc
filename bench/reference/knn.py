"""Exact kNN over the reference's database embeddings."""

from __future__ import annotations

import torch


def cosine_scores(queries, database):
    """(Q, D) x (N, D) -> (Q, N) cosine similarities, float32."""
    qn = queries / (torch.linalg.norm(queries, dim=-1, keepdim=True) + 1e-9)
    dn = database / (torch.linalg.norm(database, dim=-1, keepdim=True) + 1e-9)
    return qn @ dn.T


def top_k(scores, k: int):
    """Indices of the k best of each row, best first, ties to the lower
    index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def retrieval_gap(scores_row, got, k: int) -> float:
    """How far below the reference's k-th best the worst of the ``k`` ids
    the program retrieved lies: 0 when they are the reference's top k (or
    tie with it), infinite when they are not k distinct ids in range."""
    n = scores_row.shape[0]
    got = [int(i) for i in got]
    if len(got) != k or len(set(got)) != k or not all(0 <= i < n
                                                      for i in got):
        return float("inf")
    kth = scores_row[top_k(scores_row, k)[-1]]
    worst = scores_row[torch.as_tensor(got, device=scores_row.device)].min()
    return max(0.0, float(kth - worst))
