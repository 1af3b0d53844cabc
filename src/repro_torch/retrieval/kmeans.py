"""Lloyd's k-means (IVF coarse quantizer + PQ codebook training), a mirror
of ``repro.retrieval.kmeans``.  Seeded from a ``torch.Generator`` where the
JAX package takes a PRNG key, so the two build different indexes from the
same data."""

from __future__ import annotations

import torch


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row (L2).  x: (N, D); centroids: (K, D)."""
    dots = x @ centroids.T
    c2 = torch.sum(centroids * centroids, dim=-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    k = centroids.shape[0]
    assign = _assign(x, centroids)
    sums = torch.zeros_like(centroids).index_add_(0, assign, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, assign, torch.ones_like(assign, dtype=x.dtype))
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], centroids)
    shift = torch.sqrt(torch.sum((new - centroids) ** 2, dim=-1)).max()
    return new, shift


def kmeans(generator: torch.Generator, x: torch.Tensor, k: int,
           iters: int = 25, tol: float = 1e-4):
    """Returns (centroids (k, D), assignments (N,))."""
    n = x.shape[0]
    init_idx = torch.randperm(n, generator=generator,
                              device=generator.device)[:k].to(x.device)
    centroids = x[init_idx]
    for _ in range(iters):
        centroids, shift = _lloyd_step(x, centroids)
        if float(shift) < tol:
            break
    return centroids, _assign(x, centroids)


def train_pq_codebooks(generator: torch.Generator, x: torch.Tensor,
                       n_subq: int, n_codes: int = 256,
                       iters: int = 15) -> torch.Tensor:
    """x: (N, D) with D % n_subq == 0 -> (n_subq, n_codes, D // n_subq)."""
    n, d = x.shape
    if d % n_subq:
        raise ValueError(f"dim {d} is not a multiple of n_subq={n_subq}")
    dsub = d // n_subq
    books = []
    for s in range(n_subq):
        sub = x[:, s * dsub:(s + 1) * dsub].contiguous()
        c, _ = kmeans(generator, sub, min(n_codes, n), iters=iters)
        if c.shape[0] < n_codes:   # tiny corpora: pad codebook
            c = torch.cat([c, torch.zeros((n_codes - c.shape[0], dsub),
                                          dtype=c.dtype, device=c.device)])
        books.append(c)
    return torch.stack(books)


def pq_encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x: (N, D); codebooks: (S, 256, dsub) -> uint8 codes (N, S)."""
    s, _, dsub = codebooks.shape
    xs = x.reshape(x.shape[0], s, dsub)
    codes = [_assign(xs[:, i], codebooks[i]) for i in range(s)]
    return torch.stack(codes, dim=1).to(torch.uint8)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes: (N, S) uint8 -> reconstructed (N, S*dsub)."""
    s = codebooks.shape[0]
    return torch.cat([codebooks[i][codes[:, i].long()] for i in range(s)],
                     dim=-1)
