"""IVF-PQ vector search in PyTorch (mirror of ``repro.retrieval.ivf_pq``).

Index: k-means coarse quantizer (IVF lists) + product-quantized residuals,
packed as padded (n_lists, list_len) id and code tables (padding id -1).
Query: (1) coarse scan -> top-nprobe lists, (2) ADC lookup tables, (3) PQ
code scan over the probed lists -- with ``use_kernel``, one launch of the
CUDA ``pq_scan`` kernel reading them in place -- and (4) top-k.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.pq_scan.ops import pq_scan_lists
from repro_torch.kernels.pq_scan.ref import pq_scan_ref
from repro_torch.retrieval import kmeans as km
from repro_torch.retrieval.exact import knn, top_k

__all__ = ["IVFPQIndex", "build_index", "adc_tables", "pq_scan_ref",
           "probe_lists", "scan_lists", "select_top_k", "search",
           "overlap_recall", "recall_at_k"]


@dataclass
class IVFPQIndex:
    centroids: torch.Tensor     # (n_lists, D) float32
    codebooks: torch.Tensor     # (S, 256, D // S) residual codebooks
    list_ids: torch.Tensor      # (n_lists, list_len) int32, -1 = pad
    list_codes: torch.Tensor    # (n_lists, list_len, S) uint8
    n_vectors: int

    @property
    def n_lists(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_subq(self) -> int:
        return self.codebooks.shape[0]


def build_index(generator: torch.Generator, vectors: torch.Tensor,
                n_lists: int, n_subq: int = 8,
                kmeans_iters: int = 20) -> IVFPQIndex:
    """Train coarse quantizer + PQ on residuals; pack padded IVF lists."""
    n, _ = vectors.shape
    centroids, assign = km.kmeans(generator, vectors, n_lists,
                                  iters=kmeans_iters)
    residuals = vectors - centroids[assign]
    codebooks = km.train_pq_codebooks(generator, residuals, n_subq)
    codes = km.pq_encode(residuals, codebooks)

    assign_np = assign.cpu().numpy()
    codes_np = codes.cpu().numpy()
    counts = np.bincount(assign_np, minlength=n_lists)
    list_len = int(counts.max())
    list_len = max(8, -(-list_len // 8) * 8)
    ids = np.full((n_lists, list_len), -1, np.int32)
    packed = np.zeros((n_lists, list_len, codes_np.shape[1]), np.uint8)
    fill = np.zeros(n_lists, np.int64)
    for i, a in enumerate(assign_np):
        ids[a, fill[a]] = i
        packed[a, fill[a]] = codes_np[i]
        fill[a] += 1
    dev = vectors.device
    return IVFPQIndex(centroids=centroids, codebooks=codebooks,
                      list_ids=torch.from_numpy(ids).to(dev),
                      list_codes=torch.from_numpy(packed).to(dev),
                      n_vectors=n)


def adc_tables(index: IVFPQIndex, queries: torch.Tensor,
               probe_centroids: torch.Tensor) -> torch.Tensor:
    """queries: (Q, D); probe_centroids: (Q, P, D) -> (Q, P, S, 256)
    partial squared-L2 tables for the residuals."""
    q_res = queries[:, None, :] - probe_centroids
    s, _, dsub = index.codebooks.shape
    qr = q_res.reshape(q_res.shape[0], q_res.shape[1], s, dsub)
    diff = qr[:, :, :, None, :] - index.codebooks[None, None]
    return torch.sum(diff * diff, dim=-1)


def probe_lists(index: IVFPQIndex, queries: torch.Tensor,
                nprobe: int) -> torch.Tensor:
    """Coarse scan: queries (Q, D) -> the nprobe nearest lists (Q, P)."""
    c2 = torch.sum(index.centroids ** 2, dim=-1)
    coarse = c2[None] - 2.0 * queries @ index.centroids.T       # (Q, L)
    _, probe = top_k(-coarse, nprobe)
    return probe


def scan_lists(index: IVFPQIndex, tables: torch.Tensor, probe: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
    """ADC distances of every code of the probed lists: tables (Q, P, S,
    256), probe (Q, P) -> (Q, P, LL).  With ``use_kernel`` one ``pq_scan``
    launch reads the probed lists where they lie in ``index.list_codes``;
    the plain scan gathers them first."""
    if use_kernel:
        q, p, s, _ = tables.shape
        return pq_scan_lists(tables.reshape(q * p, s, 256).contiguous(),
                             index.list_codes,
                             probe.reshape(-1).int()).reshape(q, p, -1)
    return pq_scan_ref(tables, index.list_codes[probe])


def select_top_k(index: IVFPQIndex, probe: torch.Tensor, dists: torch.Tensor,
                 k: int):
    """The k nearest across all probed lists: (distances (Q, k), ids (Q,
    k)); ids past the probed lists' real vectors are -1 with distance
    +inf."""
    ids = index.list_ids[probe]                                # (Q,P,LL)
    dists = torch.where(ids >= 0, dists, torch.inf)
    qn = probe.shape[0]
    neg, pos = top_k(-dists.reshape(qn, -1), k)
    return -neg, torch.gather(ids.reshape(qn, -1), 1, pos)


def search(index: IVFPQIndex, queries: torch.Tensor, nprobe: int = 8,
           k: int = 10, use_kernel: bool = False):
    """Returns (distances (Q, k), ids (Q, k)); ids past the probed lists'
    real vectors are -1 with distance +inf."""
    probe = probe_lists(index, queries, nprobe)                # 1) coarse
    tables = adc_tables(index, queries, index.centroids[probe])  # 2) ADC
    dists = scan_lists(index, tables, probe, use_kernel)       # 3) PQ scan
    return select_top_k(index, probe, dists, k)                # 4) top-k


def overlap_recall(approx_ids, exact_ids) -> float:
    """Fraction of the exact ids the approximate search recovered; negative
    (padding) ids never count as hits."""
    a = np.asarray(torch.as_tensor(approx_ids).cpu())
    e = np.asarray(torch.as_tensor(exact_ids).cpu())
    hits = sum(len({int(i) for i in ar if i >= 0} & {int(i) for i in er})
               for ar, er in zip(a, e))
    return hits / e.size


def recall_at_k(index: IVFPQIndex, vectors: torch.Tensor,
                queries: torch.Tensor, k: int = 10, nprobe: int = 8) -> float:
    """Recall@k against exact L2 ground truth."""
    _, approx = search(index, queries, nprobe=nprobe, k=k)
    _, exact_ids = knn(queries, vectors, k=k)
    return overlap_recall(approx, exact_ids)
