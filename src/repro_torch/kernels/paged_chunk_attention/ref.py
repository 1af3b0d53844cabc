"""Plain PyTorch version of the paged chunk-extend attention: the CUDA
kernel's function, computed as the paged chunk extend's plain path does
(``common.chunk_attention`` over the rows' gathered pages).  The plain
path of ``tr.paged_chunk_extend_batch`` is this function, called on a
group of rows at a time.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import paged_gather
from repro_torch.models import common as cm


def tables_upto(block_rows: torch.Tensor, end: int,
                page: int) -> torch.Tensor:
    """The block rows' columns up to the page of position ``end - 1``: no
    query at a position below ``end`` sees a key past it, so the masked
    tail beyond carries no weight."""
    return block_rows[:, :min(block_rows.shape[1], -(-end // page))]


def paged_chunk_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_rows: torch.Tensor,
                              starts: torch.Tensor) -> torch.Tensor:
    """q: (B, T, H, D); pages: (P, page, H_kv, D); block_rows: (B, M);
    starts: (B,) on q's device -> (B, T, H, D) in q's dtype.

    Query i of row b, at position ``starts[b] + i``, attends keys 0 ..
    min(position, M*page - 1) of row b's gathered pages, with K/V cast to
    q's dtype, scores in q's dtype, an f32 masked softmax and the
    probabilities rounded back to q's dtype.  Every column of
    ``block_rows`` is read: cut them with :func:`tables_upto` first."""
    t = q.shape[1]
    span = block_rows.shape[1] * k_pages.shape[1]
    positions = starts.long()[:, None] + torch.arange(
        t, device=q.device)                                       # (B, T)
    mask = (torch.arange(span, device=q.device)[None, None, None, :]
            <= positions[:, None, :, None])                  # (B, 1, T, S)
    return cm.chunk_attention(q, paged_gather(k_pages, block_rows),
                              paged_gather(v_pages, block_rows), mask,
                              q.dtype)
