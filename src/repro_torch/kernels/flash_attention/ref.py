"""Plain PyTorch version of flash attention (mirror of
``repro.kernels.flash_attention.ref.attention_ref``, with the Pallas
kernel's ``kv_len`` key mask and grouped-query heads).

:func:`flash_attention_ref` is the semantic oracle and the CUDA kernel's
plain version: the (S, S) scores are materialised and the softmax runs in
float32.  Query head ``h`` reads KV head ``h // (H / H_kv)``; K and V are
never repeated.  Key ``j`` is visible to query ``i`` when ``j < kv_len``
and, if ``causal``, ``j <= i``.  A row with no visible key (only
``kv_len == 0``) is not held to anything: this version averages V over
every key there, the kernel writes zeros.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        kv_len: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, H_kv, D) -> (B, S, H, D) in q's
    dtype."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    qg = q.float().reshape(b, s, h_kv, h // h_kv, d) / math.sqrt(d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    kpos = torch.arange(s, device=q.device)
    mask = (kpos < (s if kv_len is None else kv_len))[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= kpos[:, None])
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
