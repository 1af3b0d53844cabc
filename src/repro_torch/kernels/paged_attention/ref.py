"""Plain PyTorch versions of the ragged paged-decode attention
(mirrors of ``repro.kernels.paged_attention.ref``).

* :func:`paged_decode_attention_dense_ref` -- the semantic oracle and the
  CUDA kernel's plain version: gather the logical (B, M*page, H_kv, D)
  view, float32 masked softmax, exact zeros at length 0.
* :func:`engine_ref_attn` -- what ``attn_impl="ref"`` computes: gather,
  repeat KV heads, masked softmax in the compute dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import common as cm

NEG_INF = -1e30


def paged_gather(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, H_kv, D) + (B, M) -> logical view (B, M*page, H_kv, D)."""
    _, page, h_kv, d = pages.shape
    b, m = block_tables.shape
    return pages[block_tables.long()].reshape(b, m * page, h_kv, d)


def paged_decode_attention_dense_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H_kv, G, D) -> same shape and dtype."""
    b, h_kv, g, d = q.shape
    kg = paged_gather(k_pages, block_tables).float()
    vg = paged_gather(v_pages, block_tables).float()
    qf = q.float() / math.sqrt(d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kg)
    lengths = lengths.to(q.device)
    valid = torch.arange(kg.shape[1], device=q.device)[None, :] < \
        lengths.reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vg)
    out = torch.where(lengths.reshape(-1, 1, 1, 1) > 0, out, 0.0)
    return out.to(q.dtype)


def engine_ref_attn(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    cache_len: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """The engine's gather + repeat + masked-softmax decode attention.
    q: (B, 1, H, D) -> (B, 1, H, D)."""
    kg = paged_gather(k_pages, block_tables)
    vg = paged_gather(v_pages, block_tables)
    return cm.decode_attention_ref(q, cm.repeat_kv(kg, q_per_kv),
                                   cm.repeat_kv(vg, q_per_kv), cache_len)
