"""Plain PyTorch version of the dense decode attention (mirror of
``repro.kernels.decode_attention.ref``, on grouped queries).

:func:`decode_attention_ref` is the semantic oracle and the CUDA kernel's
plain version: one decode query per query head, grouped as (B, H_kv, G,
D), over the unexpanded dense caches (B, S, H_kv, D), float32 masked
softmax.  ``cache_len`` clamps to S.  A length of 0 gives exact zeros, as
the kernel writes them; JAX's kernel and its oracle disagree there (the
kernel averages V over the padded S, the oracle over S), so that row is
not held to either.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H_kv, G, D); caches: (B, S, H_kv, D); cache_len: (B,) ->
    (B, H_kv, G, D) in q's dtype."""
    d = q.shape[-1]
    qf = q.float() / math.sqrt(d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    cache_len = cache_len.to(q.device)
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] < \
        cache_len.reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    out = torch.where(cache_len.reshape(-1, 1, 1, 1) > 0, out, 0.0)
    return out.to(q.dtype)
