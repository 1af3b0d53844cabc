"""Plain PyTorch version of the dense decode attention (mirror of
``repro.kernels.decode_attention.ref``, on grouped queries).

:func:`decode_attention_ref` is the semantic oracle and the CUDA kernel's
plain version: one decode query per query head, grouped as (B, H_kv, G,
D), over the unexpanded dense caches (B, S, H_kv, D), float32 masked
softmax.  ``cache_len`` clamps to S.  A length of 0 gives exact zeros, as
the kernel writes them; JAX's kernel and its oracle disagree there (the
kernel averages V over the padded S, the oracle over S), so that row is
not held to either.

:func:`local_decode_attn_ref` is the plain version of the kernel's partial
entry: ``repro.distributed.decode_attn._local_decode_attn`` step for step,
one rank's un-normalised partial over the positions [offset, offset +
S_loc) that its shard of the cache holds.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import repeat_kv

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


def local_decode_attn_ref(q: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, cache_len: torch.Tensor,
                          shard_offset: int, q_per_kv: int):
    """Partial attention over a local KV chunk.

    q: (B, 1, H, D); kc/vc: (B, S_loc, H_kv, D) holding positions
    [shard_offset, shard_offset + S_loc).  Returns (partial_out (B, H, D)
    f32, m (B, H) f32 in natural-log units, l (B, H) f32); a row with no
    visible position has m = -inf, l = 0 and out = 0."""
    b, s_loc, _, d = kc.shape
    kr = repeat_kv(kc, q_per_kv)
    vr = repeat_kv(vc, q_per_kv)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
    pos = shard_offset + torch.arange(s_loc, device=q.device)
    valid = pos[None, :] < cache_len.to(q.device).reshape(-1, 1)
    scores = torch.where(valid[:, None, None, :], scores, -math.inf)
    m = torch.amax(scores, dim=-1)[:, :, 0]                     # (B, H)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores[:, :, 0, :] - m_safe[..., None])
    p = torch.where(valid[:, None, :], p, 0.0)
    l = torch.sum(p, dim=-1)                                    # (B, H)
    out = torch.einsum("bhk,bkhd->bhd", p.to(vr.dtype), vr)
    return out.float(), m, l
