"""Multi-head latent attention (MLA: DeepSeek-V2/V3, Moonlight).

A layer keeps one latent row a token instead of K and V: ``x @ wkv_a``
gives the compressed ``c`` (``kv_lora_rank`` wide, RMS-normed by
``ln_kv``) and ``k_pe`` (``qk_rope_head_dim`` wide, one head shared by
all, rotated by position); the row is ``[c, k_pe]``.  The queries come
from one plain projection ``x @ wq`` (no query LoRA), each head
``[q_nope, q_pe]`` with ``q_pe`` rotated.  ``wkv_b`` (latent, H x
(qk_nope + v)) decompresses the latent into each head's ``k_nope`` and
``v``: its first ``qk_nope_head_dim`` columns a head are ``W_UK``, the
rest ``W_UV``.  The softmax scale is 1/sqrt(qk_nope + qk_rope) either way.

Two forms of the same attention:

* decompressed (``attend_full_seq``; the published modeling code's): keys
  ``[c W_UK, k_pe]`` and values ``c W_UV`` a head, attended as plain
  causal attention; ``forward`` and ``prefill`` take it;
* absorbed (``absorb`` + ``latent_attention``): ``q_nope W_UK^T`` is a
  query against ``c`` itself, so with ``q_pe`` it attends over the latent
  rows as one shared head ``kv_lora_rank + qk_rope_head_dim`` wide whose
  values are ``c``; ``W_UV`` applies after.  The paged decode step and
  the paged chunk extends take it, reading the latent pool through the
  block tables and never decompressing it.

RoPE rotates interleaved pairs (``common.apply_rope``); the published
code de-interleaves both ``q_pe`` and ``k_pe`` the same way before a
half-split rotation, which gives the same dot products.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import common as cm

#: query rows one block of the decompressed causal attention holds
QUERY_BLOCK = 1024


def project(xn, lp, cfg, positions, compute_dtype):
    """A layer's queries and latent rows from its normed input
    ``xn`` (B, S, d): q (B, S, H, qk_nope + qk_rope), ``q_pe`` rotated;
    the latent (B, S, 1, kv_lora_rank + qk_rope), ``c`` normed and
    ``k_pe`` rotated, in the compute dtype."""
    B, S, _ = xn.shape
    mla = cfg.mla
    xc = xn.to(compute_dtype)
    q = (xc @ cm.maybe_dequant(lp["wq"], compute_dtype)).reshape(
        B, S, cfg.n_heads, mla.qk_head_dim)
    q_nope, q_pe = q.split([mla.qk_nope_head_dim, mla.qk_rope_head_dim], -1)
    q = torch.cat([q_nope, cm.apply_rope(q_pe, positions, cfg.rope_theta)],
                  -1)
    ckv = xc @ cm.maybe_dequant(lp["wkv_a"], compute_dtype)     # (B, S, L+R)
    c, k_pe = ckv.split([mla.kv_lora_rank, mla.qk_rope_head_dim], -1)
    c = cm.rms_norm(c, lp["ln_kv"], cfg.norm_eps)
    k_pe = cm.apply_rope(k_pe[:, :, None], positions, cfg.rope_theta)
    return q, torch.cat([c[:, :, None], k_pe], -1)


def split_wkv_b(wkv_b, cfg):
    """``wkv_b`` (kv_lora_rank, H * (qk_nope + v)) as (W_UK (kv_lora_rank,
    H, qk_nope), W_UV (kv_lora_rank, H, v))."""
    mla = cfg.mla
    w = wkv_b.reshape(mla.kv_lora_rank, cfg.n_heads,
                      mla.qk_nope_head_dim + mla.v_head_dim)
    return w.split([mla.qk_nope_head_dim, mla.v_head_dim], -1)


def decompress(latent, wkv_b, cfg):
    """Latent rows (B, S, 1, L+R) -> keys (B, S, H, qk_nope + qk_rope) and
    values (B, S, H, v) a head (the published form)."""
    mla = cfg.mla
    B, S = latent.shape[:2]
    c, k_pe = latent[:, :, 0].split([mla.kv_lora_rank,
                                     mla.qk_rope_head_dim], -1)
    kv = (c @ wkv_b).reshape(B, S, cfg.n_heads,
                             mla.qk_nope_head_dim + mla.v_head_dim)
    k_nope, v = kv.split([mla.qk_nope_head_dim, mla.v_head_dim], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(
        B, S, cfg.n_heads, mla.qk_rope_head_dim)], -1)
    return k, v


def causal_attention(q, k, v, scale: float):
    """Causal attention with keys and values of different widths: q, k
    (B, S, H, Dk), v (B, S, H, Dv) -> (B, S, H, Dv).  Scores and softmax
    in float32, probabilities cast to q's dtype, in blocks of
    ``QUERY_BLOCK`` query rows (each reads the keys up to its last)."""
    B, S, H, _ = q.shape
    out = q.new_empty(B, S, H, v.shape[-1])
    for r0 in range(0, S, QUERY_BLOCK):
        r1 = min(S, r0 + QUERY_BLOCK)
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1],
                              k[:, :r1]).float() * scale
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        keys = torch.arange(r1, device=q.device)[None, :]
        scores = torch.where(keys <= rows, scores, -math.inf)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs, v[:, :r1])
    return out


def attend_full_seq(q, latent, wkv_b, cfg):
    """``forward``'s MLA ``attend``: the sequence's own latent rows,
    decompressed, under a causal mask -> (B, S, H, v)."""
    if not cfg.causal:
        raise NotImplementedError("latent attention is causal only")
    k, v = decompress(latent, wkv_b, cfg)
    return causal_attention(q, k, v, cfg.mla.scale)


def absorb(q, wkv_b, cfg):
    """Queries (B, S, H, qk_nope + qk_rope) -> absorbed queries (B, S, H,
    kv_lora_rank + qk_rope): ``q_nope W_UK^T`` beside ``q_pe``."""
    mla = cfg.mla
    w_uk, _ = split_wkv_b(wkv_b, cfg)
    q_nope, q_pe = q.split([mla.qk_nope_head_dim, mla.qk_rope_head_dim], -1)
    return torch.cat([torch.einsum("bshj,chj->bshc", q_nope, w_uk), q_pe],
                     -1)


def unabsorb(o_lat, wkv_b, cfg):
    """Latent outputs (B, S, H, kv_lora_rank) -> each head's values
    (B, S, H, v) through ``W_UV``."""
    _, w_uv = split_wkv_b(wkv_b, cfg)
    return torch.einsum("bshc,chv->bshv", o_lat, w_uv)


def latent_attention(q, kv, mask, scale: float, d_latent: int):
    """Absorbed queries q (B, T, H, L+R) over latent rows kv (B, S, L+R),
    one head shared by every query head; ``mask`` (B, 1 or T, S) True
    where a query sees a position.  Values are the rows' first
    ``d_latent`` columns -> (B, T, H, d_latent).  Scores and softmax in
    float32, probabilities in q's dtype."""
    scores = torch.einsum("bthc,bsc->bhts", q, kv.to(q.dtype)).float() * scale
    scores = torch.where(mask[:, None], scores, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bsc->bthc", probs,
                        kv[..., :d_latent].to(q.dtype))


def chunk_latent_attention(q, kv_pages, block_rows, starts, scale: float,
                           d_latent: int):
    """The paged chunk extends' latent attention, plain PyTorch: row b's
    absorbed queries q[b] (T, H, L+R), at positions ``starts[b] + i``,
    over its latent rows read through its block row, each query seeing the
    positions up to its own -> (B, T, H, d_latent)."""
    B, M = block_rows.shape
    T = q.shape[1]
    page = kv_pages.shape[1]
    kv = kv_pages[block_rows.long()].reshape(B, M * page, -1)
    pos = starts.to(q.device).long()[:, None] + torch.arange(
        T, device=q.device)[None]                                   # (B, T)
    mask = (torch.arange(M * page, device=q.device)[None, None]
            <= pos[..., None])
    return latent_attention(q, kv, mask, scale, d_latent)


def paged_latent_attention(q, kv_pages, block_tables, cache_len,
                           scale: float, d_latent: int):
    """The paged decode step's latent attention, plain PyTorch: absorbed
    queries q (B, 1, H, L+R) over each row's latent rows through its
    block table, positions below ``cache_len`` (B,) -> (B, 1, H,
    d_latent): the chunk attention at T = 1, each row's query at position
    ``cache_len - 1``.  The whole table is gathered (fixed shapes, no
    host read: a CUDA graph replays it)."""
    return chunk_latent_attention(q, kv_pages, block_tables, cache_len - 1,
                                  scale, d_latent)
