"""Engine-facing wrapper of the dense decode attention kernel.

Same contract as ``repro.kernels.decode_attention.ops``: q for one decode
token, one layer's dense caches (B, S, H_kv, D) and the per-sequence
lengths.  Query heads are grouped (H_kv, q_per_kv) so each cache row
serves all of a KV head's query heads.  Unlike the JAX wrapper, S is not
padded to a tile multiple: the kernel masks the ragged end itself.

A CUDA tensor launches ``csrc/decode_attention.cu`` (or the wrapper
raises on a dtype, shape or layout the kernel does not take); a CPU
tensor goes to the plain version, ``ref.decode_attention_ref``.
``decode_attention.launches`` counts kernel launches.

The kernel splits the sequence over ``n_split`` blocks per (b, kv head)
and merges their partials in a second pass.  :func:`split_plan` picks the
split from B, H_kv and S alone: the lengths live on the device, and
reading them would stall the host in every layer of every step.

:func:`decode_attention_partial` is the kernel's partial entry, one rank's
shard of a split-K decode (``repro_torch.distributed.decode_attn``): the
un-normalised f32 (acc, m, l) over the positions [offset, offset + S)
that the shard's caches hold, the visible length found on the device.  A
CPU tensor goes to its plain version, ``ref.local_decode_attn_ref``.
``decode_attention_partial.launches`` counts its launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      local_decode_attn_ref)

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
_PARTIAL = {torch.float32: "decode_attention_partial_f32",
            torch.bfloat16: "decode_attention_partial_bf16"}
HEAD_DIMS = (16, 32, 64, 128)      # head widths the kernel is built for
TILE_BYTES = 8192                  # K rows (and V rows) a tile copies
TARGET_BLOCKS = 264                # two blocks for each of the H100's 132 SMs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_positions(d: int, itemsize: int) -> int:
    """Positions in one of the kernel's tiles: 8 KB of K rows."""
    return TILE_BYTES // (d * itemsize)


def split_plan(b: int, h_kv: int, s: int, tile: int) -> tuple[int, int]:
    """(n_split, chunk): split i covers positions [i*chunk, (i+1)*chunk).

    Enough splits for about TARGET_BLOCKS blocks, each a whole number of
    tiles (at least one), and no split starting at or past S, so the
    splits cover [0, S) exactly once."""
    n = max(1, min(_cdiv(TARGET_BLOCKS, max(1, b * h_kv)), _cdiv(s, tile)))
    chunk = max(1, _cdiv(_cdiv(s, n), tile)) * tile
    return max(1, _cdiv(s, chunk)), chunk


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor) -> None:
    """Refuse what the kernel does not take."""
    b, h_kv, g, d = q.shape
    tensors = (q, k_cache, v_cache, cache_len)
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must be on one CUDA "
                         "device")
    if q.dtype not in _ENTRY or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError("decode_attention takes int32 cache lengths")
    if (k_cache.shape != v_cache.shape or k_cache.dim() != 4
            or k_cache.shape[0] != b or k_cache.shape[2:] != (h_kv, d)
            or cache_len.shape != (b,)):
        raise ValueError(f"decode_attention: shapes do not match: q "
                         f"{tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"cache_len {tuple(cache_len.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention needs contiguous inputs")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention reads K/V rows in 16-byte loads: "
                         "the caches must be 16-byte aligned")


def _plan(q: torch.Tensor, s: int):
    """(n_split, chunk, scratch): each split's (acc[G, D], m, l) in f32,
    merged by the second pass."""
    b, h_kv, g, d = q.shape
    n_split, chunk = split_plan(b, h_kv, s,
                                tile_positions(d, q.element_size()))
    scratch = (torch.empty(b * h_kv * n_split * g * (d + 2),
                           dtype=torch.float32, device=q.device)
               if n_split > 1 else None)
    return n_split, chunk, scratch


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (its split pass, then its merge pass when the
    sequence is split).  q: (B, H_kv, G, D); caches: (B, S, H_kv, D);
    cache_len: (B,) int32 -> (B, H_kv, G, D)."""
    _check(q, k_cache, v_cache, cache_len)
    b, h_kv, g, d = q.shape
    s = k_cache.shape[1]
    out = torch.empty_like(q)
    n_split, chunk, scratch = _plan(q, s)
    fn = _build.function(_ENTRY[q.dtype], 6, 7)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             cache_len.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), b, s, h_kv, g,
             d, n_split, chunk,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_ENTRY[q.dtype], err)
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D) or (B, H, D); caches: (B, S, H_kv, D); cache_len:
    (B,) -> same shape as q."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    b, h, d = q.shape
    h_kv = k_cache.shape[2]
    qg = q.reshape(b, h_kv, h // h_kv, d).contiguous()
    if q.is_cuda:
        out = decode_attention_cuda(qg, k_cache, v_cache, cache_len)
    else:
        out = decode_attention_ref(qg, k_cache, v_cache, cache_len)
    out = out.reshape(b, h, d)
    return out[:, None] if squeeze else out


decode_attention.launches = 0


def decode_attention_partial_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  cache_len: torch.Tensor, offset: int):
    """Launch the partial entry.  q: (B, H_kv, G, D); caches (B, S, H_kv,
    D) holding positions [offset, offset + S); cache_len: (B,) int32 ->
    (acc (B, H_kv, G, D), m (B, H_kv, G), l (B, H_kv, G)), all f32."""
    _check(q, k_cache, v_cache, cache_len)
    b, h_kv, g, d = q.shape
    s = k_cache.shape[1]
    if not 0 <= offset < 2 ** 31 - s:
        raise ValueError(f"decode_attention_partial: offset {offset} out of "
                         f"range")
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    n_split, chunk, scratch = _plan(q, s)
    fn = _build.function(_PARTIAL[q.dtype], 8, 8)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             cache_len.data_ptr(), acc.data_ptr(), m.data_ptr(),
             l.data_ptr(), None if scratch is None else scratch.data_ptr(),
             b, s, h_kv, g, d, n_split, chunk, int(offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_PARTIAL[q.dtype], err)
    decode_attention_partial.launches += 1
    return acc, m, l


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: torch.Tensor,
                             offset: int):
    """One rank's split-K partial.  q: (B, 1, H, D); caches: (B, S_loc,
    H_kv, D) holding positions [offset, offset + S_loc); cache_len: (B,)
    -> (out (B, H, D), m (B, H), l (B, H)), f32: ``_local_decode_attn``."""
    b, _, h, d = q.shape
    h_kv = k_cache.shape[2]
    if not q.is_cuda:
        return local_decode_attn_ref(q, k_cache, v_cache, cache_len, offset,
                                     h // h_kv)
    qg = q.reshape(b, h_kv, h // h_kv, d).contiguous()
    acc, m, l = decode_attention_partial_cuda(qg, k_cache, v_cache,
                                              cache_len, offset)
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


decode_attention_partial.launches = 0
