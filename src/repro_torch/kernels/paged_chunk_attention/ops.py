"""Model-facing wrapper of the paged chunk-extend attention kernel.

A chunk of T tokens a row attends over its sequence's cache through the
row's block table, as ``tr.paged_chunk_extend_batch`` needs once it has
written the chunk's own K/V: q (B, T, H, D), the layer's page pools
(P, page, H_kv, D), the block-table rows (B, M) and each row's start
position (B,) on the device.  Query i of row b attends keys 0 ..
min(starts[b] + i, M*page - 1) -- pad tokens included, as the plain path
lets them.  Query heads are grouped (H_kv, G) so each staged K/V tile
serves every query head of its KV head: no page gather, no repeated KV
heads, no score tensor.

A CUDA tensor launches ``csrc/paged_chunk_attention.cu`` (bf16 only; the
wrapper raises on a dtype, shape, layout or alignment the kernel does not
take); a CPU tensor goes to the plain version,
``ref.paged_chunk_attention_ref``.  ``paged_chunk_attention.launches``
counts kernel launches.  The kernel is forward only, like the flash
kernel's wrapper: it raises when grad mode is on and an input requires
grad.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_chunk_attention.ref import (
    paged_chunk_attention_ref, tables_upto)

_ENTRY = "paged_chunk_attention_bf16"
MAX_HEAD_DIM = 128        # head widths: multiples of 8 up to this
MAX_GROUP = 128           # query heads a KV head: a tile's packed rows
MAX_GRID_Y = 65535        # B * H_kv blocks on the grid's y axis


def paged_chunk_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_rows: torch.Tensor,
                               starts: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  q: (B, T, H, D) bf16; pages: (P, page, H_kv,
    D) bf16; block_rows: (B, M) int32; starts: (B,) int32 ->
    (B, T, H, D)."""
    tensors = (q, k_pages, v_pages, block_rows, starts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "paged_chunk_attention has no backward: call it under "
            "torch.no_grad() or attend through the plain path "
            "(attn_impl=None)")
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("paged_chunk_attention: all inputs must be on one "
                         "CUDA device")
    if q.dtype != torch.bfloat16 or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_chunk_attention takes bfloat16 q/k/v, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_rows.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("paged_chunk_attention takes int32 block rows and "
                        "start positions")
    if q.dim() != 4 or k_pages.dim() != 4 or block_rows.dim() != 2:
        raise ValueError(f"paged_chunk_attention: q (B, T, H, D), pages "
                         f"(P, page, H_kv, D), block rows (B, M); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(block_rows.shape)}")
    b, t, h, d = q.shape
    _, page, h_kv, _ = k_pages.shape
    m = block_rows.shape[1]
    if (k_pages.shape != v_pages.shape or k_pages.shape[3] != d
            or h_kv == 0 or h % h_kv or block_rows.shape[0] != b
            or starts.shape != (b,) or page == 0 or m == 0):
        raise ValueError(f"paged_chunk_attention: shapes do not match: q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"block rows {tuple(block_rows.shape)}, starts "
                         f"{tuple(starts.shape)}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"paged_chunk_attention: head dim {d} is not a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if h // h_kv > MAX_GROUP:
        raise ValueError(f"paged_chunk_attention: {h // h_kv} query heads "
                         f"a KV head exceed a tile's {MAX_GROUP} rows")
    if b * h_kv > MAX_GRID_Y:
        raise ValueError(f"paged_chunk_attention: B * H_kv = {b * h_kv} "
                         f"blocks exceed the grid's {MAX_GRID_Y}")
    if not all(t_.is_contiguous() for t_ in tensors):
        raise ValueError("paged_chunk_attention needs contiguous inputs")
    out = torch.empty_like(q)
    for name, t_ in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                     ("out", out)):
        if t_.data_ptr() % 16:
            raise ValueError(f"paged_chunk_attention moves rows in 16-byte "
                             f"copies: {name} must be 16-byte aligned")
    fn = _build.function(_ENTRY, 6, 7)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_rows.data_ptr(), starts.data_ptr(), out.data_ptr(), b, t,
             h_kv, h // h_kv, d, page, m,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_ENTRY, err)
    paged_chunk_attention.launches += 1
    return out


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_rows: torch.Tensor,
                          starts: torch.Tensor) -> torch.Tensor:
    """q: (B, T, H, D); pages: (P, page, H_kv, D); block_rows: (B, M);
    starts: (B,) -> (B, T, H, D) in q's dtype: the kernel on a CUDA
    tensor, the plain version on a CPU one (its tables read up to the
    page of the last position, as the extend's plain path reads them)."""
    if q.is_cuda:
        return paged_chunk_attention_cuda(q.contiguous(), k_pages, v_pages,
                                          block_rows, starts)
    end = int(starts.max()) + q.shape[1]
    return paged_chunk_attention_ref(
        q, k_pages, v_pages, tables_upto(block_rows, end, k_pages.shape[1]),
        starts)


paged_chunk_attention.launches = 0
