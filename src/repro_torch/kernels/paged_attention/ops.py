"""Engine-facing wrapper of the ragged paged-decode attention kernel.

Same contract as ``repro.kernels.paged_attention.ops``: q for one decode
token, the post-scatter page pool of one layer, the dense block tables
and the per-sequence lengths.  Query heads are grouped (H_kv, q_per_kv)
so each KV page serves all of a KV head's query heads.

A CUDA tensor launches ``csrc/paged_decode_attention.cu`` (or the wrapper
raises on a dtype, shape or layout the kernel does not take); a CPU
tensor goes to the plain version, ``ref.paged_decode_attention_dense_ref``.
``paged_decode_attention.launches`` counts wrapper calls that launch.

The kernel splits each sequence's M*page positions over ``n_split``
blocks per (b, kv head) and merges their partials in a second pass (the
dense kernel's).  :func:`split_plan` picks the split from the shapes
alone: the lengths live on the device, and reading them would stall the
host in every layer of every step.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import tile_positions
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_dense_ref)

_ENTRY = {torch.float32: "paged_decode_attention_f32",
          torch.bfloat16: "paged_decode_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128)      # head widths the kernel is built for
CHUNK_TILES = 4                    # tiles a split covers
MAX_PAGES = 1024                   # table entries a split stages (kMaxPages)


def split_plan(n_pos: int, tile: int) -> tuple[int, int]:
    """(n_split, chunk) over the M*page = ``n_pos`` positions of a block
    table row: split i covers positions [i*chunk, (i+1)*chunk).

    The chunk is CHUNK_TILES tiles whatever B is, so a long sequence
    beside many short ones still spreads over blocks (the dense kernel's
    plan, which aims at a number of blocks, gives one split at B*H_kv =
    1,024 and was slower there); blocks whose split starts past the length
    return at once.  No split starts at or past ``n_pos``, so the splits
    cover [0, n_pos) exactly once.  A chunk of at most 1,024 positions
    touches at most MAX_PAGES pages whatever the page size."""
    chunk = CHUNK_TILES * tile
    return max(1, -(-n_pos // chunk)), chunk


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (its split pass, then its merge pass when the
    sequence is split).  q: (B, H_kv, G, D); pages: (P, page, H_kv, D);
    block_tables: (B, M) int32; lengths: (B,) int32 -> (B, H_kv, G, D)."""
    b, h_kv, g, d = q.shape
    _, page, _, _ = k_pages.shape
    m = block_tables.shape[1]
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on one "
                         "CUDA device")
    if q.dtype not in _ENTRY or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention takes int32 block tables "
                        "and lengths")
    if (k_pages.shape != v_pages.shape or k_pages.shape[2:] != (h_kv, d)
            or block_tables.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(f"paged_decode_attention: shapes do not match: q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {d} is not one "
                         f"of {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention needs contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention reads K/V rows in 16-byte "
                         "loads: the page pools must be 16-byte aligned")
    out = torch.empty_like(q)
    n_split, chunk = split_plan(m * page, tile_positions(d, q.element_size()))
    # each split's (acc[G, D], m, l) in f32, merged by the second pass
    scratch = (torch.empty(b * h_kv * n_split * g * (d + 2),
                           dtype=torch.float32, device=q.device)
               if n_split > 1 else None)
    fn = _build.function(_ENTRY[q.dtype], 7, 8)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), b, h_kv, g, d,
             page, m, n_split, chunk,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_ENTRY[q.dtype], err)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D) or (B, H, D); pages: (P, page, H_kv, D);
    block_tables: (B, M); lengths: (B,) -> same shape as q."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    b, h, d = q.shape
    h_kv = k_pages.shape[2]
    qg = q.reshape(b, h_kv, h // h_kv, d).contiguous()
    if q.is_cuda:
        out = paged_decode_attention_cuda(qg, k_pages, v_pages, block_tables,
                                          lengths)
    else:
        out = paged_decode_attention_dense_ref(qg, k_pages, v_pages,
                                               block_tables, lengths)
    out = out.reshape(b, h, d)
    return out[:, None] if squeeze else out


paged_decode_attention.launches = 0
