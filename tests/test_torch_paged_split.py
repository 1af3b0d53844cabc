"""The paged decode-attention kernel's split of the sequence, on the CPU.

* ``ops.split_plan`` (chosen on the host from M*page and the tile alone;
  no B, no lengths) covers every position of [0, M*page)
  exactly once with whole tiles, and keeps the pages one split touches
  within the table slice the kernel stages (``MAX_PAGES``).
* A plain-PyTorch emulation of the kernel's two passes through the block
  table -- each split stages its slice of the table row, finds tile row
  ``pos`` on page ``slice[pos // page - start // page]`` at offset
  ``pos % page``, keeps (m, l, acc) in f32 log2 units; the merge rescales
  and sums the splits that start inside the length, and a sequence that
  fits in one split is written by split 0 -- equals
  ``paged_decode_attention_dense_ref`` and the JAX oracle
  (``repro.kernels.paged_attention.ref.paged_decode_attention_dense_ref``)
  on the same numpy inputs, float32 at ``1e-6`` (they differ only in the
  order of f32 sums and exp2 against exp).  The emulation reads a table
  whose entries past ceil(length/page) are poisoned, so it shows the
  kernel's addressing never reads them.

The kernel itself is held to the plain version on a GPU by the ``cuda``
tests of ``tests/test_torch_kernels.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import (
    paged_decode_attention_dense_ref as jax_dense_ref)
from repro_torch.kernels.decode_attention.ops import tile_positions
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_dense_ref)

torch.set_num_threads(1)

HEAD_DIMS = (16, 32, 64, 128)
#: the kernel's tile at every (head width, element size) it is built for
TILES = sorted({tile_positions(d, size) for d in HEAD_DIMS for size in (2, 4)})
POISON = -(1 << 30)         # a table entry no kernel may read


@pytest.mark.parametrize("page", [1, 7, 16, 32])
@pytest.mark.parametrize("m", [1, 2, 48, 64, 3000])
def test_paged_split_plan_covers_every_position_once(m, page):
    n_pos = m * page
    for tile in TILES:
        n, chunk = pa.split_plan(n_pos, tile)
        assert n >= 1 and chunk >= tile and chunk % tile == 0
        starts = [i * chunk for i in range(n)]
        assert all(st < n_pos for st in starts)
        cover = np.zeros(n_pos, np.int64)
        for st in starts:
            cover[st:st + chunk] += 1
        assert (cover == 1).all(), (m, page, tile)
        # the pages of any split fit in the kernel's table slice
        assert (chunk + page - 2) // page + 1 <= pa.MAX_PAGES
        assert chunk == pa.CHUNK_TILES * tile


def test_paged_split_plan_at_the_main_path_shapes():
    """serve (M*page = 1,024) and serve_plan (768) at bf16, D=64: chunks of
    four 64-position tiles."""
    tile = tile_positions(64, 2)
    assert pa.split_plan(64 * 16, tile) == (4, 256)
    assert pa.split_plan(48 * 16, tile) == (3, 256)


def _problem(b, h_kv, g, d, page, m, lengths, seed=0, share=None):
    """float32 numpy instance; the pool has one spare page, and rows
    ``share`` = (i, j) get the same pages and query."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h_kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b * m + 1, page, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b * m + 1, page, h_kv, d)).astype(np.float32)
    tables = rng.permutation(b * m).reshape(b, m).astype(np.int32)
    if share is not None:
        i, j = share
        tables[j] = tables[i]
        q[j] = q[i]
    return q, k, v, tables, np.asarray(lengths, np.int32)


def _poisoned(tables, lengths, page):
    """The table with every entry past ceil(min(len, M*page)/page) set to
    an id no page has."""
    out = tables.copy()
    m = tables.shape[1]
    for bi, length in enumerate(lengths):
        out[bi, -(-min(int(length), m * page) // page):] = POISON
    return out


def _split_merge(q, k_pages, v_pages, tables, lengths, n_split, chunk):
    """The kernel's split pass and merge pass in plain PyTorch, float32."""
    b, h_kv, g, d = q.shape
    page = k_pages.shape[1]
    m = tables.shape[1]
    qs = q * (math.log2(math.e) / math.sqrt(d))
    out = torch.zeros_like(q)
    for bi in range(b):
        length = max(0, min(int(lengths[bi]), m * page))
        parts = []
        for i in range(n_split):
            start, end = i * chunk, min((i + 1) * chunk, length)
            if start >= end:
                continue
            p0 = start // page
            table_s = tables[bi, p0:(end - 1) // page + 1]   # staged once
            pos = torch.arange(start, end)
            phys = table_s[(pos // page - p0).long()].long()
            assert (phys >= 0).all(), "read a table entry past the length"
            kr = k_pages[phys, pos % page]                   # (n, H_kv, D)
            vr = v_pages[phys, pos % page]
            sc = torch.einsum("hgd,khd->hgk", qs[bi], kr)
            mx = sc.amax(-1)
            p = torch.exp2(sc - mx[..., None])
            parts.append((mx, p.sum(-1), torch.einsum("hgk,khd->hgd", p, vr)))
        if not parts:
            continue                                         # exact zeros
        if length <= chunk:                                  # split 0 alone
            mx, ll, acc = parts[0]
            out[bi] = acc / ll[..., None]
            continue
        mm = torch.stack([mx for mx, _, _ in parts]).amax(0)
        w = [torch.exp2(mx - mm) for mx, _, _ in parts]
        ll = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        acc = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[bi] = acc / ll[..., None]
    return out


def _check(arrs, plans):
    q, k, v, tables, lengths = arrs
    page, m = k.shape[1], tables.shape[1]
    tq, tk, tv, tt, tl = map(torch.tensor, arrs)
    want = paged_decode_attention_dense_ref(tq, tk, tv, tt, tl)
    oracle = np.asarray(jax_dense_ref(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(want.numpy(), oracle, rtol=0, atol=1e-6)
    poisoned = torch.tensor(_poisoned(tables, lengths, page))
    for n_split, chunk in plans:
        assert n_split * chunk >= m * page
        got = _split_merge(tq, tk, tv, poisoned, tl, n_split, chunk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=str((n_split, chunk)))
        assert not got[tl == 0].any()
    return want


@pytest.mark.parametrize("page", [1, 7, 16])
def test_split_merge_equals_the_whole_sequence_at_split_edges(page):
    """Lengths 0, 1, chunk, chunk +- 1, page +- 1 and M*page + 1 (clamps),
    two rows sharing pages, under the wrapper's plan for D=16 f32 (a
    128-position tile, a 512-position chunk) and under small chunks that
    do not divide the page size, nor it them."""
    d = 16
    tile = tile_positions(d, 4)
    chunk = pa.CHUNK_TILES * tile
    m = -(-(2 * chunk + 40) // page)
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, page - 1, page + 1,
               m * page + 1, 300, 300]
    arrs = _problem(len(lengths), 2, 2, d, page, m, lengths, share=(8, 9))
    plans = [pa.split_plan(m * page, tile),
             (-(-m * page // 20), 20), (-(-m * page // 48), 48)]
    want = _check(arrs, plans)
    assert torch.equal(want[8], want[9])


def test_split_merge_with_many_idle_slots():
    """serve_plan's pattern: 120 slots of length 1 below 8 long rows,
    GQA (G=4), the wrapper's plan at D=32 f32 (a 64-position tile)."""
    d, page, m = 32, 16, 48
    lengths = [1] * 120 + [768, 300, 537, 640, 412, 412, 700, 555]
    arrs = _problem(128, 2, 4, d, page, m, lengths, share=(124, 125))
    tile = tile_positions(d, 4)
    n_split, chunk = pa.split_plan(m * page, tile)
    assert n_split > 1
    want = _check(arrs, [(n_split, chunk)])
    assert torch.equal(want[124], want[125])
