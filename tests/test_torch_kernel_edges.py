"""Edges of the port's flash-attention and dense decode-attention kernels.

* On the CPU: the dense kernel's split of the sequence.  ``split_plan``
  (chosen on the host from B, H_kv and S alone) covers every position of
  [0, S) exactly once with whole tiles, and merging per-split partials
  (m, l, acc) by the rescale-and-sum the kernel's second pass runs gives
  ``decode_attention_ref`` on the whole sequence (float32, ``1e-6``: the
  two differ only in the order of f32 sums and exp2 against exp).
* On a GPU only (marker ``cuda``): the flash kernel over ragged S, every
  kv_len edge, causal and full, every head width, G of 1 and 4, bf16 and
  f32; the dense kernel at B of 1 and 8 over lengths 0, 1, each split
  edge +- 1, S and S + 1, every head width, G of 1, 4 and 12, on a plan
  with several splits (an empty split included) and on a plan with one.
  Tolerances: one bf16 step of an output of order one (``2e-2``) and
  ``1e-5`` in float32, as the kernels' other tests hold them.

Run the GPU part with ``python -m pytest -m cuda
tests/test_torch_kernel_edges.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.set_num_threads(1)

TOL = {"bf16": 2e-2, "f32": 1e-5}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}
HEAD_DIMS = (16, 32, 64, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CPU: the split of the sequence and the merge of its partials
# ---------------------------------------------------------------------------

#: the kernel's tile at every (head width, element size) it is built for
TILES = sorted({da.tile_positions(d, size) for d in HEAD_DIMS
                for size in (2, 4)})


@pytest.mark.parametrize("b,h_kv", [(1, 1), (1, 8), (2, 4), (8, 8), (32, 8),
                                    (64, 8), (300, 1)])
def test_split_plan_covers_every_position_once(b, h_kv):
    for tile in TILES:
        for s in (0, 1, 2, tile - 1, tile, tile + 1, 5 * tile + 3, 1000,
                  1024, 1025, 40_000):
            n, chunk = da.split_plan(b, h_kv, s, tile)
            assert n >= 1 and chunk >= tile and chunk % tile == 0
            starts = [i * chunk for i in range(n)]
            assert all(st < s for st in starts) or (s == 0 and n == 1)
            cover = np.zeros(s, np.int64)
            for st in starts:
                cover[st:st + chunk] += 1
            assert (cover == 1).all(), (b, h_kv, s, tile)
            # enough blocks: at least half the splits the target asks for
            want = min(-(-da.TARGET_BLOCKS // (b * h_kv)), -(-s // tile))
            assert 2 * n >= want


def _dense(b, h_kv, g, d, s, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((b, h_kv, g, d)),
                         dtype=torch.float32),
            torch.tensor(rng.standard_normal((b, s, h_kv, d)),
                         dtype=torch.float32),
            torch.tensor(rng.standard_normal((b, s, h_kv, d)),
                         dtype=torch.float32))


def _merged(q, k, v, lengths, n_split, chunk):
    """Per-split partials in f32 (log2 units, as the kernel keeps them),
    then the merge: out = sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i
    over the splits that start inside the length."""
    b, h_kv, g, d = q.shape
    qs = q * (math.log2(math.e) / math.sqrt(d))
    out = torch.zeros_like(q)
    for bi in range(b):
        n = min(int(lengths[bi]), k.shape[1])
        parts = []
        for i in range(n_split):
            lo, hi = i * chunk, min((i + 1) * chunk, n)
            if lo >= hi:
                continue
            sc = torch.einsum("hgd,khd->hgk", qs[bi], k[bi, lo:hi])
            m = sc.amax(-1)
            p = torch.exp2(sc - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("hgk,khd->hgd", p, v[bi, lo:hi])))
        if not parts:
            continue
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - mm) for m, _, _ in parts]
        ll = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        acc = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[bi] = acc / ll[..., None]
    return out


@pytest.mark.parametrize("b,h_kv,g,d,s,tile,lengths", [
    (8, 8, 4, 64, 1024, 64, [1, 537, 1024, 1025, 300, 300, 16, 1000]),
    (1, 8, 4, 64, 40, 64, [39]),
    (3, 2, 2, 16, 37, 8, [0, 9, 37]),
    (2, 1, 4, 32, 100, 16, [100, 33]),
    (4, 2, 1, 128, 200, 16, [1, 16, 17, 199]),
])
def test_merged_partials_equal_the_whole_sequence(b, h_kv, g, d, s, tile,
                                                  lengths):
    q, k, v = _dense(b, h_kv, g, d, s)
    ln = torch.tensor(lengths, dtype=torch.int32)
    n_split, chunk = da.split_plan(b, h_kv, s, tile)
    want = decode_attention_ref(q, k, v, ln)
    got = _merged(q, k, v, ln, n_split, chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    # and with one split of every tile (the most partials the plan allows)
    got = _merged(q, k, v, ln, -(-s // tile), tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# On a GPU: the flash kernel's edges
# ---------------------------------------------------------------------------

def _qkv(b, s, h, h_kv, d, dt, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                              device=device).to(TDT[dt])
                 for shape in ((b, s, h, d), (b, s, h_kv, d),
                               (b, s, h_kv, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("kv", ["0", "1", "s-1", "s"])
@pytest.mark.parametrize("s", [1, 15, 64, 65, 200, 1024])
def test_flash_kernel_edges(cuda, s, kv, dt, causal):
    kv_len = {"0": 0, "1": 1, "s-1": s - 1, "s": s}[kv]
    for d in HEAD_DIMS:
        for g in (1, 4):
            q, k, v = _qkv(1, s, 2 * g, 2, d, dt, cuda, seed=d + g)
            before = fa.flash_attention.launches
            got = fa.flash_attention(q, k, v, causal, kv_len)
            want = flash_attention_ref(q, k, v, causal, kv_len)
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == before + 1
            assert got.dtype == q.dtype and got.shape == q.shape
            if kv_len == 0:      # no visible key: the kernel writes zeros
                assert not got.any(), (d, g)
                continue
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=TOL[dt], msg=f"d={d} g={g}")


# ---------------------------------------------------------------------------
# On a GPU: the dense decode kernel's splits
# ---------------------------------------------------------------------------

def _dense_case(b, d, dt, g, s, lengths, device):
    q, k, v = (x.to(device=device, dtype=TDT[dt])
               for x in _dense(b, 2, g, d, s, seed=d + g))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


def _check_dense(q, k, v, ln, dt):
    before = da.decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")    # the wrapper never syncs
    try:
        got = da.decode_attention_cuda(q, k, v, ln)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dt])
    assert not got[ln == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_dense_kernel_split_edges(cuda, d, dt, b):
    tile = da.tile_positions(d, TDT[dt].itemsize)
    s = 4 * tile + 5
    n_split, chunk = da.split_plan(b, 2, s, tile)
    assert n_split > 1 and chunk == tile     # the merge pass runs
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, s, s + 1]
    _check_lengths(b, d, dt, s, lengths, cuda)
    # one split: the split kernel writes the output itself
    s = tile - 3
    assert da.split_plan(b, 2, s, tile)[0] == 1
    _check_lengths(b, d, dt, s, [0, 1, s, s + 1, 2, 3, s - 1, 7], cuda)


def _check_lengths(b, d, dt, s, lengths, device):
    """All the lengths in one call at B=8, one call per length at B=1."""
    for g in (1, 4, 12):
        batches = [lengths] if b == 8 else [[x] for x in lengths]
        for ln in batches:
            _check_dense(*_dense_case(b, d, dt, g, s, ln, device), dt)
