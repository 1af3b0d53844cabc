"""The PQ scan over IVF lists read in place: ``pq_scan_lists`` and the
kernel's plan, against the JAX package on the CPU and (on a GPU only)
the CUDA kernel against its plain version.

* ``pq_scan_lists_ref(lut, list_codes, rows)`` equals ``pq_scan_ref`` of
  the gathered lists ``list_codes[rows]`` to the bit, and the JAX Pallas
  kernel (interpret mode) on the same gathered lists to ``1e-6``: all sum
  the sub-quantizers in order from zero.
* ``ivf_pq.search(use_kernel=True)``, which scans through
  ``pq_scan_lists``, gives the JAX search's ids on an index carried across
  with ``bridge.index_from_jax``, at 8 and at 96 sub-quantizers (the
  paper's 96-byte codes).
* The kernel's host plan (``ops.scan_plan``) covers [0, N) and [0, S)
  once and in order, and a plain emulation of the kernel's walk under it
  (splits of N, chunks of S with the partial sum carried in the output,
  tiles) is bit-equal to the plain version.

Tests marked ``cuda`` need a card and skip without one; run them on a GPU
with ``python -m pytest -m cuda tests/test_torch_pq_scan.py``.  They hold
the kernel to its plain version to the bit over S in {1, 7, 8, 16, 96, 97,
256} (256 walks S in two chunks), ragged N and repeated rows, through
both entry points, each call under ``torch.cuda.set_sync_debug_mode
("error")`` (the wrappers never read device memory).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pq_scan.ops import pq_scan as jax_pq_scan
from repro.retrieval import ivf_pq as jivf
from repro_torch import bridge
from repro_torch.kernels.pq_scan import ops as pq
from repro_torch.kernels.pq_scan.ref import pq_scan_lists_ref, pq_scan_ref
from repro_torch.retrieval import ivf_pq as tivf

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

# repeated and out of order
ROWS = [3, 0, 3, 4, 1, 0]


def _lists(n_lists, ll, s, b, seed=0):
    """Numpy lut (B, S, 256) f32 and list codes (L, LL, S) u8."""
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, s, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (n_lists, ll, s)).astype(np.uint8)
    return lut, codes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("s", [1, 8, 12, 96])
@pytest.mark.parametrize("ll", [37, 104])
def test_lists_plain_version_matches_gather_and_jax(s, ll):
    lut, codes = _lists(5, ll, s, len(ROWS))
    rows = np.asarray(ROWS, np.int32)
    got = pq_scan_lists_ref(torch.tensor(lut), torch.tensor(codes),
                            torch.tensor(rows))
    gathered = codes[rows]
    assert torch.equal(got, pq_scan_ref(torch.tensor(lut),
                                        torch.tensor(gathered)))
    want = np.asarray(jax_pq_scan(jnp.asarray(lut), jnp.asarray(gathered)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    pq.pq_scan.launches = 0
    via = pq.pq_scan_lists(torch.tensor(lut), torch.tensor(codes),
                           torch.tensor(rows))
    assert torch.equal(via, got) and pq.pq_scan.launches == 0


def _vectors(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("n_subq", [8, 96])
def test_search_through_lists_gives_jax_ids(n_subq):
    """Same carried index, same queries: the port's search through
    ``pq_scan_lists`` gives the JAX kernel search's ids and distances, and
    the port's plain search's to the bit."""
    vecs = _vectors(300, 96, seed=0)
    idx = jivf.build_index(jax.random.PRNGKey(1), jnp.asarray(vecs),
                           n_lists=12, n_subq=n_subq, kmeans_iters=5)
    tidx = bridge.index_from_jax(idx.centroids, idx.codebooks, idx.list_ids,
                                 idx.list_codes, idx.n_vectors, device="cpu")
    q = vecs[:6] + 0.05 * _vectors(6, 96, seed=3)
    jd, ji = jivf.search(idx, jnp.asarray(q), nprobe=3, k=10,
                         use_kernel=True)
    td, ti = tivf.search(tidx, torch.tensor(q), nprobe=3, k=10,
                         use_kernel=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    pd, pi = tivf.search(tidx, torch.tensor(q), nprobe=3, k=10)
    assert torch.equal(ti, pi) and torch.equal(td, pd)


PLAN_SHAPES = [(1, 1, 1), (8, 104, 8), (8, 7704, 96), (256, 7704, 96),
               (32, 256, 8), (3, 257, 97), (300, 10, 256), (1, 100_000, 8),
               (132, 5000, 16), (66, 1280, 8)]


@pytest.mark.parametrize("b,n,s", PLAN_SHAPES)
def test_scan_plan_covers_n_and_s_once_in_order(b, n, s):
    n_split, chunk, s_chunk = pq.scan_plan(b, n, s)
    assert chunk % pq.TILE == 0 and 1 <= s_chunk <= pq.MAX_SUBQ
    bounds = [(i * chunk, min((i + 1) * chunk, n)) for i in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(lo < hi for lo, hi in bounds)                # none empty
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    s_bounds = [(s0, min(s0 + s_chunk, s)) for s0 in range(0, s, s_chunk)]
    assert s_bounds[0][0] == 0 and s_bounds[-1][1] == s
    assert all(a[1] == b_[0] for a, b_ in zip(s_bounds, s_bounds[1:]))
    # no more splits than filling the card's SMs needs, and the shortest
    # splits that keep to that
    n_tiles, tiles = -(-n // pq.TILE), chunk // pq.TILE
    assert n_split <= -(-pq.FILL_BLOCKS // b)
    assert tiles == 1 or b * -(-n_tiles // (tiles - 1)) > pq.FILL_BLOCKS


def test_scan_plan_at_the_main_path_shapes():
    # serve's one search: one block a probed list
    assert pq.scan_plan(8, 104, 8) == (1, 256, 8)
    # 32 queries x nprobe 8 over a Wikipedia-sized index: a block a row,
    # staging its 96 KB table once
    assert pq.scan_plan(256, 7704, 96) == (1, 7936, 96)
    # one query there: 16 splits of 2 tiles, 128 blocks
    assert pq.scan_plan(8, 7704, 96) == (16, 512, 96)
    assert pq.scan_plan(4, 600, 256)[2] == 128


def _emulate(lut, codes):
    """The kernel's walk under ``scan_plan``, in plain torch over all rows
    at once: splits of N, chunks of S in order (the partial sum carried in
    the output between chunks), tiles of TILE codes."""
    b, s, _ = lut.shape
    n = codes.shape[1]
    n_split, chunk, s_chunk = pq.scan_plan(b, n, s)
    out = torch.full((b, n), float("nan"))
    for i in range(n_split):
        lo, hi = i * chunk, min((i + 1) * chunk, n)
        for s0 in range(0, s, s_chunk):
            for t0 in range(lo, hi, pq.TILE):
                t1 = min(t0 + pq.TILE, hi)
                acc = torch.zeros(b, t1 - t0) if s0 == 0 else out[:, t0:t1]
                for j in range(s0, min(s0 + s_chunk, s)):
                    acc = acc + torch.gather(lut[:, j], 1,
                                             codes[:, t0:t1, j].long())
                out[:, t0:t1] = acc
    return out


@pytest.mark.parametrize("b,n,s", [(2, 700, 8), (140, 600, 12),
                                   (3, 300, 256)])
def test_plan_emulation_bit_equal_to_plain_version(b, n, s):
    lut, codes = _lists(b, n, s, b, seed=5)
    rows = torch.arange(b - 1, -1, -1, dtype=torch.int32)
    want = pq_scan_lists_ref(torch.tensor(lut), torch.tensor(codes), rows)
    got = _emulate(torch.tensor(lut), torch.tensor(codes)[rows.long()])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on a GPU: the kernel against its plain version
# ---------------------------------------------------------------------------

def _no_sync(fn, *args):
    torch.cuda.set_sync_debug_mode("error")    # the wrappers never sync
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 8, 16, 96, 97, 256])
@pytest.mark.parametrize("n", [37, 1000, 5000])
def test_kernel_bit_equal_to_plain_version(cuda, s, n):
    """Ragged N (37: one partial tile; 1,000: a partial last tile; 5,000:
    many tiles a split) through both entry points, rows with repeats."""
    lut, codes = _lists(5, n, s, len(ROWS), seed=s)
    tl, tc = torch.tensor(lut, device=cuda), torch.tensor(codes, device=cuda)
    rows = torch.tensor(ROWS, dtype=torch.int32, device=cuda)
    before = pq.pq_scan.launches
    got = _no_sync(pq.pq_scan_lists, tl, tc, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, pq_scan_lists_ref(tl, tc, rows))
    gathered = tc[rows.long()].contiguous()
    got = _no_sync(pq.pq_scan, tl, gathered)
    torch.cuda.synchronize()
    assert torch.equal(got, pq_scan_ref(tl, gathered))
    assert pq.pq_scan.launches == before + 2     # both entry points count


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,s", [(300, 10, 8), (2, 20_000, 96),
                                   (256, 777, 96), (1, 1, 1)])
def test_kernel_at_plan_edges(cuda, b, n, s):
    """Many rows of short lists, a few long ones (many splits), one code."""
    lut, codes = _lists(b, n, s, b, seed=7)
    tl, tc = torch.tensor(lut, device=cuda), torch.tensor(codes, device=cuda)
    got = _no_sync(pq.pq_scan, tl, tc)
    torch.cuda.synchronize()
    assert torch.equal(got, pq_scan_ref(tl, tc))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [8, 96])
def test_kernel_on_unaligned_codes(cuda, s):
    """Codes one byte off a word boundary copy byte by byte."""
    lut, codes = _lists(5, 300, s, len(ROWS), seed=9)
    tl = torch.tensor(lut, device=cuda)
    buf = torch.empty(codes.size + 1, dtype=torch.uint8, device=cuda)
    tc = buf[1:].view(codes.shape)
    tc.copy_(torch.tensor(codes, device=cuda))
    assert tc.data_ptr() % 2 == 1 and tc.is_contiguous()
    rows = torch.tensor(ROWS, dtype=torch.int32, device=cuda)
    got = _no_sync(pq.pq_scan_lists, tl, tc, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, pq_scan_lists_ref(tl, tc, rows))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    lut, codes = _lists(5, 40, 8, len(ROWS))
    tl, tc = torch.tensor(lut, device=cuda), torch.tensor(codes, device=cuda)
    rows = torch.tensor(ROWS, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                               # dtypes
        pq.pq_scan_lists(tl.double(), tc, rows)
    with pytest.raises(TypeError):
        pq.pq_scan_lists(tl, tc.to(torch.int8), rows)
    with pytest.raises(TypeError):
        pq.pq_scan_lists(tl, tc, rows.long())
    with pytest.raises(ValueError):                              # shapes
        pq.pq_scan_lists(tl[..., :128].contiguous(), tc, rows)
    with pytest.raises(ValueError):
        pq.pq_scan_lists(tl, tc[..., :4].contiguous(), rows)
    with pytest.raises(ValueError):
        pq.pq_scan_lists(tl, tc, rows[:-1])
    with pytest.raises(ValueError):
        pq.pq_scan(tl, tc)                  # 5 lists for 6 rows
    with pytest.raises(ValueError):                              # devices
        pq.pq_scan_lists(tl, tc, rows.cpu())
    with pytest.raises(ValueError):
        pq.pq_scan_lists(tl, tc.cpu(), rows)
    with pytest.raises(ValueError):                              # layout
        pq.pq_scan_lists(tl, tc.transpose(0, 1), rows)
    with pytest.raises(ValueError):         # a lut not on 16 bytes
        flat = torch.empty(tl.numel() + 1, device=cuda)
        pq.pq_scan_lists(flat[1:].view(tl.shape), tc, rows)
    # a row index outside [0, L): NaN for that row, the others untouched
    bad = torch.tensor([3, 5, 0, -1, 1, 0], dtype=torch.int32, device=cuda)
    got = _no_sync(pq.pq_scan_lists, tl, tc, bad)
    torch.cuda.synchronize()
    assert got[[1, 3]].isnan().all()
    keep = torch.tensor([0, 2, 4, 5], device=cuda)
    assert torch.equal(got[keep],
                       pq_scan_lists_ref(tl[keep], tc, bad[keep]))
