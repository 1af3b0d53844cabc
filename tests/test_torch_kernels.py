"""The port's three kernels: their plain PyTorch versions against the JAX
package on the CPU, and (on a GPU only) the CUDA kernels against those
plain versions.

* Ragged paged-decode attention: the plain version
  (``paged_decode_attention_dense_ref``) against the JAX Pallas kernel in
  interpret mode and against the JAX dense oracle, on the edge cases of
  ``tests/test_paged_attention.py``.  float32 agrees to ``1e-5``; bf16 to
  one bf16 step of an output of order one (``2e-2``, the JAX tests' own
  kernel-vs-oracle bound), since both round an f32 result once.
* Dense decode attention: the plain version (``decode_attention_ref``)
  against the JAX Pallas kernel in interpret mode (through its wrapper,
  which pads S to a tile multiple) and against the JAX oracle on
  repeated KV heads, float32 to ``2e-3`` as ``tests/test_kernels.py``
  holds the kernel to its oracle.  Lengths run from 1 to S: a length past
  S clamps in the port and in the oracle but reads the wrapper's zero pad
  in the Pallas kernel, and at length 0 the two JAX versions disagree
  with each other (the port writes zeros there, as the CUDA kernel does).
* PQ scan: the plain version sums the sub-quantizers in order, as the
  Pallas kernel's loop does, so it is bit-equal to the kernel in interpret
  mode; ``ivf_pq.pq_scan_ref`` reduces in XLA's order (``1e-5``).

Tests marked ``cuda`` need a card and skip without one; run them on a
GPU with ``python -m pytest -m cuda tests/test_torch_kernels.py``.  They
hold the paged kernel to its plain version on the cases above, at the
edges of its split of the sequence (``test_paged_kernel_split_edges``)
and at serve_plan's 128-slot shape, each call under
``torch.cuda.set_sync_debug_mode("error")`` (the wrapper plans the split
without reading the lengths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import (
    paged_decode_attention_pallas)
from repro.kernels.paged_attention.ref import (
    engine_ref_attn as jax_engine_ref_attn,
    paged_decode_attention_dense_ref as jax_dense_ref)
from repro.kernels.decode_attention.ops import (
    decode_attention as jax_decode_attention)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref)
from repro.kernels.pq_scan.ops import pq_scan as jax_pq_scan
from repro.retrieval.ivf_pq import pq_scan_ref as jax_ivf_pq_scan_ref
from repro_torch import bridge
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention.ref import (
    engine_ref_attn, paged_decode_attention_dense_ref, paged_gather)
from repro_torch.kernels.pq_scan import ops as pq
from repro_torch.kernels.pq_scan.ref import pq_scan_ref
from repro_torch.models import common as cm

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

TOL = {"bf16": 2e-2, "f32": 1e-5}
JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(b, h_kv, g, d, page, m_pages, lengths, seed=0, tables=None):
    """Numpy paged-decode instance (float32 values); the pool holds one
    spare page past the tabled ones so a stale read would show."""
    rng = np.random.default_rng(seed)
    n_pool = b * m_pages + 1
    q = rng.standard_normal((b, h_kv, g, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, page, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, page, h_kv, d)).astype(np.float32)
    if tables is None:
        tables = rng.permutation(b * m_pages).reshape(b, m_pages)
    return (q, k, v, np.asarray(tables, np.int32),
            np.asarray(lengths, np.int32))


def _jax(arrs, dt):
    q, k, v, t, ln = arrs
    return (jnp.asarray(q, JDT[dt]), jnp.asarray(k, JDT[dt]),
            jnp.asarray(v, JDT[dt]), jnp.asarray(t), jnp.asarray(ln))


def _torch(arrs, dt, device="cpu"):
    q, k, v, t, ln = arrs
    return (torch.tensor(q, device=device).to(TDT[dt]),
            torch.tensor(k, device=device).to(TDT[dt]),
            torch.tensor(v, device=device).to(TDT[dt]),
            torch.tensor(t, device=device), torch.tensor(ln, device=device))


PAGED_CASES = {
    # name: (b, h_kv, g, d, page, m, lengths, tables)
    "ragged": (6, 2, 2, 16, 8, 4, [0, 1, 7, 8, 9, 32], None),
    "gqa": (3, 2, 2, 16, 8, 4, [5, 17, 32], None),
    "mqa": (3, 1, 4, 16, 8, 4, [5, 17, 32], None),
    "past_table": (2, 2, 2, 16, 8, 2, [2 * 8 + 7, 2 * 8], None),
    "shared_pages": (2, 2, 2, 16, 8, 3, [19, 19],
                     np.stack([np.arange(3), np.arange(3)])),
    "page1": (2, 2, 2, 16, 1, 16, [16, 8], None),
    "single_page": (2, 2, 2, 16, 16, 1, [16, 8], None),
    "zero_length": (2, 2, 2, 16, 4, 2, [0, 0], None),
}


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_plain_version_matches_jax(case, dt):
    b, h_kv, g, d, page, m, lengths, tables = PAGED_CASES[case]
    arrs = _problem(b, h_kv, g, d, page, m, lengths, tables=tables)
    want_kernel = paged_decode_attention_pallas(*_jax(arrs, dt),
                                                interpret=True)
    want_dense = jax_dense_ref(*_jax(arrs, dt))
    got = paged_decode_attention_dense_ref(*_torch(arrs, dt))
    assert got.dtype == TDT[dt] and got.shape == (b, h_kv, g, d)
    out = bridge.tensor_to_numpy(got)
    for want in (want_kernel, want_dense):
        np.testing.assert_allclose(out, np.asarray(want, np.float32),
                                   rtol=0, atol=TOL[dt])
    zero = np.asarray(lengths) == 0
    assert not out[zero].any()                  # length 0: exact zeros
    if case == "shared_pages":
        q = arrs[0].copy()
        q[1] = q[0]
        same = paged_decode_attention_dense_ref(
            *_torch((q,) + arrs[1:], dt))
        assert torch.equal(same[0], same[1])


def test_engine_ref_attn_and_gather_match_jax():
    """What ``attn_impl="ref"`` computes: gather + repeat + masked softmax
    with probabilities rounded to the compute dtype."""
    q4, k, v, tables, lens = _problem(3, 2, 2, 16, 8, 4, [5, 17, 32])
    q = q4.reshape(3, 1, 4, 16)
    for dt in ("bf16", "f32"):
        jq, jk, jv, jt, jl = _jax((q, k, v, tables, lens), dt)
        tq, tk, tv, tt, tl = _torch((q, k, v, tables, lens), dt)
        want = jax_engine_ref_attn(jq, jk, jv, jt, jl, q_per_kv=2)
        got = engine_ref_attn(tq, tk, tv, tt, tl, q_per_kv=2)
        np.testing.assert_allclose(bridge.tensor_to_numpy(got),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=TOL[dt])
    assert paged_gather(torch.tensor(k), torch.tensor(tables)).shape == \
        (3, 32, 2, 16)


def test_paged_wrapper_grouping_and_rank():
    """The wrapper takes the engine's (B, 1, H, D) rank and groups heads
    as repeat_kv does: head h_kv*G + g reads KV head h_kv."""
    q4, k, v, tables, lens = _problem(3, 2, 2, 16, 8, 4, [5, 17, 32])
    tq, tk, tv, tt, tl = _torch((q4, k, v, tables, lens), "f32")
    flat = tq.reshape(3, 1, 4, 16)
    out = pa.paged_decode_attention(flat, tk, tv, tt, tl)
    assert out.shape == flat.shape
    grouped = paged_decode_attention_dense_ref(tq, tk, tv, tt, tl)
    assert torch.equal(out[:, 0], grouped.reshape(3, 4, 16))
    ref = engine_ref_attn(flat, tk, tv, tt, tl, q_per_kv=2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)


DENSE_CASES = {
    # name: (b, h_kv, g, d, s, lengths)
    "mha": (3, 4, 1, 16, 37, [1, 20, 37]),
    "gqa2": (4, 2, 2, 32, 600, [1, 513, 599, 600]),
    "gqa4": (2, 2, 4, 64, 130, [128, 129]),
    "one_position": (2, 1, 4, 16, 1, [1, 1]),
}


def _dense_problem(b, h_kv, g, d, s, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h_kv, g, d)).astype(np.float32),
            rng.standard_normal((b, s, h_kv, d)).astype(np.float32),
            rng.standard_normal((b, s, h_kv, d)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_plain_version_matches_jax(case):
    b, h_kv, g, d, s, lengths = DENSE_CASES[case]
    q, k, v, ln = _dense_problem(b, h_kv, g, d, s, lengths)
    got = decode_attention_ref(*map(torch.tensor, (q, k, v, ln)))
    assert got.dtype == torch.float32 and got.shape == (b, h_kv, g, d)
    flat = q.reshape(b, h_kv * g, d)
    kernel = jax_decode_attention(jnp.asarray(flat), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(ln))
    oracle = jax_decode_ref(jnp.asarray(flat),
                            jnp.asarray(np.repeat(k, g, axis=2)),
                            jnp.asarray(np.repeat(v, g, axis=2)),
                            jnp.asarray(ln))
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy().reshape(b, h_kv * g, d),
                                   np.asarray(want), rtol=0, atol=2e-3)


def test_dense_plain_version_edges():
    """cache_len past S clamps to S (as the JAX oracle does); cache_len 0
    gives exact zeros; bf16 rounds the f32 result once; the wrapper takes
    the engine's (B, 1, H, D) rank and groups heads as repeat_kv does."""
    q, k, v, _ = _dense_problem(3, 2, 2, 16, 24, [0, 0, 0])
    ln = np.asarray([0, 24 + 5, 7], np.int32)
    tq, tk, tv, tl = map(torch.tensor, (q, k, v, ln))
    got = decode_attention_ref(tq, tk, tv, tl)
    assert not got[0].any()
    oracle = jax_decode_ref(jnp.asarray(q.reshape(3, 4, 16)),
                            jnp.asarray(np.repeat(k, 2, axis=2)),
                            jnp.asarray(np.repeat(v, 2, axis=2)),
                            jnp.asarray(ln))
    np.testing.assert_allclose(got.numpy().reshape(3, 4, 16)[1:],
                               np.asarray(oracle)[1:], rtol=0, atol=1e-5)
    half = decode_attention_ref(*(t.to(torch.bfloat16) for t in (tq, tk, tv)),
                                tl)
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().numpy(), got.numpy(), rtol=0,
                               atol=TOL["bf16"])
    flat = tq.reshape(3, 1, 4, 16)
    out = da.decode_attention(flat, tk, tv, tl)
    assert out.shape == flat.shape and torch.equal(out[:, 0],
                                                   got.reshape(3, 4, 16))
    ref = cm.decode_attention_ref(flat, cm.repeat_kv(tk, 2),
                                  cm.repeat_kv(tv, 2), tl)
    np.testing.assert_allclose(out[1:].numpy(), ref[1:].numpy(), rtol=0,
                               atol=1e-5)


PQ_SHAPES = [(1, 16, 4), (3, 100, 8), (2, 513, 16), (1, 2048, 8)]


def _pq_inputs(b, n, s, seed=0):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((b, s, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (b, n, s)).astype(np.uint8)
    return lut, codes


@pytest.mark.parametrize("b,n,s", PQ_SHAPES)
def test_pq_plain_version_matches_jax(b, n, s):
    lut, codes = _pq_inputs(b, n, s)
    got = pq_scan_ref(torch.tensor(lut), torch.tensor(codes)).numpy()
    kernel = np.asarray(jax_pq_scan(jnp.asarray(lut), jnp.asarray(codes)))
    np.testing.assert_array_equal(got, kernel)     # same order of the sum
    np.testing.assert_allclose(
        got, np.asarray(jax_ivf_pq_scan_ref(jnp.asarray(lut),
                                            jnp.asarray(codes))),
        rtol=1e-5, atol=1e-5)


def test_pq_plain_version_at_ivfpq_search_shapes():
    """The flattened (Q*P, LL, S) shapes ``ivf_pq.search`` emits."""
    from repro.retrieval.ivf_pq import adc_tables, build_index
    vecs = jax.random.normal(jax.random.PRNGKey(0), (96, 32))
    vecs = vecs / jnp.linalg.norm(vecs, axis=-1, keepdims=True)
    idx = build_index(jax.random.PRNGKey(1), vecs, n_lists=10, n_subq=8)
    queries = vecs[:4]
    c2 = jnp.sum(idx.centroids ** 2, axis=-1)
    _, probe = jax.lax.top_k(-(c2[None] - 2.0 * queries @ idx.centroids.T),
                             5)
    tables = adc_tables(idx, queries, jnp.take(idx.centroids, probe, axis=0))
    codes = jnp.take(idx.list_codes, probe, axis=0)
    q, p, ll, s = codes.shape
    lut = np.asarray(tables.reshape(q * p, s, 256))
    flat = np.asarray(codes.reshape(q * p, ll, s))
    got = pq.pq_scan(torch.tensor(lut), torch.tensor(flat)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_pq_scan(jnp.asarray(lut), jnp.asarray(flat))))


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version and leaves both launch counts
    alone; the launchers refuse CPU tensors outright."""
    pa.paged_decode_attention.launches = 0
    pq.pq_scan.launches = 0
    q4, k, v, tables, lens = _torch(_problem(2, 2, 2, 16, 8, 2, [3, 9]),
                                    "bf16")
    pa.paged_decode_attention(q4.reshape(2, 1, 4, 16), k, v, tables, lens)
    lut, codes = _pq_inputs(2, 40, 8)
    pq.pq_scan(torch.tensor(lut), torch.tensor(codes))
    assert pa.paged_decode_attention.launches == 0
    assert pq.pq_scan.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_cuda(q4, k, v, tables, lens)
    with pytest.raises(ValueError, match="CUDA"):
        pq.pq_scan_cuda(torch.tensor(lut), torch.tensor(codes))


def test_dense_cpu_tensors_never_launch():
    da.decode_attention.launches = 0
    q, k, v, ln = map(torch.tensor, _dense_problem(2, 2, 2, 16, 9, [3, 9]))
    da.decode_attention(q.reshape(2, 1, 4, 16), k, v, ln)
    assert da.decode_attention.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, k, v, ln)


# ---------------------------------------------------------------------------
# On a GPU: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_kernel_matches_plain_version(cuda, case, dt):
    b, h_kv, g, d, page, m, lengths, tables = PAGED_CASES[case]
    args = _torch(_problem(b, h_kv, g, d, page, m, lengths, tables=tables),
                  dt, cuda)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention_cuda(*args)
    want = paged_decode_attention_dense_ref(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dt])
    assert not got[torch.tensor(lengths, device=cuda) == 0].any()


@pytest.mark.cuda
def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, t, ln = _torch(_problem(2, 2, 2, 16, 8, 2, [3, 9]), "bf16",
                            cuda)
    with pytest.raises(TypeError):
        pa.paged_decode_attention_cuda(q.half(), k.half(), v.half(), t, ln)
    with pytest.raises(TypeError):
        pa.paged_decode_attention_cuda(q, k, v, t.long(), ln)
    with pytest.raises(ValueError):
        pa.paged_decode_attention_cuda(q, k[..., :8], v[..., :8], t, ln)
    with pytest.raises(ValueError):
        pa.paged_decode_attention_cuda(q.transpose(1, 2), k, v, t, ln)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention_cuda(
            *(x[..., :8].contiguous() for x in (q, k, v)), t, ln)


def _check_paged(arrs, dt, device, share):
    """One wrapper call under sync debug mode against the plain version;
    rows ``share`` = (i, j) get the same pages and query and must come out
    bit-equal."""
    q, k, v, t, ln = arrs
    i, j = share
    t = t.copy()
    t[j] = t[i]
    q = q.copy()
    q[j] = q[i]
    args = _torch((q, k, v, t, ln), dt, device)
    before = pa.paged_decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")    # the wrapper never syncs
    try:
        got = pa.paged_decode_attention_cuda(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = paged_decode_attention_dense_ref(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dt])
    assert not got[args[4] == 0].any()
    assert torch.equal(got[i], got[j])


@pytest.mark.cuda
@pytest.mark.parametrize("page", [1, 12, 16])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_paged_kernel_split_edges(cuda, d, dt, page):
    """Lengths 0, 1, each edge of the first split +- 1, page +- 1, M*page
    and M*page + 1 (clamps), G of 1, 4 and 12, pages of 1, 12 (which does
    not divide the chunk) and 16, on the wrapper's plan with several
    splits."""
    tile = da.tile_positions(d, TDT[dt].itemsize)
    chunk = pa.CHUNK_TILES * tile
    m = -(-(2 * chunk + 40) // page)
    n_split, plan_chunk = pa.split_plan(m * page, tile)
    assert n_split > 1 and plan_chunk == chunk     # the merge pass runs
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, page - 1, page + 1,
               2 * chunk + 1, m * page, m * page + 1, 300, 300]
    for g in (1, 4, 12):
        arrs = _problem(len(lengths), 2, g, d, page, m, lengths,
                        seed=d + page + g)
        _check_paged(arrs, dt, cuda, share=(10, 11))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_paged_kernel_at_serve_plan_shape(cuda, dt):
    """serve_plan's decode: 128 slots of 48 pages of 16, H_kv=8, G=4,
    D=64, 120 slots of length 1 below 8 live rows at 300-768 (two sharing
    pages; the pool hands out the highest slots first)."""
    lengths = [1] * 120 + [768, 300, 537, 640, 412, 412, 700, 555]
    arrs = _problem(128, 8, 4, 64, 16, 48, lengths)
    _check_paged(arrs, dt, cuda, share=(124, 125))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("h_kv,g", [(16, 1), (8, 4), (2, 16)],
                         ids=["moonlight", "minitron", "chatglm3"])
def test_paged_kernel_at_model_heads(cuda, h_kv, g, dt):
    """serve's 8 slots of 64 pages of 16 at D=128 under the KV heads of
    Moonlight-16B-A3B (16, G=1), Minitron-8B (8, G=4) and ChatGLM3-6B
    (2, G=16: two blocks of G=8)."""
    lengths = [0, 1, 537, 1025, 300, 300, 1024, 16]
    arrs = _problem(8, h_kv, g, 128, 16, 64, lengths, seed=h_kv + g)
    _check_paged(arrs, dt, cuda, share=(4, 5))


DENSE_CUDA_CASES = {**DENSE_CASES,
                    "ragged_lengths": (8, 2, 4, 128, 300,
                                       [0, 1, 127, 128, 129, 299, 300, 301])}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(DENSE_CUDA_CASES))
def test_dense_kernel_matches_plain_version(cuda, case, dt):
    b, h_kv, g, d, s, lengths = DENSE_CUDA_CASES[case]
    q, k, v, ln = _dense_problem(b, h_kv, g, d, s, lengths)
    args = [torch.tensor(x, device=cuda).to(TDT[dt]) for x in (q, k, v)]
    args.append(torch.tensor(ln, device=cuda))
    before = da.decode_attention.launches
    got = da.decode_attention_cuda(*args)
    want = decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dt])
    assert not got[args[3] == 0].any()


@pytest.mark.cuda
def test_dense_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, ln = (torch.tensor(x, device=cuda) for x in
                   _dense_problem(2, 2, 2, 16, 9, [3, 9]))
    with pytest.raises(TypeError):
        da.decode_attention_cuda(q.half(), k.half(), v.half(), ln)
    with pytest.raises(TypeError):
        da.decode_attention_cuda(q, k, v, ln.long())
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q, k[:1], v[:1], ln)
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q, k.transpose(1, 2), v.transpose(1, 2), ln)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention_cuda(*(x[..., :8].contiguous() for x in (q, k, v)),
                                 ln)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,s", PQ_SHAPES)
def test_pq_kernel_bit_equal_to_plain_version(cuda, b, n, s):
    lut, codes = _pq_inputs(b, n, s)
    tl, tc = torch.tensor(lut, device=cuda), torch.tensor(codes, device=cuda)
    before = pq.pq_scan.launches
    got = pq.pq_scan(tl, tc)
    torch.cuda.synchronize()
    assert pq.pq_scan.launches == before + 1
    assert torch.equal(got, pq_scan_ref(tl, tc))
    with pytest.raises(TypeError):
        pq.pq_scan(tl.double(), tc)
