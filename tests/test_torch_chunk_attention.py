"""The paged chunk-extend attention (``kernels/paged_chunk_attention``):
the kernel behind ``tr.paged_chunk_extend_batch``'s ``attn_impl``.

* The wrapper's plain version (``paged_chunk_attention_ref`` on the
  tables cut by ``tables_upto``) against the one plain chunk attention,
  ``common.chunk_attention``, over the gathered logical view of the whole
  table: starts page-aligned, mid-page, crossing pages, a row whose chunk
  runs past the table's end, and a pad row (a row whose chunk lies past
  what its slot holds); G 1, 4 and 16, D 64 and 128, f32 and bf16.  The
  plain version reads the tables only up to the page of the last
  position, as the extend's plain path does, so the two agree to the
  rounding of sums over the masked tail's zeros.
* ``paged_chunk_extend_batch`` and ``paged_chunk_extend`` with
  ``attn_impl`` set to the wrapper (its plain version on the CPU) against
  ``attn_impl=None`` on the chunk extends of ``tests/test_torch_model.py``
  and after copy-on-write: the same pool bytes and logits.
* The engine: ``append_kernel_calls`` and the ``STAGE:append`` attr
  ``kernel`` stay 0 where the kernel does not run (the CPU; ``"ref"``).
* On a GPU only (marker ``cuda``): the kernel against its plain version
  at the iterative cell's append batch (8 x 512 queries over spans up to
  2,304, 32 heads over 2 KV heads, D 128), at G 4 / D 64 and on edges
  (G 1, 6, 16; D 16, 32, 96; pages of 1, 12, 16; ragged query tiles;
  rows clamped at the table's end), each launch under
  ``torch.cuda.set_sync_debug_mode("error")``, within a relative error
  that the plain version with one page of each row's V zeroed exceeds;
  the wrapper's refusals; and
  a tiny iterative engine whose every append forward ran the kernel.

    python -m pytest -m cuda tests/test_torch_chunk_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import topical_corpus
from repro_torch.kernels.paged_attention.ref import paged_gather
from repro_torch.kernels.paged_chunk_attention import ops as pca
from repro_torch.kernels.paged_chunk_attention.ref import (
    paged_chunk_attention_ref)
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as te
from repro_torch.serving.kv_cache import PagedKVCachePool
from repro_torch.serving.request import Request
from repro_torch.serving.telemetry import SpanTracer

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: plain version against the gathered view: the same products over more
#: (masked) keys, summed in another order
REF_TOL = {"f32": 1e-6, "bf16": 2 ** -8}
#: kernel against plain version: f32 scores against scores rounded to
#: bf16, one bf16 step of an output of order one (the flash kernel's)
KERNEL_TOL = 2e-2
#: ... and as a share of the plain version's norm, for outputs averaged
#: over thousands of keys, far below one: sound about 0.004 (f32 scores
#: rounded once against the plain version), a row's first page of V
#: dropped 0.09 at the cell's spans and more at shorter ones
KERNEL_REL_TOL = 2e-2

PAGE, M, T = 4, 6, 8
#: rows' start positions, on tables of M = 6 pages of 4 (24 positions),
#: T = 8 queries a row
STARTS = {"page_aligned": [4, 8, 0], "mid_page": [5, 2, 13],
          "crossing": [3, 7, 11],
          # row 0's chunk runs past position 23: its last queries see the
          # whole table
          "table_end": [20, 6, 1],
          # row 1 is an idle slot's pad row: start 0, a table of page 0
          "pad_rows": [9, 0, 14]}


def _pool(h_kv, d, dt, n_pages=3 * M + 1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n_pages, PAGE, h_kv, d, generator=g).to(dt)
            for _ in range(2)]


def _problem(case, g_heads, d, dt, seed=0):
    h_kv = 2
    k, v = _pool(h_kv, d, dt, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    tables = torch.randperm(3 * M, generator=gen).reshape(3, M).to(
        torch.int32)
    if case == "pad_rows":
        tables[1] = 0
    q = torch.randn(3, T, h_kv * g_heads, d, generator=gen).to(dt)
    starts = torch.tensor(STARTS[case], dtype=torch.int32)
    return q, k, v, tables, starts


def _cfg(n_heads, n_kv_heads, d, n_layers=2):
    return tr.TransformerConfig(name="chunk", n_layers=n_layers, d_model=48,
                                n_heads=n_heads, n_kv_heads=n_kv_heads,
                                d_head=d, d_ff=64, vocab_size=96)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("case", sorted(STARTS))
def test_plain_version_matches_chunk_attention(case, g, d, dt):
    q, k, v, tables, starts = _problem(case, g, d, DTYPES[dt])
    positions = starts.long()[:, None] + torch.arange(T)
    mask = (torch.arange(M * PAGE)[None, None, None, :]
            <= positions[:, None, :, None])
    want = cm.chunk_attention(q, paged_gather(k, tables),
                              paged_gather(v, tables), mask, DTYPES[dt])
    got = pca.paged_chunk_attention(q, k, v, tables, starts)
    assert pca.paged_chunk_attention.launches == 0     # CPU: no kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = REF_TOL[dt]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The entry points through the op (its plain version on the CPU)
# ---------------------------------------------------------------------------

#: (table row, start, n_valid) of each row of a chunk extend, T = 8 on
#: tables of 3 pages of 4 (``tests/test_torch_model.py``'s cases)
EXTENDS = {"inside": [(0, 5, 6)], "past_table": [(0, 9, 8)],
           "batch": [(0, 4, 3), (1, 6, 6), (2, 9, 8)],
           "batch_head": [(0, 0, 3), (1, 0, 8), (2, 0, 5)]}


@pytest.fixture(scope="module")
def model():
    cfg = _cfg(8, 2, 16)
    return cfg, tr.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(EXTENDS))
def test_extend_through_the_op_matches_the_plain_path(model, case, dt):
    """``paged_chunk_extend_batch`` and the one-row ``paged_chunk_extend``
    write the same pool bytes and give the same logits with the op as
    without it: the plain version is the plain path's arithmetic."""
    cfg, params = model
    tdt = DTYPES[dt]
    rows = EXTENDS[case]
    rng = np.random.default_rng(9)
    tables = torch.tensor(rng.permutation(10)[:9].reshape(3, 3),
                          dtype=torch.int32)
    tokens = torch.zeros(len(rows), T, dtype=torch.int32)
    for j, (_, _, n) in enumerate(rows):
        tokens[j, :n] = torch.tensor(rng.integers(0, 96, n))
    pool = {key: torch.tensor(rng.standard_normal(
        (cfg.n_layers, 10, PAGE, cfg.n_kv_heads, cfg.d_head)),
        dtype=torch.float32).to(tdt) for key in ("k", "v")}
    outs = []
    for attn in (None, pca.paged_chunk_attention):
        cache = {key: val.clone() for key, val in pool.items()}
        cache, lg = tr.paged_chunk_extend_batch(
            params, cache, tables[[r for r, _, _ in rows]], tokens,
            [s for _, s, _ in rows], [n for _, _, n in rows], cfg, tdt,
            attn_impl=attn)
        one = {key: val.clone() for key, val in pool.items()}
        each = []
        for (r, s, n), toks in zip(rows, tokens):
            one, row_lg = tr.paged_chunk_extend(params, one, tables[r], toks,
                                                s, n, cfg, tdt,
                                                attn_impl=attn)
            each.append(row_lg)
        outs.append((cache, lg, one, torch.stack(each)))
    (c0, l0, o0, e0), (c1, l1, o1, e1) = outs
    for key in ("k", "v"):
        assert torch.equal(c0[key], c1[key]), key
        assert torch.equal(o0[key], o1[key]), key
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    torch.testing.assert_close(e1, e0, rtol=0, atol=0)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_extend_through_the_op_after_copy_on_write(model, dt):
    """Three slots share a 10-token prompt's two full pages; slots 1 and 2
    are cut back so their appends start in the shared page and
    ``prepare_append`` copies it.  One batch through the op leaves the
    pool's bytes and logits as the plain path does."""
    cfg, params = model
    tdt = DTYPES[dt]
    prompt = torch.tensor(np.random.default_rng(3).integers(0, 96, 10),
                          dtype=torch.int32)
    _, _aux, prefix = tr.forward(params, prompt[None], cfg, tdt,
                                 collect_cache=True)
    lengths, lens = (10, 6, 4), (3, 6, 8)
    tokens = torch.tensor(np.random.default_rng(4).integers(0, 96, (3, T)),
                          dtype=torch.int32)
    outs = []
    for attn in (None, pca.paged_chunk_attention):
        pool = PagedKVCachePool(cfg, 3, 24, page_size=4, dtype=tdt,
                                device="cpu")
        for rid, length in enumerate(lengths):
            slot = pool.alloc(rid)
            pool.write_prefix(slot, prefix, len(prompt),
                              tokens=prompt.numpy())
            pool.lengths[slot] = length
        for slot, n in enumerate(lens):
            pool.prepare_append(slot, n)
        assert pool.metrics["pages_cow"] == 2
        pool.cache, lg = tr.paged_chunk_extend_batch(
            params, pool.cache, torch.tensor(pool.block_tables()), tokens,
            list(lengths), list(lens), cfg, tdt, attn_impl=attn)
        outs.append((pool.cache, lg))
    (c0, l0), (c1, l1) = outs
    for key in ("k", "v"):
        assert torch.equal(c0[key], c1[key]), key
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The engine's counter and attr
# ---------------------------------------------------------------------------

VOCAB = 128
ENGINE = {"decode_slots": 3, "s_max": 96, "max_new_tokens": 9,
          "page_size": 4, "iterative_interval": 3, "retrieval_batch": 2}


def _component(seed, device, causal=True, d=48, d_head=16):
    cfg = tr.TransformerConfig(name=f"g{seed}", n_layers=2, d_model=d,
                               n_heads=4, n_kv_heads=2, d_head=d_head,
                               d_ff=64, vocab_size=VOCAB, causal=causal)
    gen = torch.Generator(device=device).manual_seed(seed)
    return te.Component(cfg, tr.init_params(cfg, gen, device=device))


def _serve(device, d_head=16, **kw):
    corpus, _, make_q = topical_corpus(48, 10, VOCAB, n_topics=4)
    eng = te.RAGEngine(_component(0, device, d_head=d_head),
                       _component(1, device, causal=False, d=32), corpus,
                       te.EngineConfig(**{**ENGINE, **kw}), device=device)
    tracer = SpanTracer()
    eng.set_tracer(tracer)
    reqs = [Request(question=make_q(i % 4)) for i in range(5)]
    eng.serve(reqs)
    return eng, tracer, reqs


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_engine_counts_no_kernel_off_the_card(impl):
    """On the CPU the kernel never runs, whatever ``attn_impl``: the
    counter and every ``STAGE:append`` span's ``kernel`` read 0 while the
    appends happen."""
    eng, tracer, _ = _serve("cpu", attn_impl=impl)
    snap = eng.metrics_snapshot()
    assert snap["append_calls"] > 0
    assert snap["append_kernel_calls"] == 0
    spans = [s for s in tracer.spans() if s.kind == "STAGE:append"]
    assert spans and all(s.attrs["kernel"] == 0 for s in spans)
    assert (eng.chunk_attn is None) == (impl == "ref")


# ---------------------------------------------------------------------------
# On a GPU: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_problem(device, b, t, h_kv, g, d, page, m, starts, seed=0):
    """bf16 inputs on ``device``: a pool of b*m + 1 pages (one never
    tabled), each row's table a random draw of them."""
    gen = torch.Generator().manual_seed(seed)
    n_pages = b * m + 1
    k, v = (torch.randn(n_pages, page, h_kv, d, generator=gen)
            .to(torch.bfloat16).to(device) for _ in range(2))
    tables = torch.randperm(n_pages - 1, generator=gen)[:b * m].reshape(
        b, m).to(torch.int32).to(device)
    q = torch.randn(b, t, h_kv * g, d, generator=gen).to(
        torch.bfloat16).to(device)
    return q, k, v, tables, torch.tensor(starts, dtype=torch.int32,
                                         device=device)


#: (b, t, h_kv, g, d, page, m, starts) -- the iterative cell's append
#: batch (512-token documents appended at 528-1,792 into 256 pages of
#: 16), the same at G 4 / D 64, and edges
KERNEL_CASES = {
    "cell": (8, 512, 2, 16, 128, 16, 256,
             [528, 576, 1104, 1152, 1680, 1728, 1764, 1792]),
    "g4_d64": (8, 512, 2, 4, 64, 16, 256,
               [528, 576, 1104, 1152, 1680, 1728, 1764, 1792]),
    "g1_d128": (3, 200, 4, 1, 128, 16, 40, [0, 77, 500]),
    "g6_d128": (2, 70, 8, 6, 128, 16, 12, [5, 120]),
    "g16_d96": (2, 40, 2, 16, 96, 16, 8, [0, 33]),
    "d16_page1": (3, 24, 2, 4, 16, 1, 64, [0, 13, 50]),
    "d32_page12": (3, 37, 2, 8, 32, 12, 10, [3, 60, 100]),
    # every query of row 0 and the tail of row 1 past the table's end
    "table_end": (2, 64, 2, 16, 128, 16, 6, [96, 64]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_matches_plain_version(cuda, case):
    args = _kernel_problem(cuda, *KERNEL_CASES[case])
    before = pca.paged_chunk_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pca.paged_chunk_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = paged_chunk_attention_ref(*args)
    torch.cuda.synchronize()
    assert pca.paged_chunk_attention.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=KERNEL_TOL)
    # nothing systematic: the mean error stays far under a bf16 step
    assert float((got.float() - want.float()).abs().mean()) < 2e-3
    assert _rel_err(got, want) <= KERNEL_REL_TOL
    # ... a bound that a kernel skipping one page of each row fails
    q, k, v, tables, starts = args
    dropped = v.clone()
    dropped[tables[:, 0].long()] = 0
    assert _rel_err(paged_chunk_attention_ref(q, k, dropped, tables, starts),
                    want) > 2 * KERNEL_REL_TOL


def _rel_err(got, want) -> float:
    """Frobenius norm of the error over that of ``want``."""
    return float((got.float() - want.float()).norm()
                 / want.float().norm())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, starts = _kernel_problem(cuda, 2, 8, 2, 4, 64, 4, 4,
                                              [0, 3])
    call = pca.paged_chunk_attention_cuda
    with pytest.raises(TypeError):
        call(q.float(), k.float(), v.float(), tables, starts)
    with pytest.raises(TypeError):
        call(q, k, v, tables.long(), starts)
    with pytest.raises(TypeError):
        call(q, k, v, tables, starts.long())
    with pytest.raises(ValueError, match="head dim"):
        call(q[..., :20].contiguous(), k[..., :20].contiguous(),
             v[..., :20].contiguous(), tables, starts)
    with pytest.raises(ValueError, match="shapes"):
        call(q, k, v, tables[:1], starts)
    with pytest.raises(ValueError, match="contiguous"):
        call(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, tables,
             starts)
    with pytest.raises(ValueError, match="CUDA"):
        call(q, k.cpu(), v, tables, starts)


@pytest.mark.cuda
@pytest.mark.parametrize("d_head", [16, 64])
def test_engine_appends_through_the_kernel(cuda, d_head):
    """A tiny iterative engine on the card: every append forward ran the
    kernel, once a layer, and every ``STAGE:append`` says so."""
    before = pca.paged_chunk_attention.launches
    eng, tracer, reqs = _serve(cuda, d_head=d_head, attn_impl="cuda")
    snap = eng.metrics_snapshot()
    assert snap["append_calls"] > 0
    assert snap["append_kernel_calls"] == snap["append_calls"]
    assert pca.paged_chunk_attention.launches - before == \
        eng.gen.cfg.n_layers * snap["append_calls"]
    spans = [s for s in tracer.spans() if s.kind == "STAGE:append"]
    assert spans and all(s.attrs["kernel"] == 1 for s in spans)
    assert all(len(r.output) > 0 for r in reqs)
