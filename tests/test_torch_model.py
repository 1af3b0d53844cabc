"""Port vs JAX: model building blocks and the transformer's serving entry
points on one tiny config (2 layers, d_model 48, 4 query / 2 KV heads,
d_head 16).  Both sides get the same numpy inputs and the same weights
(JAX ``tr.init_params`` carried across with ``repro_torch.bridge``).

Tolerances: float32 compute agrees to ``rtol = atol = 1e-5`` (the two
frameworks sum matmuls in different orders).  bfloat16 compute rounds at
the same places in both, but a product can land on the other side of a
rounding boundary; one bf16 step is 2^-8 relative, and two layers of
residual stream carry a few of them, so bf16 outputs are held to
``BF16_TOL`` absolute on values of order one.

The last test holds the port against itself, not JAX: every cache entry
point against ``forward``, through the layer body they share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 6e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _tiny(**kw):
    fields = dict(name="tiny", n_layers=2, d_model=48, n_heads=4,
                  n_kv_heads=2, d_head=16, d_ff=64, vocab_size=96)
    fields.update(kw)
    return jtr.TransformerConfig(**fields)


@pytest.fixture(scope="module")
def model():
    jcfg = _tiny()
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(bridge.tensor_to_numpy(got),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    want = jcm.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w))
    got = cm.rms_norm(torch.tensor(x).to(tdt), torch.tensor(w))
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("frac", [1.0, 0.5], ids=["full", "partial"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_rope(frac, dt):
    """Interleaved pairs, full and partial rotary, with per-row positions."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = jcm.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0,
                          frac)
    got = cm.apply_rope(torch.tensor(x).to(tdt), torch.tensor(pos), 10000.0,
                        frac)
    assert got.dtype == tdt
    _close(got, want, tol)


def test_rope_is_interleaved_not_half_split():
    """Rotating position 1 by hand: pairs are (x0, x1), (x2, x3), ..."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    out = cm.apply_rope(x, torch.tensor([[1]]), 10000.0)
    assert torch.allclose(out[0, 0, 0, :2],
                          torch.tensor([np.cos(1.0), np.sin(1.0)],
                                       dtype=torch.float32))
    assert float(out[..., 2:].abs().max()) == 0.0


def test_attention_helpers_match_jax():
    """naive / chunked causal attention and decode_attention_ref."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    _close(cm.naive_causal_attention(tq, tk, tv),
           jcm.naive_causal_attention(jq, jk, jv), F32_TOL)
    _close(cm.naive_causal_attention(tq, tk, tv, window=3),
           jcm.naive_causal_attention(jq, jk, jv, window=3), F32_TOL)
    _close(cm.chunked_causal_attention(tq, tk, tv, block_kv=4),
           jcm.chunked_causal_attention(jq, jk, jv, block_kv=4), F32_TOL)
    lens = np.asarray([3, 10], np.int32)
    _close(cm.decode_attention_ref(tq[:, :1], tk, tv, torch.tensor(lens)),
           jcm.decode_attention_ref(jq[:, :1], jk, jv, jnp.asarray(lens)),
           F32_TOL)
    kr = cm.repeat_kv(tk[:, :, :2], 2)
    _close(kr, jcm.repeat_kv(jk[:, :, :2], 2), 0.0)


def test_int8_quantization_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    jq = jcm.quantize_int8(jnp.asarray(w))
    tq = cm.quantize_int8(torch.tensor(w))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    _close(tq["scale"], jq["scale"], F32_TOL)
    _close(cm.maybe_dequant(tq, torch.float32),
           jcm.maybe_dequant(jq, jnp.float32), F32_TOL)
    _close(cm.dequantize_int8(tq), jcm.dequantize_int8(jq), BF16_TOL)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_collect_cache(model, dt):
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    tokens = np.random.default_rng(4).integers(0, 96, (2, 12)).astype(
        np.int32)
    jl, _, jc = jtr.forward(jparams, jnp.asarray(tokens), jcfg, jdt,
                            collect_cache=True)
    tl, aux, tc = tr.forward(tparams, torch.tensor(tokens), tcfg, tdt,
                             collect_cache=True)
    assert tl.dtype == tdt and tl.shape == jl.shape and float(aux) == 0.0
    _close(tl, jl, tol)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape
        _close(tc[k], jc[k], tol)
    hid = tr.forward(tparams, torch.tensor(tokens), tcfg, tdt,
                     return_hidden=True)
    _close(hid, jtr.forward(jparams, jnp.asarray(tokens), jcfg, jdt,
                            return_hidden=True), tol)


def test_forward_long_sequence_uses_chunked_attention():
    """Above ``chunked_attn_threshold`` both sides take the online-softmax
    path; f32 logits still agree."""
    jcfg = _tiny(chunked_attn_threshold=8, attn_block_kv=4)
    jparams = jtr.init_params(jax.random.PRNGKey(5), jcfg)
    tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, 96, (1, 13)).astype(
        np.int32)
    jl, _ = jtr.forward(jparams, jnp.asarray(tokens), jcfg, jnp.float32)
    tl, _ = tr.forward(tparams, torch.tensor(tokens), tcfg, torch.float32)
    _close(tl, jl, F32_TOL)


def test_encode(model):
    jcfg, jparams, tcfg, tparams = model
    ecfg = dataclasses.replace(jcfg, causal=False)
    tokens = np.random.default_rng(6).integers(0, 96, (3, 9)).astype(
        np.int32)
    want = jtr.encode(jparams, jnp.asarray(tokens), ecfg)
    got = tr.encode(tparams, torch.tensor(tokens),
                    dataclasses.replace(tcfg, causal=False))
    _close(got, want, F32_TOL)
    assert np.allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0,
                       atol=1e-4)


def _paged_problem(cfg, seed=7):
    """A random page pool (L, P, page, H_kv, D), permuted block tables and
    per-row positions; row 2's position lies past its block table."""
    rng = np.random.default_rng(seed)
    page, m, b = 4, 3, 3
    n_pages = b * m + 1
    pool = {k: rng.standard_normal((cfg.n_layers, n_pages, page,
                                    cfg.n_kv_heads, cfg.d_head)).astype(
                                        np.float32) for k in ("k", "v")}
    tables = rng.permutation(b * m).reshape(b, m).astype(np.int32)
    token = np.asarray([3, 5, 7], np.int32)
    pos = np.asarray([6, 0, m * page + 2], np.int32)
    return pool, tables, token, pos


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_step(model, dt):
    """write_mask False rows and a position past the table are not written
    (JAX drops them out of bounds); logits and the post-step pool agree."""
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    pool, tables, token, pos = _paged_problem(jcfg)
    mask = np.asarray([True, False, True])
    jl, jc = jtr.paged_decode_step(
        jparams, {k: jnp.asarray(v, jdt) for k, v in pool.items()},
        jnp.asarray(token), jnp.asarray(pos), jnp.asarray(tables), jcfg,
        jdt, write_mask=jnp.asarray(mask))
    tcache = {k: torch.tensor(v).to(tdt) for k, v in pool.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    tl, tc = tr.paged_decode_step(
        tparams, tcache, torch.tensor(token), torch.tensor(pos),
        torch.tensor(tables), tcfg, tdt, write_mask=torch.tensor(mask))
    assert tc is tcache                       # the port updates in place
    _close(tl, jl, tol)
    for k in ("k", "v"):
        _close(tc[k], jc[k], tol)
        # the masked row's pages and the unwritten row keep their bytes
        assert torch.equal(tc[k][:, tables[1]], before[k][:, tables[1]])
        assert torch.equal(tc[k][:, tables[2]], before[k][:, tables[2]])
    # exactly one row per layer changed: row 0's write at position 6
    changed = (tc["k"] != before["k"]).any(dim=(3, 4))
    assert int(changed.sum()) == jcfg.n_layers


def test_paged_decode_step_kernel_plain_version_agrees(model):
    """``attn_impl`` with the kernel's wrapper (its plain version on the
    CPU) gives the default path's tokens in f32."""
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    _, _, tcfg, tparams = model
    pool, tables, token, pos = _paged_problem(tcfg, seed=8)
    pos = np.minimum(pos, 11)
    outs = []
    for attn in (None, paged_decode_attention):
        cache = {k: torch.tensor(v) for k, v in pool.items()}
        lg, _ = tr.paged_decode_step(
            tparams, cache, torch.tensor(token), torch.tensor(pos),
            torch.tensor(tables), tcfg, torch.float32, attn_impl=attn)
        outs.append(lg)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                               rtol=F32_TOL, atol=F32_TOL)


#: (table row, start, n_valid) of each row of a chunk extend, T = 8 on a
#: table of 3 pages of 4: a chunk inside the table; one cut at its end; a
#: batch of a page-aligned row with pad tokens, a mid-page row that
#: crosses a page, and a row cut at the end of its table; and a batch
#: whose positions end in the table's second page, so the attention reads
#: two of its three pages
EXTENDS = {"inside": [(0, 5, 6)], "past_table": [(0, 9, 8)],
           "batch": [(0, 4, 3), (1, 6, 6), (2, 9, 8)],
           "batch_head": [(0, 0, 3), (1, 0, 8), (2, 0, 5)]}
#: the batch with room for the f32 scores of 1 or 2 rows: its attention
#: runs over groups of that many rows, and the rest last
EXTENDS.update({f"batch_by_{g}": EXTENDS["batch"] for g in (1, 2)})


def _extend_tokens(rows, seed=9):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(rows), 8), np.int32)
    for j, (_, _, n_valid) in enumerate(rows):
        tokens[j, :n_valid] = rng.integers(0, 96, n_valid)
    return tokens


def _extend_each(tparams, tcfg, tdt, cache, tables, rows, tokens):
    """One ``paged_chunk_extend`` a row, in order: (cache, (B, V) logits)."""
    logits = []
    for (r, start, n_valid), toks in zip(rows, tokens):
        cache, lg = tr.paged_chunk_extend(tparams, cache,
                                          torch.tensor(tables[r]),
                                          torch.tensor(toks), start, n_valid,
                                          tcfg, tdt)
        logits.append(lg)
    return cache, torch.stack(logits)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(EXTENDS))
def test_paged_chunk_extend(model, dt, case, monkeypatch):
    """Pad rows and rows past the table are not written; the returned
    last-row logits and the pool agree with JAX's one call a row, which
    attends over the whole table.  A batch of rows in one
    ``paged_chunk_extend_batch`` (each row's last position in the page of
    the batch's, so a row alone reads the pages the batch reads) writes
    the pool the port's one call a row writes, byte for byte, and gives
    each row's logits; those differ at most by the rounding of the head's
    GEMM, which the CPU's BLAS sums in another order for B rows than for
    one (a few float32 steps, or one bfloat16 step, of a logit).  With
    room for g rows' f32 scores the softmax sees groups of g rows, and
    the results are the same."""
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    pool, tables, _, _ = _paged_problem(jcfg, seed=9)
    rows = EXTENDS[case]
    tokens = _extend_tokens(rows)
    # "batch_by_<g>": room for the f32 scores of g rows
    g = int(case.rsplit("_", 1)[1]) if case.startswith("batch_by_") else 0
    seen, softmax = [], torch.softmax
    if g:
        S = tables.shape[1] * pool["k"].shape[2]
        monkeypatch.setattr(tr, "_ATTN_SCORES_BYTES",
                            g * tcfg.n_heads * tokens.shape[1] * S * 4)
    jc = {k: jnp.asarray(v, jdt) for k, v in pool.items()}
    jl = []
    for (r, start, n_valid), toks in zip(rows, tokens):
        jc, lg = jtr.paged_chunk_extend(
            jparams, jc, jnp.asarray(tables[r]), jnp.asarray(toks),
            jnp.asarray(start, jnp.int32), jnp.asarray(n_valid, jnp.int32),
            jcfg, jdt)
        jl.append(np.asarray(lg, np.float32))
    tcache = {k: torch.tensor(v).to(tdt) for k, v in pool.items()}
    each = {k: v.clone() for k, v in tcache.items()}

    def spy(x, *a, **kw):
        seen.append(x.shape[0])             # the rows of a group
        return softmax(x, *a, **kw)

    monkeypatch.setattr(torch, "softmax", spy)
    tc, tl = tr.paged_chunk_extend_batch(
        tparams, tcache, torch.tensor(tables[[r for r, _, _ in rows]]),
        torch.tensor(tokens), [start for _, start, _ in rows],
        [n_valid for _, _, n_valid in rows], tcfg, tdt)
    monkeypatch.setattr(torch, "softmax", softmax)
    groups = {0: [len(rows)], 1: [1, 1, 1], 2: [2, 1]}[g]
    assert seen == groups * tcfg.n_layers
    assert tc is tcache and tl.shape == (len(rows), tcfg.padded_vocab)
    _close(tl, np.stack(jl), tol)
    for k in ("k", "v"):
        _close(tc[k], jc[k], tol)
    each, el = _extend_each(tparams, tcfg, tdt, each, tables, rows, tokens)
    for k in ("k", "v"):
        assert torch.equal(tc[k], each[k]), k
    head_tol = 1e-6 if dt == "f32" else 2 ** -8
    torch.testing.assert_close(tl, el, rtol=head_tol, atol=head_tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_chunk_extend_batch_after_copy_on_write(model, dt):
    """Three slots of the paged pool hold one prompt of 10 tokens, its two
    full pages shared; slots 1 and 2 are cut back to 6 and 4 tokens, so
    their appends start in the shared page and ``prepare_append`` copies
    it for each.  Preparing every row and then one
    ``paged_chunk_extend_batch`` leaves the pool's tables and counters as
    preparing and extending one row at a time does, and its bytes and
    each row's logits to the rounding of sums over another extent."""
    from repro_torch.serving.kv_cache import PagedKVCachePool
    _, tdt, _ = DTYPES[dt]
    _, _, tcfg, tparams = model
    prompt = np.random.default_rng(3).integers(0, 96, 10).astype(np.int32)
    _, _aux, prefix = tr.forward(tparams, torch.tensor(prompt)[None], tcfg,
                                 tdt, collect_cache=True)
    # slot 0 appends in its private tail page and crosses into a fresh
    # one; slot 1 starts mid-page, slot 2 page-aligned, both in the
    # shared page, and both cross into their tails
    lengths, lens = (10, 6, 4), (3, 6, 8)
    tokens = _extend_tokens([(0, 0, n) for n in lens], seed=4)
    pools = []
    for _ in range(2):
        pool = PagedKVCachePool(tcfg, 3, 24, page_size=4, dtype=tdt,
                                device="cpu")
        for rid, length in enumerate(lengths):
            slot = pool.alloc(rid)
            pool.write_prefix(slot, prefix, len(prompt), tokens=prompt)
            pool.lengths[slot] = length
        pools.append(pool)
    batch, each = pools
    assert batch.metrics["pages_shared"] == 4     # two full pages, twice
    for slot, n in enumerate(lens):
        batch.prepare_append(slot, n)
    batch.cache, tl = tr.paged_chunk_extend_batch(
        tparams, batch.cache, torch.tensor(batch.block_tables()),
        torch.tensor(tokens), list(lengths), list(lens), tcfg, tdt)
    el = []
    for slot, n in enumerate(lens):
        each.prepare_append(slot, n)
        each.cache, lg = tr.paged_chunk_extend(
            tparams, each.cache, torch.tensor(each.block_tables()[slot]),
            torch.tensor(tokens[slot]), lengths[slot], n, tcfg, tdt)
        el.append(lg)
    assert batch.metrics["pages_cow"] == 2
    assert batch.metrics == each.metrics
    assert batch.page_tables == each.page_tables
    # a row alone attends up to the page of its own last position (5, 4
    # and 3 pages), the batch up to the batch's (5): the softmax and the
    # weighted sum add the masked tail's zeros in another order, so the
    # rows agree to a few float32 steps, or one bfloat16 step
    tol = 1e-6 if dt == "f32" else 2 ** -8
    for k in ("k", "v"):
        torch.testing.assert_close(batch.cache[k], each.cache[k], rtol=tol,
                                   atol=tol)
    torch.testing.assert_close(tl, torch.stack(el), rtol=tol, atol=tol)


def test_init_params_shapes_and_scales():
    """Torch-generated weights have ``tr.init_params``'s shapes, float32
    norms, and the fan-in scale of the truncated normal."""
    cfg = bridge.config_from_jax(dataclasses.asdict(_tiny()))
    params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16, device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: a.shape, jtr.abstract_params(_tiny()))
    tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                     params.tree())
    assert tshapes == jshapes
    layers = params["layers"]
    assert layers["ln1"].dtype == torch.float32
    assert layers["wq"].dtype == torch.bfloat16
    assert float(layers["wq"].float().abs().max()) <= 3.0 / np.sqrt(48) + 1e-2
    # the standard deviation of N(0, 1) cut at +-3 is 0.9866
    assert abs(float(layers["w_down"].float().std()) * np.sqrt(64)
               - 0.9866) < 0.05
    moe = tr.init_params(dataclasses.replace(cfg, moe=tr.MoEConfig(4, 2)),
                         torch.Generator().manual_seed(0), device="cpu")
    assert moe["layers"]["router"].shape == (2, 48, 4)
    assert moe["layers"]["w_up"].shape == (2, 4, 48, 64)


# ---------------------------------------------------------------------------
# The layer body's seam: every cache entry point against forward
# ---------------------------------------------------------------------------

#: (config fields, int8 weights) of the seam test's models; the MoE's
#: capacity factor E / top_k gives every expert room for every token, so
#: no entry point drops one whatever its chunk
SEAM_MODELS = {"swiglu": ({}, False), "relu2": ({"ffn_type": "relu2"}, False),
               "rope_half": ({"rotary_frac": 0.5}, False),
               "int8": ({}, True),
               "moe": ({"moe": tr.MoEConfig(4, 2, capacity_factor=2.0)},
                       False)}
#: two rows of 8 tokens; the paged pool's pages of 4, the rows' tables out
#: of order, page 2 unused
SEAM_S, SEAM_PAGE = 8, 4
SEAM_TABLES = torch.tensor([[3, 0], [4, 1]], dtype=torch.int32)


def _seam_pool(cfg):
    return tr.make_paged_cache(cfg, 5, SEAM_PAGE, torch.float32, device="cpu")


def _seam_view(pool):
    """The pool's K/V as (L, B, S, H_kv, D), through the tables."""
    return {k: v[:, SEAM_TABLES].flatten(2, 3) for k, v in pool.items()}


def _seam_decode_step(params, cfg, tokens):
    cache = tr.make_cache(cfg, 2, SEAM_S, torch.float32, device="cpu")
    outs = []
    for t in range(SEAM_S):
        pos = torch.full((2,), t, dtype=torch.int32)
        lg, cache = tr.decode_step(params, cache, tokens[:, t], pos, cfg,
                                   torch.float32)
        outs.append((pos, lg))
    return outs, cache


def _seam_chunk_extend(params, cfg, tokens):
    """Row b in two chunks, split at 3 and 5, each padded to 5 tokens."""
    cache = tr.make_cache(cfg, 2, SEAM_S, torch.float32, device="cpu")
    for b, split in enumerate((3, 5)):
        for start, end in ((0, split), (split, SEAM_S)):
            chunk = torch.zeros(5, dtype=tokens.dtype)
            chunk[:end - start] = tokens[b, start:end]
            cache = tr.chunk_extend(params, cache, b, chunk, start,
                                    end - start, cfg, torch.float32)
    return [], cache


def _seam_paged_decode_step(params, cfg, tokens):
    pool, outs = _seam_pool(cfg), []
    for t in range(SEAM_S):
        pos = torch.full((2,), t, dtype=torch.int32)
        lg, pool = tr.paged_decode_step(params, pool, tokens[:, t], pos,
                                        SEAM_TABLES, cfg, torch.float32)
        outs.append((pos, lg))
    return outs, _seam_view(pool)


def _seam_paged_chunk_extend_batch(params, cfg, tokens):
    """Both rows in two calls, row 0 split at 3 and row 1 at 5: each
    call's chunks start at another offset and page."""
    pool, outs = _seam_pool(cfg), []
    for starts, valid in (((0, 0), (3, 5)), ((3, 5), (5, 3))):
        chunks = torch.zeros(2, 5, dtype=tokens.dtype)
        for b, (s, n) in enumerate(zip(starts, valid)):
            chunks[b, :n] = tokens[b, s:s + n]
        pool, lg = tr.paged_chunk_extend_batch(
            params, pool, SEAM_TABLES, chunks, list(starts), list(valid),
            cfg, torch.float32)
        outs.append((torch.tensor(starts) + torch.tensor(valid) - 1, lg))
    return outs, _seam_view(pool)


SEAM_ENTRIES = {"decode_step": _seam_decode_step,
                "chunk_extend": _seam_chunk_extend,
                "paged_decode_step": _seam_paged_decode_step,
                "paged_chunk_extend_batch": _seam_paged_chunk_extend_batch}


@pytest.mark.parametrize("entry", sorted(SEAM_ENTRIES))
@pytest.mark.parametrize("variant", sorted(SEAM_MODELS))
def test_cache_entry_points_agree_with_forward(variant, entry):
    """Each cache entry point runs the layer body ``forward`` runs, with its
    own K/V writes and attention: fed the same tokens, it gives forward's
    logits at each position it returns and writes forward's collected K/V,
    at f32 to ``F32_TOL`` (the entry points sum attention over another
    extent and in another order)."""
    kw, int8 = SEAM_MODELS[variant]
    cfg = tr.TransformerConfig(name="seam", n_layers=2, d_model=48, n_heads=4,
                               n_kv_heads=2, d_head=16, d_ff=64,
                               vocab_size=96, **kw)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    if int8:
        params = tr.quantize_for_serving(params)
    tokens = torch.tensor(np.random.default_rng(10).integers(
        0, 96, (2, SEAM_S)), dtype=torch.int32)
    want, _, want_kv = tr.forward(params, tokens, cfg, torch.float32,
                                  collect_cache=True)
    outs, kv = SEAM_ENTRIES[entry](params, cfg, tokens)
    for pos, lg in outs:
        torch.testing.assert_close(lg, want[torch.arange(2), pos.long()],
                                   rtol=F32_TOL, atol=F32_TOL)
    for k in ("k", "v"):
        torch.testing.assert_close(kv[k], want_kv[k], rtol=F32_TOL,
                                   atol=F32_TOL)
