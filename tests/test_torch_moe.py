"""Port vs JAX: the mixture-of-experts FFN and every serving entry point on
an MoE config, on the CPU.

The config is the reference's ``TINY_MOE`` (``tests/test_transformer.py``:
2 layers, d_model 64, 4 query / 2 KV heads, d_head 16, 8 experts of
d_ff 64, top-2, vocab 256); the weights are JAX ``tr.init_params``'s,
carried across with ``repro_torch.bridge``, and every input is drawn with
numpy from a seed.

Tolerances: float32 agrees to ``rtol = atol = 1e-5`` (the frameworks sum
matmuls in other orders).  bfloat16 rounds at the same places in both,
but a product can land on the other side of a rounding boundary: one
bf16 step is 2^-8 relative, so one FFN output of order one is held to
``MOE_BF16_TOL = 2e-2`` and two layers of residual stream to
``BF16_TOL = 6e-2`` (as in ``tests/test_torch_model.py``).  The experts
each token chooses and the capacity slots kept are compared exactly,
a router built to tie at the k-th expert included: ``jax.lax.top_k``
breaks ties by the lower index, and the port must too.
"""

import dataclasses
import sys
import warnings
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import topical_corpus
from repro.models import common as jcm
from repro.models import transformer as jtr
from repro.serving.engine import Component as JComponent
from repro_torch import bridge
from repro_torch.models import transformer as tr

from repro_torch.serving.request import State

from test_torch_engine import VOCAB, _serve_both

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
MOE_BF16_TOL = 2e-2
BF16_TOL = 6e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TINY_MOE = dict(name="tm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=64, vocab_size=256)


def _pair(moe=jtr.MoEConfig(n_experts=8, top_k=2), seed=0, **kw):
    jcfg = jtr.TransformerConfig(**TINY_MOE, moe=moe, **kw)
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def model():
    return _pair()


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(bridge.tensor_to_numpy(got),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _jax_choice(x, lp, cfg, jdt):
    """JAX's chosen experts and kept slots: the routing and slot steps of
    ``jtr.moe_ffn`` (src/repro/models/transformer.py:157-183)."""
    B, S, _ = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = max(1, int(np.ceil(S * k / E * cfg.moe.capacity_factor)))
    router = jcm.maybe_dequant(lp["router"], jdt)
    logits = jnp.einsum("bsd,de->bse", x.astype(jdt), router)
    gates = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(gates, k)
    eflat = eidx.reshape(B, S * k)
    onehot = jax.nn.one_hot(eflat, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos, eflat[..., None], axis=-1)[..., 0]
    return eidx, pos < C, gates


def _tied_router(router: np.ndarray) -> np.ndarray:
    """Even experts share router column 0 and odd ones column 1: every
    token's top four experts tie, across the top-k boundary too."""
    out = router.copy()
    for e in range(out.shape[-1]):
        out[..., e] = router[..., e % 2]
    return out


MOE_CASES = {
    # name: (MoEConfig, config overrides, tie the router)
    "top2": (jtr.MoEConfig(8, 2), {}, False),
    "drop": (jtr.MoEConfig(8, 2, capacity_factor=0.25), {}, False),
    "tie": (jtr.MoEConfig(8, 2), {}, True),
    "top1": (jtr.MoEConfig(8, 1), {}, False),
    "relu2": (jtr.MoEConfig(8, 2), {"ffn_type": "relu2"}, False),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_jax(case, dt):
    """y and aux equal within tolerance; the same experts chosen and the
    same slots kept (drops at capacity_factor 0.25, ties at the k-th
    expert, top-1 and a squared-ReLU MoE)."""
    jdt, tdt = DTYPES[dt]
    moe, kw, tie = MOE_CASES[case]
    jcfg, jparams, tcfg, _ = _pair(moe, seed=3, **kw)
    jlp = {k: np.asarray(v[0], np.float32)
           for k, v in jparams["layers"].items()}
    if tie:
        jlp["router"] = _tied_router(jlp["router"])
    tlp = {k: torch.tensor(v) for k, v in jlp.items()}
    x = np.random.default_rng(11).standard_normal((3, 10, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, jdt)
    jlp = {k: jnp.asarray(v) for k, v in jlp.items()}
    jy, jaux = jax.jit(jtr.moe_ffn, static_argnums=(2, 3))(jx, jlp, jcfg,
                                                           jdt)
    ty, taux = tr.moe_ffn(torch.tensor(x).to(tdt), tlp, tcfg, tdt)
    assert ty.dtype == tdt and ty.shape == x.shape
    tol = F32_TOL if dt == "f32" else MOE_BF16_TOL
    _close(ty, jy, tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=F32_TOL)

    jeidx, jkeep, gates = map(np.asarray, jax.jit(
        _jax_choice, static_argnums=(2, 3))(jx, jlp, jcfg, jdt))
    _, _, teidx, _ = tr.moe_route(torch.tensor(x).to(tdt), tlp, tcfg, tdt)
    B, S, k = teidx.shape
    C = max(1, int(np.ceil(S * k / 8 * moe.capacity_factor)))
    _, tkeep = tr.capacity_slots(teidx, 8, C)
    np.testing.assert_array_equal(teidx.numpy(), jeidx)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    if case == "drop":
        assert jkeep.mean() < 0.5           # the case drops most slots
    if tie:
        top = -np.sort(-gates, axis=-1)
        # every token ties at the k-th expert (k-th and next gate equal)
        assert (top[..., k - 1] == top[..., k]).all()


def test_stable_sort_breaks_ties_like_jax_top_k():
    """Three tied gates: torch.topk picks [2, 4], JAX and the port [1, 2]."""
    g = np.asarray([[.5, .9, .9, .1, .9, .2]], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(g), 2)
    tidx = torch.sort(torch.tensor(g), dim=-1, descending=True,
                      stable=True).indices[:, :2]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy(), [[1, 2]])


def test_moe_ffn_matches_tokenwise_version_at_decode(model):
    """At the decode shape (S = 1, nothing drops) the capacity dispatch
    equals ``chip_smoke.moe_tokenwise``, which gathers each token's k
    experts: the oracle the chip run holds the full-width model to."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    _, _, tcfg, tparams = model
    lp = tr.layer_params(tparams["layers"], 1)
    x = torch.tensor(np.random.default_rng(12).standard_normal(
        (8, 1, 64)).astype(np.float32))
    want = chip_smoke.moe_tokenwise(x, lp, tcfg, torch.float32)
    got, _ = tr.moe_ffn(x, lp, tcfg, torch.float32)
    _close(got, want.numpy(), F32_TOL)


# ---------------------------------------------------------------------------
# Params and counts
# ---------------------------------------------------------------------------

def test_init_params_shapes_and_counts():
    """MoE weights have ``tr.init_params``'s shapes (a relu2 MoE has no
    ``w_gate``); parameter counts equal JAX's, the full-width MoE configs
    of the registry included."""
    for kw in ({}, {"ffn_type": "relu2"}):
        jcfg = jtr.TransformerConfig(**TINY_MOE, moe=jtr.MoEConfig(8, 2),
                                     **kw)
        tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
        params = tr.init_params(tcfg, torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16, device="cpu")
        jshapes = jax.tree_util.tree_map(lambda a: a.shape,
                                         jtr.abstract_params(jcfg))
        tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                         params.tree())
        assert tshapes == jshapes
        layers = params["layers"]
        assert layers["w_up"].dtype == torch.bfloat16
        assert ("w_gate" in layers) == (kw == {})
        # the fan-in scale of a N(0, 1) cut at +-3 (std 0.9866)
        assert abs(float(layers["w_down"].float().std()) * np.sqrt(64)
                   - 0.9866) < 0.05
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        assert sum(t.numel() for t in params.buffers()) == \
            tcfg.param_count() + 2 * (tcfg.padded_vocab - 256) * 64
    from repro.configs import get_arch as jget_arch
    from repro_torch.configs import get_arch
    for arch_id in ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"):
        j, t = jget_arch(arch_id).config, get_arch(arch_id).config
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


# ---------------------------------------------------------------------------
# Entry points on the MoE config
# ---------------------------------------------------------------------------
#
# Past the first layer the two frameworks' bf16 hidden states differ by a
# bf16 step here and there, and the router rounds its logits to bf16, so
# ties and near-ties between experts are common: a token whose k-th and
# next expert sit within a step of each other can pick the other one, and
# then its row differs by far more than any tolerance.  The bf16 checks
# therefore record each MoE layer's routing on both sides (JAX's through
# an ordered ``jax.debug.callback`` from inside its layer scan) and hold
# a row whose routing differs to the near-tie rule of
# ``tests/test_torch_engine.py``: the first differing choice is reported,
# and JAX's log-gates of the two experts (their router logits) must lie
# within ``NEAR_TIE`` of each other.  Every other row must agree within
# tolerance.  In f32 the routing must be equal and every row agree.

NEAR_TIE = 4 * 2 ** -7   # a few bf16 steps of a logit of order one


@contextmanager
def _routing_log():
    """(JAX log, port log): each MoE layer call's chosen experts on both
    sides -- JAX's with its gates, recomputed by ``_jax_choice`` from the
    same inputs inside ``jtr.moe_ffn``."""
    jlog, tlog = [], []
    j_moe, t_route = jtr.moe_ffn, tr.moe_route

    def record(eidx, gates):
        jlog.append((np.asarray(eidx), np.asarray(gates)))

    def jax_moe(x, lp, cfg, compute_dtype=jnp.bfloat16):
        eidx, _, gates = _jax_choice(x, lp, cfg, compute_dtype)
        jax.debug.callback(record, eidx, gates, ordered=True)
        return j_moe(x, lp, cfg, compute_dtype)

    def port_route(x, lp, cfg, compute_dtype=torch.bfloat16):
        out = t_route(x, lp, cfg, compute_dtype)
        tlog.append(out[2].numpy())
        return out

    jtr.moe_ffn, tr.moe_route = jax_moe, port_route
    try:
        yield jlog, tlog
        jax.effects_barrier()
    finally:
        jtr.moe_ffn, tr.moe_route = j_moe, t_route


def _flipped_rows(jlog, tlog) -> dict:
    """Batch row -> (call, position, JAX's log-gate margin) of the row's
    first differing expert choice, over the aligned layer calls."""
    assert len(jlog) == len(tlog) > 0
    flips = {}
    for call, ((je, jg), te) in enumerate(zip(jlog, tlog)):
        assert je.shape == te.shape, (call, je.shape, te.shape)
        for b, s in np.argwhere((je != te).any(-1)):
            if b in flips:
                continue
            c = int(np.argmax(je[b, s] != te[b, s]))
            g = jg[b, s]
            flips[int(b)] = (call, int(s), float(abs(
                np.log(g[je[b, s, c]]) - np.log(g[te[b, s, c]]))))
    return flips


def _agree(pairs, logs, dt, label="") -> None:
    """``pairs``: (port tensor, JAX array, batch axis).  f32: equal routing
    and every row within F32_TOL.  bf16: rows whose routing differs are
    held to the near-tie rule (reported), the others to BF16_TOL."""
    flips = _flipped_rows(*logs)
    if dt == "f32":
        assert not flips, f"{label}: f32 routing differs: {flips}"
    for row, (call, pos, margin) in flips.items():
        msg = (f"{label}: row {row} picks another expert at layer call "
               f"{call}, position {pos}; JAX's log-gate margin {margin}")
        print(msg)
        assert margin <= NEAR_TIE, "not a near-tie: " + msg
        warnings.warn("bf16 near-tie expert flip: " + msg)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    for got, want, axis in pairs:
        keep = [b for b in range(got.shape[axis]) if b not in flips]
        _close(got.index_select(axis, torch.tensor(keep, dtype=torch.long)),
               np.take(np.asarray(want, np.float32), keep, axis=axis), tol)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_forward_logits_and_aux(model, dt):
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    tokens = _tokens((3, 12), 4)
    with _routing_log() as logs:
        jl, jaux = jtr.forward(jparams, jnp.asarray(tokens), jcfg, jdt)
        tl, taux = tr.forward(tparams, torch.tensor(tokens), tcfg, tdt)
    _agree([(tl, jl, 0)], logs, dt, "forward")
    # aux averages f32 gates of the router's logits: a bf16 logit a step
    # off moves it by less than a step (2^-8) relative
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=F32_TOL if dt == "f32" else 2 ** -8)
    assert float(taux) > 0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_pads_the_cache(model, dt):
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    tokens = _tokens((3, 9), 5)
    with _routing_log() as logs:
        jl, jc = jtr.prefill(jparams, jnp.asarray(tokens), jcfg,
                             cache_len=16, compute_dtype=jdt)
        tl, tc = tr.prefill(tparams, torch.tensor(tokens), tcfg,
                            cache_len=16, compute_dtype=tdt)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape == (2, 3, 16, 2, 16)
        assert not tc[k][:, :, 9:].any()
    _agree([(tl, jl, 0), (tc["k"], jc["k"], 1), (tc["v"], jc["v"], 1)],
           logs, dt, "prefill")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_step(model, dt):
    """A prefilled dense cache, one step for rows at different positions."""
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    tokens = _tokens((3, 7), 6)
    token = np.asarray([3, 200, 17], np.int32)
    pos = np.asarray([7, 4, 2], np.int32)
    with _routing_log() as logs:
        _, jc = jtr.prefill(jparams, jnp.asarray(tokens), jcfg,
                            cache_len=12, compute_dtype=jdt)
        _, tc = tr.prefill(tparams, torch.tensor(tokens), tcfg,
                           cache_len=12, compute_dtype=tdt)
        jl, jc = jtr.decode_step(jparams, jc, jnp.asarray(token),
                                 jnp.asarray(pos), jcfg, jdt)
        tl, tc = tr.decode_step(tparams, tc, torch.tensor(token),
                                torch.tensor(pos), tcfg, tdt)
    _agree([(tl, jl, 0), (tc["k"], jc["k"], 1), (tc["v"], jc["v"], 1)],
           logs, dt, "decode_step")


def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    page, m, b = 4, 3, 3
    pool = {k: rng.standard_normal((cfg.n_layers, b * m + 1, page,
                                    cfg.n_kv_heads, cfg.d_head)).astype(
                                        np.float32) for k in ("k", "v")}
    tables = rng.permutation(b * m).reshape(b, m).astype(np.int32)
    return pool, tables


def _by_row(pool, tables):
    """Each table row's pages of a pool (L, P, page, H, D) -> (L, B, M,
    page, H, D), so a row's K/V is compared with its routing."""
    return pool[:, torch.as_tensor(tables, dtype=torch.long)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_paged_decode_step(model, dt):
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    pool, tables = _pool(jcfg, 7)
    token = np.asarray([3, 5, 7], np.int32)
    pos = np.asarray([6, 0, 11], np.int32)
    mask = np.asarray([True, False, True])
    with _routing_log() as logs:
        jl, jc = jtr.paged_decode_step(
            jparams, {k: jnp.asarray(v, jdt) for k, v in pool.items()},
            jnp.asarray(token), jnp.asarray(pos), jnp.asarray(tables), jcfg,
            jdt, write_mask=jnp.asarray(mask))
        tl, tc = tr.paged_decode_step(
            tparams, {k: torch.tensor(v).to(tdt) for k, v in pool.items()},
            torch.tensor(token), torch.tensor(pos), torch.tensor(tables),
            tcfg, tdt, write_mask=torch.tensor(mask))
    pairs = [(tl, jl, 0)]
    for k in ("k", "v"):
        pairs.append((_by_row(tc[k], tables),
                      bridge.tensor_to_numpy(_by_row(
                          torch.tensor(np.asarray(jc[k], np.float32)),
                          tables)), 1))
    _agree(pairs, logs, dt, "paged_decode_step")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_paged_chunk_extend(model, dt, monkeypatch):
    """A chunk padded to 8 with 5 real tokens: C comes from the padded
    length on both sides.  The same chunk with two more rows in one
    ``paged_chunk_extend_batch``: the capacity dispatch is a row's own,
    so each row's slice of the batch's routing is the experts of its
    one-row call, and the pool's bytes equal the one-row calls'; the
    logits differ at most by the head's GEMM over 3 rows, which the CPU's
    BLAS sums in another order than over one (a few float32 steps, or one
    bfloat16 step, of a logit)."""
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    pool, tables = _pool(jcfg, 8)
    tokens = np.zeros(8, np.int32)
    tokens[:5] = _tokens(5, 8)
    with _routing_log() as logs:
        jc, jl = jtr.paged_chunk_extend(
            jparams, {k: jnp.asarray(v, jdt) for k, v in pool.items()},
            jnp.asarray(tables[0]), jnp.asarray(tokens),
            jnp.asarray(3, jnp.int32), jnp.asarray(5, jnp.int32), jcfg, jdt)
        tc, tl = tr.paged_chunk_extend(
            tparams, {k: torch.tensor(v).to(tdt) for k, v in pool.items()},
            torch.tensor(tables[0]), torch.tensor(tokens), 3, 5, tcfg, tdt)
    pairs = [(tl[None], np.asarray(jl, np.float32)[None], 0)]
    for k in ("k", "v"):
        pairs.append((tc[k][:, None], np.asarray(jc[k], np.float32)[:, None],
                      1))
    _agree(pairs, logs, dt, "paged_chunk_extend")

    rows = [(0, 3, 5), (1, 6, 2), (2, 9, 8)]       # (table row, start, n)
    chunks = np.zeros((3, 8), np.int32)
    chunks[0] = tokens
    chunks[1, :2], chunks[2] = _tokens(2, 9), _tokens(8, 10)
    routes, route = [], tr.moe_route

    def logged(*a, **kw):
        out = route(*a, **kw)
        routes.append(out[2])
        return out

    monkeypatch.setattr(tr, "moe_route", logged)
    batch = {k: torch.tensor(v).to(tdt) for k, v in pool.items()}
    each = {k: v.clone() for k, v in batch.items()}
    batch, bl = tr.paged_chunk_extend_batch(
        tparams, batch, torch.tensor(tables[:3]), torch.tensor(chunks),
        [start for _, start, _ in rows], [n for _, _, n in rows], tcfg, tdt)
    # one (3, 8, k) a layer; then a row's (1, 8, k) a layer, row by row
    by_layer = routes[:]
    routes.clear()
    el = []
    for (r, start, n), chunk in zip(rows, chunks):
        each, lg = tr.paged_chunk_extend(
            tparams, each, torch.tensor(tables[r]), torch.tensor(chunk),
            start, n, tcfg, tdt)
        el.append(lg)
    L = tcfg.n_layers
    assert len(by_layer) == L and len(routes) == 3 * L
    for layer in range(L):
        for b in range(3):
            assert torch.equal(by_layer[layer][b:b + 1],
                               routes[b * L + layer]), (layer, b)
    for k in ("k", "v"):
        assert torch.equal(batch[k], each[k]), k
    head_tol = 1e-6 if dt == "f32" else 2 ** -8
    torch.testing.assert_close(bl, torch.stack(el), rtol=head_tol,
                               atol=head_tol)


def test_greedy_generate(model):
    """Right-padded prompts of three lengths: equal tokens and routing in
    f32.  (In bf16 a greedy token can also flip at a near-tie of the
    final logits, after which the row's inputs differ: the engine test
    below holds bf16 streams to both near-tie rules.)"""
    jdt, tdt, dt = jnp.float32, torch.float32, "f32"
    jcfg, jparams, tcfg, tparams = model
    tokens = _tokens((3, 8), 9)
    lengths = np.asarray([8, 3, 5], np.int32)
    for row, n in enumerate(lengths):
        tokens[row, n:] = 0
    with _routing_log() as logs:
        want = jtr.greedy_generate(jparams, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jcfg, 6, jdt)
        got = tr.greedy_generate(tparams, torch.tensor(tokens),
                                 torch.tensor(lengths), tcfg, 6, tdt)
    # JAX's scan runs one more decode step than the port, whose token it
    # drops: its last routing record has no counterpart
    jlog, tlog = logs
    del jlog[len(tlog):]
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    _agree([(got.float(), np.asarray(want, np.float32), 0)], logs, dt,
           "greedy_generate")


# ---------------------------------------------------------------------------
# The engine with an MoE generator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_stack():
    """test_torch_engine's stack with a tiny MoE generator (its widths,
    8 experts top-2) in place of the dense one."""
    gcfg = jtr.TransformerConfig(name="pa-moe", n_layers=2, d_model=48,
                                 n_heads=4, n_kv_heads=2, d_head=16,
                                 d_ff=64, vocab_size=VOCAB,
                                 moe=jtr.MoEConfig(8, 2))
    ecfg = jtr.TransformerConfig(name="pa1", n_layers=2, d_model=32,
                                 n_heads=4, n_kv_heads=2, d_head=16,
                                 d_ff=64, vocab_size=VOCAB, causal=False)
    gen = JComponent(gcfg, jtr.init_params(jax.random.PRNGKey(0), gcfg))
    enc = JComponent(ecfg, jtr.init_params(jax.random.PRNGKey(1), ecfg))
    corpus, _, make_q = topical_corpus(48, 10, VOCAB, n_topics=4)
    questions = [make_q(i % 4) for i in range(5)]
    return gen, enc, corpus, questions


@contextmanager
def _engine_log():
    """(JAX events, port events) in call order: ``("route", experts,
    JAX's gates)`` for each MoE layer call, ``("logits", (..., V))`` for
    each generator call whose logits the engine reads (prefill forward,
    chunk extend, paged decode step)."""
    jlog, tlog = [], []
    j_fns = {n: getattr(jtr, n) for n in
             ("moe_ffn", "forward", "paged_chunk_extend",
              "paged_decode_step")}
    t_fns = {n: getattr(tr, n) for n in
             ("moe_route", "forward", "paged_chunk_extend_batch",
              "paged_decode_step")}

    def jlogits(lg):
        jax.debug.callback(lambda a: jlog.append(("logits", np.asarray(
            a, np.float32))), lg, ordered=True)

    def j_moe(x, lp, cfg, compute_dtype=jnp.bfloat16):
        eidx, _, gates = _jax_choice(x, lp, cfg, compute_dtype)
        jax.debug.callback(lambda e, g: jlog.append(
            ("route", np.asarray(e), np.asarray(g))), eidx, gates,
            ordered=True)
        return j_fns["moe_ffn"](x, lp, cfg, compute_dtype)

    def j_forward(*a, **kw):
        out = j_fns["forward"](*a, **kw)
        if not kw.get("return_hidden"):
            jlogits(out[0])
        return out

    def j_extend(*a, **kw):
        cache, lg = j_fns["paged_chunk_extend"](*a, **kw)
        jlogits(lg)
        return cache, lg

    def j_decode(*a, **kw):
        lg, cache = j_fns["paged_decode_step"](*a, **kw)
        jlogits(lg)
        return lg, cache

    def t_route(x, lp, cfg, compute_dtype=torch.bfloat16):
        out = t_fns["moe_route"](x, lp, cfg, compute_dtype)
        tlog.append(("route", out[2].numpy()))
        return out

    def t_forward(*a, **kw):
        out = t_fns["forward"](*a, **kw)
        if not kw.get("return_hidden"):
            tlog.append(("logits", bridge.tensor_to_numpy(out[0])))
        return out

    def t_extend(*a, **kw):
        # the engine extends through the batched entry: a row an event
        cache, lg = t_fns["paged_chunk_extend_batch"](*a, **kw)
        tlog.extend(("logits", bridge.tensor_to_numpy(row)) for row in lg)
        return cache, lg

    def t_decode(*a, **kw):
        lg, cache = t_fns["paged_decode_step"](*a, **kw)
        tlog.append(("logits", bridge.tensor_to_numpy(lg)))
        return lg, cache

    patches = [(jtr, "moe_ffn", j_moe), (jtr, "forward", j_forward),
               (jtr, "paged_chunk_extend", j_extend),
               (jtr, "paged_decode_step", j_decode),
               (tr, "moe_route", t_route), (tr, "forward", t_forward),
               (tr, "paged_chunk_extend_batch", t_extend),
               (tr, "paged_decode_step", t_decode)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield jlog, tlog
        jax.effects_barrier()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _first_divergence(jlog, tlog):
    """The first event at which the two engines differ -- a routing
    choice, or a greedy token (the argmax of logits the engine reads) --
    with JAX's margin there: its log-gate gap between the two experts, or
    its top-2 logit gap and the largest logit difference of that row.
    None when the engines agree throughout."""
    assert len(jlog) == len(tlog) > 0
    for i, (jev, tev) in enumerate(zip(jlog, tlog)):
        assert jev[0] == tev[0] and jev[1].shape == tev[1].shape, i
        if jev[0] == "route":
            je, te, g = jev[1], tev[1], jev[2]
            bad = np.argwhere(je != te)
            if len(bad):
                b, s, c = bad[0]
                return {"event": i, "kind": "route", "margin": float(abs(
                    np.log(g[b, s, je[b, s, c]])
                    - np.log(g[b, s, te[b, s, c]])))}
        else:
            jl = jev[1][..., :VOCAB].reshape(-1, VOCAB)
            tl = tev[1][..., :VOCAB].reshape(-1, VOCAB)
            bad = np.argwhere(jl.argmax(-1) != tl.argmax(-1))
            if len(bad):
                row = int(bad[0][0])
                top2 = np.sort(jl[row])[-2:]
                return {"event": i, "kind": "token",
                        "margin": float(top2[1] - top2[0]),
                        "logits_max_diff": float(
                            np.abs(jl[row] - tl[row]).max())}
    return None


@pytest.mark.parametrize("preset", ["exact", "prefill_chunk"])
def test_engine_with_moe_generator_matches_jax_ref(moe_stack, preset):
    """Bucketed prefill (C from the bucket), or chunked prefill through
    ``paged_chunk_extend``, then paged decode: the JAX ``"ref"`` engine's
    retrievals and greedy tokens.  Both engines run the same schedule, so
    their generator calls align; where they first differ -- an expert
    choice or a greedy token -- it must be a near-tie in JAX's own
    numbers (reported), and the token streams may differ only after it."""
    kw = {"prefill_chunk": 8} if preset == "prefill_chunk" else {}
    with _engine_log() as logs:
        jeng, jreqs, teng, treqs = _serve_both(moe_stack, **kw)
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    for key in ("decode_steps", "prefills", "append_compiles",
                "prefill_compiles"):
        assert ts[key] == js[key], key
    for i, (jr, trq) in enumerate(zip(jreqs, treqs)):
        assert trq.state is State.DONE
        assert trq.retrieved_ids == jr.retrieved_ids, f"request {i}"
    same = [trq.output == jr.output for jr, trq in zip(jreqs, treqs)]
    first = _first_divergence(*logs)
    if first is None:
        assert all(same)
        return
    msg = (f"engine ({preset}): first divergence {first}; equal streams "
           f"{same}")
    print(msg)
    assert first["margin"] <= NEAR_TIE, "not a near-tie: " + msg
    if first["kind"] == "token":
        assert first["logits_max_diff"] <= BF16_TOL, msg
    # a near-tie is a rare event: most streams stay equal
    assert sum(same) * 2 > len(same), msg
    warnings.warn("bf16 near-tie: " + msg)
