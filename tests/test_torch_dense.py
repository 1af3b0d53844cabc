"""Port vs JAX: the dense slot pool and its model entry points on the CPU.

* ``make_cache`` / ``decode_step`` / ``chunk_extend`` / ``greedy_generate``
  against ``repro.models.transformer`` on the tiny config of
  ``tests/test_torch_model.py`` (f32 to ``1e-5``, bf16 to ``BF16_TOL``).
* The fused dense step: JAX writes every row and merges the old cache
  back into the rows that are not stepping; the port writes only the
  stepping rows.  Every byte the step leaves alone, and the first
  layer's written rows, equal JAX's post-merge cache bit for bit; the
  port's masked write is bit-equal to the merge applied to its own
  unmasked step; the later layers' written rows agree with JAX's to the
  bf16 tolerance.  They cannot agree to the bit: the first layer's FFN
  feeds them, and JAX's bf16 SiLU (XLA's logistic) rounds differently
  from torch's in about 40% of values, by one bf16 step.
* ``KVCachePool`` against the JAX dense pool: same bytes, checksums and
  handoff sizes; the export/import round trip is bit-exact.
* The engine on the dense pool against the JAX ``attn_impl="ref"`` engine
  (retrieved ids and tokens under the near-tie rule of
  ``tests/test_torch_engine.py``, and its counters), and against the
  port's own paged engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro.serving import kv_cache as jkv
from repro.serving.engine import RAGEngine as JRAGEngine
from repro_torch import bridge
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as te
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.request import Request
from test_torch_engine import _compare_streams, _port, _serve_both, stack  # noqa: F401

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 6e-2          # see tests/test_torch_model.py
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
L, B, S, H_KV, D = 2, 4, 16, 2, 16


@pytest.fixture(scope="module")
def model():
    jcfg = jtr.TransformerConfig(name="tiny", n_layers=L, d_model=48,
                                 n_heads=4, n_kv_heads=H_KV, d_head=D,
                                 d_ff=64, vocab_size=96)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(bridge.tensor_to_numpy(got),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return tkv.to_host(a).view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _cache(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((L, B, S, H_KV, D)).astype(np.float32)
            for k in ("k", "v")}


def test_make_cache_matches_jax():
    cfg = tr.TransformerConfig(name="c", n_layers=L, d_model=32, n_heads=4,
                               n_kv_heads=H_KV, d_head=D, d_ff=64,
                               vocab_size=64)
    got = tr.make_cache(cfg, B, S, device="cpu")
    want = jtr.make_cache(jtr.TransformerConfig(**dataclasses.asdict(cfg)),
                          B, S)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16 and not got[k].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_step_matches_jax(model, dt):
    """Row 1 sits at pos == S_max: JAX drops its write, the port skips it;
    it still attends over the whole cache."""
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    cache = _cache(1)
    token = np.asarray([3, 5, 7, 90], np.int32)
    pos = np.asarray([6, S, 0, 11], np.int32)
    jl, jc = jtr.decode_step(
        jparams, {k: jnp.asarray(v, jdt) for k, v in cache.items()},
        jnp.asarray(token), jnp.asarray(pos), jcfg, jdt)
    tcache = {k: torch.tensor(v).to(tdt) for k, v in cache.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    tl, tc = tr.decode_step(tparams, tcache, torch.tensor(token),
                            torch.tensor(pos), tcfg, tdt)
    assert tc is tcache                       # the port updates in place
    _close(tl, jl, tol)
    for k in ("k", "v"):
        _close(tc[k], jc[k], tol)
        assert torch.equal(tc[k][:, 1], before[k][:, 1])
    # exactly one row per layer and stepping sequence changed
    changed = (tc["k"] != before["k"]).any(dim=(3, 4))
    assert int(changed.sum()) == L * 3


def test_decode_step_kernel_plain_version_agrees(model):
    """``attn_impl`` with the dense kernel's wrapper (its plain version on
    the CPU) gives the default path's logits in f32."""
    _, _, tcfg, tparams = model
    cache = _cache(2)
    token = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    pos = torch.tensor([0, 5, 15, 9], dtype=torch.int32)
    outs = []
    for attn in (None, decode_attention):
        c = {k: torch.tensor(v) for k, v in cache.items()}
        lg, _ = tr.decode_step(tparams, c, token, pos, tcfg, torch.float32,
                               attn_impl=attn)
        outs.append(lg.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=F32_TOL, atol=F32_TOL)


def test_masked_fused_step_cache_equals_jax_merge(model):
    """One fused dense step of the engine with slot 2 not stepping."""
    jcfg, jparams, tcfg, tparams = model
    cache = _cache(3)
    token = np.asarray([4, 8, 15, 16], np.int32)
    pos = np.asarray([3, S - 1, 7, 0], np.int32)
    mask = np.asarray([True, True, False, True])
    jtok, jmerged = JRAGEngine._fused_decode(
        jparams, {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()},
        jnp.asarray(token), jnp.asarray(pos), jnp.asarray(mask), cfg=jcfg)
    start = {k: torch.tensor(v).to(torch.bfloat16) for k, v in cache.items()}
    masked = {k: v.clone() for k, v in start.items()}
    lg, _ = tr.decode_step(tparams, masked, torch.tensor(token),
                           torch.tensor(pos), tcfg,
                           write_mask=torch.tensor(mask))
    full = {k: v.clone() for k, v in start.items()}
    tr.decode_step(tparams, full, torch.tensor(token), torch.tensor(pos),
                   tcfg)
    step = torch.tensor(mask)[None, :, None, None, None]
    written = np.zeros((L, B, S), bool)
    written[:, mask, pos[mask]] = True
    for k in ("k", "v"):
        # JAX's merge applied to the port's own unmasked step
        assert torch.equal(masked[k], torch.where(step, full[k], start[k]))
        got, want = _bits(masked[k]), _bits(jmerged[k])
        np.testing.assert_array_equal(got[~written], want[~written])
        np.testing.assert_array_equal(got[0], want[0])
        _close(masked[k][torch.tensor(written)],
               np.asarray(jmerged[k], np.float32)[written], BF16_TOL)
    toks = torch.argmax(lg[:, :jcfg.vocab_size], -1).numpy()
    np.testing.assert_array_equal(toks[mask], np.asarray(jtok)[mask])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("start,n_valid", [(5, 6), (11, 8)],
                         ids=["inside", "past_s_max"])
def test_chunk_extend_matches_jax(model, dt, start, n_valid):
    """Pad rows and rows past S_max are not written; the slot's cache and
    every other slot agree with JAX."""
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    cache = _cache(4)
    tokens = np.zeros(8, np.int32)
    tokens[:n_valid] = np.random.default_rng(4).integers(0, 96, n_valid)
    jc = jtr.chunk_extend(
        jparams, {k: jnp.asarray(v, jdt) for k, v in cache.items()},
        jnp.asarray(2, jnp.int32), jnp.asarray(tokens),
        jnp.asarray(start, jnp.int32), jnp.asarray(n_valid, jnp.int32),
        jcfg, jdt)
    tcache = {k: torch.tensor(v).to(tdt) for k, v in cache.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    tc = tr.chunk_extend(tparams, tcache, 2, torch.tensor(tokens), start,
                         n_valid, tcfg, tdt)
    for k in ("k", "v"):
        _close(tc[k], jc[k], tol)
        others = [0, 1, 3]
        assert torch.equal(tc[k][:, others], before[k][:, others])
        n_rows = min(n_valid, S - start)
        assert torch.equal(tc[k][:, 2, :start], before[k][:, 2, :start])
        assert torch.equal(tc[k][:, 2, start + n_rows:],
                           before[k][:, 2, start + n_rows:])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_greedy_generate_matches_jax(model, dt):
    """Right-padded prompts of three lengths: equal tokens."""
    jdt, tdt, _ = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 96, (3, 8)).astype(np.int32)
    lengths = np.asarray([8, 3, 5], np.int32)
    for row, n in enumerate(lengths):
        tokens[row, n:] = 0
    want = jtr.greedy_generate(jparams, jnp.asarray(tokens),
                               jnp.asarray(lengths), jcfg, 6, jdt)
    got = tr.greedy_generate(tparams, torch.tensor(tokens),
                             torch.tensor(lengths), tcfg, 6, tdt)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tr.greedy_generate(tparams, torch.tensor(tokens),
                              torch.tensor(lengths), tcfg, 0).shape == (3, 0)


def _prefill(p, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((L, 1, p, H_KV, D)).astype(
        ml_dtypes.bfloat16) for k in ("k", "v")}


def test_dense_pool_matches_jax_and_round_trips():
    fields = dict(name="pool", n_layers=L, d_model=32, n_heads=4,
                  n_kv_heads=H_KV, d_head=D, d_ff=64, vocab_size=64)
    jp = jkv.KVCachePool(jtr.TransformerConfig(**fields), 3, S)
    tp = tkv.KVCachePool(tr.TransformerConfig(**fields), 3, S, device="cpu")
    pre = _prefill(11, seed=0)
    js, ts = jp.alloc(7), tp.alloc(7)
    assert js == ts
    jp.write_prefix(js, {k: jnp.asarray(v) for k, v in pre.items()}, 11)
    tp.write_prefix(ts, {k: bridge.tensor_from_numpy(v)
                         for k, v in pre.items()}, 11)
    jp.advance([js])
    tp.advance([ts])
    np.testing.assert_array_equal(tp.positions().numpy(),
                                  np.asarray(jp.positions()))
    for k in ("k", "v"):
        np.testing.assert_array_equal(_bits(tp.cache[k]), _bits(jp.cache[k]))
    (jpre, jlen), (tpre, tlen) = jp.export_slot(js), tp.export_slot(ts)
    assert jlen == tlen == 12
    assert jkv.payload_checksum(jpre) == tkv.payload_checksum(tpre)
    assert jp.handoff_bytes(jpre) == tp.handoff_bytes(tpre)
    assert tkv.payload_summary(tpre, tlen) == jkv.payload_summary(jpre, jlen)
    # bit-exact round trip into another slot, from either payload
    for payload in (tpre, jpre):
        slot = tp.alloc(8)
        stats = tp.import_slot(slot, payload, tlen)
        assert tuple(stats) == (tp.handoff_bytes(tpre), 0, 0)
        for k in ("k", "v"):
            assert torch.equal(tp.cache[k][:, slot], tp.cache[k][:, ts])
        tp.release(slot)
        assert not tp.cache["k"][:, slot].any()     # release zeroes in place
    with pytest.raises(ValueError, match="s_max"):
        tp.import_slot(tp.alloc(9), tpre, S + 1)
    tp.lengths[ts] = S
    with pytest.raises(AssertionError, match="s_max"):
        tp.advance([ts])


# ---------------------------------------------------------------------------
# The engine on the dense pool
# ---------------------------------------------------------------------------

COUNTERS = ("decode_steps", "idle_slot_steps", "prefills",
            "retrieved_queries", "retrieval_batches", "host_syncs",
            "decode_host_syncs", "capacity_stops", "prefill_compiles",
            "append_compiles", "cache_copy_bytes")

DENSE = {
    "exact": {"paged": False},
    "ivfpq": {"paged": False, "retrieval_backend": "ivfpq", "nprobe": 4},
    "iterative": {"paged": False, "iterative_interval": 3,
                  "retrieval_batch": 2, "max_new_tokens": 9},
    "unfused": {"fused_decode": False},
}


@pytest.mark.parametrize("preset", sorted(DENSE))
def test_dense_engine_matches_jax_ref(stack, preset):
    jeng, jreqs, teng, treqs = _serve_both(stack, **DENSE[preset])
    assert isinstance(teng.pool, tkv.KVCachePool)
    _compare_streams(stack, jreqs, treqs)
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert ts["attn_impl"] == "ref"
    for key in COUNTERS:
        assert ts[key] == js[key], key
    assert set(ts["stage_time_s"]) == set(js["stage_time_s"])
    assert (ts["cache_copy_bytes"] > 0) == (preset == "unfused")
    assert "pages_allocated" not in ts


def test_paged_and_dense_engines_give_the_same_tokens(stack):
    """The port's two pools, with the kernels' wrappers as attention (their
    plain versions on the CPU), through iterative retrieval."""
    gen, enc, corpus, questions = stack
    outs = []
    for paged in (True, False):
        eng = te.RAGEngine(_port(gen), _port(enc), corpus,
                           te.EngineConfig(decode_slots=3, s_max=96,
                                           max_new_tokens=7, paged=paged,
                                           iterative_interval=3,
                                           attn_impl="cuda"), device="cpu")
        reqs = [Request(question=q.copy()) for q in questions]
        eng.serve(reqs)
        outs.append([(r.output, r.retrieved_ids) for r in reqs])
    assert outs[0] == outs[1]
