"""Port vs JAX: the pre-prefill stage executors on the CPU.

* Which executors an engine gets: the port's stage registry against the
  JAX one, for every combination of stage models and knobs.
* ``GreedyGenerator`` (rewrite and multi-query fan-out) against JAX's
  fused ``tr.greedy_generate`` program: equal tokens under the near-tie
  rule of ``tests/test_torch_engine.py`` (the third row of this input
  meets a bf16 near-tie at its third token).
* Rerank keeps equal scores in candidate order, as ``jnp.argsort`` does.
* The whole pipeline -- rewrite, multi-query fan-out, retrieval, rerank
  and the safety filter -- on both KV pools against the JAX ``"ref"``
  engine: retrieved ids and token streams under the near-tie rule of
  ``tests/test_torch_engine.py``, and the executors' outputs.  A flip in
  a rewrite or fan-out stream would change what is retrieved, so those
  streams are held equal; on this input they meet no bf16 near-tie (with
  more generated tokens some do, e.g. 4 rewrite and 3 fan-out tokens meet
  two ties of margin 2^-6 and 2^-5).
* Encoder ids past the embedding table: the port raises ``ValueError``
  where JAX's ``jnp.take`` gives NaN.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.stage_registry import REGISTRY
from repro.models import transformer as jtr
from repro.serving import executors as jex
from repro_torch.core.stage_registry import REGISTRY as TREGISTRY
from repro_torch.serving import engine as te
from repro_torch.serving import executors as tex
from repro_torch.serving.request import Request, State
from test_torch_engine import (_compare_streams, _port,  # noqa: F401
                               _same_up_to_near_tie, _serve_both, stack)

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


def _stub(cfg, **models):
    """An engine as far as the executor factories look at one (the port's
    also hand the engine's attention ops to the executors)."""
    return types.SimpleNamespace(cfg=cfg, gen=models.get("gen"),
                                 rewriter=models.get("rewriter"),
                                 reranker=models.get("reranker"),
                                 safety=models.get("safety"),
                                 seq_attn=None, dense_attn=None)


@pytest.mark.parametrize("models", [(), ("rewriter",), ("reranker",),
                                    ("safety",),
                                    ("rewriter", "reranker", "safety")])
@pytest.mark.parametrize("knobs", [{}, {"rewrite_tokens": 4, "rerank": True},
                                   {"fanout_queries": 3}],
                         ids=["default", "rewrite_rerank", "fanout"])
def test_factories_follow_the_registry(stack, models, knobs):
    gen, enc = stack[0], stack[1]
    jm = {"gen": gen, **{m: (gen if m == "rewriter" else enc)
                         for m in models}}
    tm = {k: _port(v) for k, v in jm.items()}
    want = REGISTRY.engine_executors(_stub(te.EngineConfig(**knobs), **jm))
    got = TREGISTRY.engine_executors(_stub(te.EngineConfig(**knobs), **tm))
    assert [e.name for e in got] == [e.name for e in want]
    mq = [e for e in got if e.name == "multi_query"]
    if mq:   # fan-out generates with the rewriter when there is one
        assert mq[0]._gen.comp is tm.get("rewriter", tm["gen"])


def test_greedy_generator_matches_jax(stack):
    gen = stack[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 9, 12)]
    want = jex.GreedyGenerator(gen)(prompts, 7)
    got = tex.GreedyGenerator(_port(gen))(prompts, 7)
    assert got.dtype == np.int32 and got.shape == (3, 7)
    for i, p in enumerate(prompts):
        _same_up_to_near_tie(stack, p, want[i], got[i], f"prompt {i}")


def test_rerank_keeps_ties_in_candidate_order(stack):
    """Duplicate documents score the same: both frameworks keep them in
    candidate order."""
    enc, corpus = stack[1], stack[2].copy()
    corpus[7] = corpus[3]
    corpus[9] = corpus[3]
    cand = np.asarray([9, 1, 3, 7, 2], np.int64)
    cfg = te.EngineConfig(retrieval_k=4)
    orders = []
    for ex, comp in ((jex.RerankExecutor, enc),
                     (tex.RerankExecutor, _port(enc))):
        req = Request(question=stack[3][0].copy())
        req.candidate_ids = cand.copy()
        ex(comp).run(types.SimpleNamespace(cfg=cfg, corpus=corpus,
                                           tracer=types.SimpleNamespace(
                                               enabled=False)), req)
        orders.append(list(req.candidate_ids))
    assert orders[0] == orders[1]
    assert [d for d in orders[1] if d in (3, 7, 9)] == \
        [d for d in cand if d in orders[1] and d in (3, 7, 9)]


FULL = {"rewrite_tokens": 3, "fanout_queries": 3, "fanout_tokens": 2,
        "rerank": True, "rerank_candidates": 5, "safety_threshold": 0.5}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_full_pipeline_matches_jax_ref(stack, paged):
    jeng, jreqs, teng, treqs = _serve_both(
        stack, stages=("rewriter", "reranker", "safety"), paged=paged,
        **FULL)
    names = ["rewrite", "multi_query", "retrieval", "rerank",
             "safety_filter"]
    assert [e.name for e in teng.executors] == names
    assert [e.name for e in jeng.executors] == names
    for i, (jr, trq) in enumerate(zip(jreqs, treqs)):
        n = len(jr.question)
        _same_up_to_near_tie(stack, jr.question, jr.rewritten[n:],
                             trq.rewritten[n:], f"request {i} rewrite")
        np.testing.assert_array_equal(trq.rewritten, jr.rewritten)
        assert len(trq.query_variants) == 3
        for a, b in zip(trq.query_variants, jr.query_variants):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(trq.safety_scores, jr.safety_scores,
                                   rtol=1e-5, atol=1e-5)
        assert State.REWRITING in trq.state_history
    _compare_streams(stack, jreqs, treqs)
    ts = teng.metrics_snapshot()
    assert all(ts["stage_time_s"][n] > 0 for n in names)
    # two database scans a request: the base query, then the variants
    assert ts["retrieved_queries"] == 3 * len(treqs)
    for r in treqs:       # the screen kept exactly the docs scoring >= 0.5
        assert len(r.retrieved_ids[0]) == sum(s >= 0.5
                                              for s in r.safety_scores)


def test_encoder_ids_past_the_table_raise(stack):
    gen, enc, corpus, _ = stack
    bad = np.full((1, 8), enc.cfg.padded_vocab + 3, np.int32)
    # JAX looks the id up as a row of NaN
    assert np.isnan(np.asarray(jtr.encode(enc.params, jnp.asarray(bad),
                                          enc.cfg))).all()
    ok = np.full((1, 8), enc.cfg.padded_vocab - 1, np.int32)   # a pad row
    assert np.isfinite(np.asarray(jtr.encode(enc.params, jnp.asarray(ok),
                                             enc.cfg))).all()
    eng = te.RAGEngine(_port(gen), _port(enc), corpus,
                       te.EngineConfig(decode_slots=2, s_max=64,
                                       max_new_tokens=4),
                       reranker=_port(enc), device="cpu")
    msg = f"token id {enc.cfg.padded_vocab + 3} .* {enc.cfg.padded_vocab} rows"
    with pytest.raises(ValueError, match=msg):
        eng.retrieve(bad, 2)
    assert torch.isfinite(eng._embed_batched(ok)).all()
    with pytest.raises(ValueError, match=msg):
        tex.Encoder(eng.reranker)(bad)
    req = Request(question=bad[0].copy())
    eng.queue.append(req)
    with pytest.raises(ValueError, match="padded_vocab"):
        eng.tick()
