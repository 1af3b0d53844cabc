"""The port's engine and server on the CPU, without the JAX package: the
open-loop front-end (submission, streaming, deadlines, step budgets,
replay, summary), the engine's health and drain API, and the parts of
the engine that raised until they were ported (the dense slot pool, the
unfused decode, the rewrite / multi-query / rerank / safety stages),
which now each serve a request.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import topical_corpus
from repro_torch.models import transformer as tr
from repro_torch.serving.engine import (Component, EngineConfig, RAGEngine,
                                        bucket_len)
from repro_torch.serving.faults import (LEGAL_HEALTH_TRANSITIONS,
                                        EngineCrash, EngineHealth)
from repro_torch.serving.kv_cache import KVCachePool
from repro_torch.serving.request import Request, State
from repro_torch.serving.server import (RAGServer, RequestStalledError,
                                        percentiles, poisson_offsets)

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

VOCAB = 64


def _component(seed, causal=True, d=32):
    cfg = tr.TransformerConfig(name=f"s{seed}", n_layers=1, d_model=d,
                               n_heads=2, n_kv_heads=1, d_head=16, d_ff=32,
                               vocab_size=VOCAB, causal=causal)
    return Component(cfg, tr.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))


@pytest.fixture(scope="module")
def parts():
    corpus, _, make_q = topical_corpus(24, 8, VOCAB, n_topics=4)
    return (_component(0), _component(1, causal=False), corpus,
            [make_q(i % 4) for i in range(6)])


def _engine(parts, **kw):
    gen, enc, corpus, _ = parts
    cfg = EngineConfig(**{"decode_slots": 2, "s_max": 64,
                          "max_new_tokens": 5, **kw})
    return RAGEngine(gen, enc, corpus, cfg, device="cpu")


def test_stream_and_summary(parts):
    server = RAGServer(_engine(parts))
    seen = []
    handles = [server.submit(q, on_token=lambda h, t: seen.append(t))
               for q in parts[3]]
    first = list(handles[0].tokens())
    assert first == handles[0].output and len(first) == 5
    server.run_until_idle()
    assert all(h.state is State.DONE and len(h.output) == 5
               for h in handles)
    assert len(seen) == 5 * len(handles)
    assert handles[1].result() is handles[1].request
    s = server.summary()
    assert s["n_done"] == len(handles) and s["n_expired"] == 0
    assert s["ttft_s"] > 0 and s["tpot_s"] > 0 and s["qps"] > 0
    assert {"ttft_p50_s", "ttft_p99_s", "tpot_p95_s"} <= set(s)
    assert s["hist"]["ttft_s"]["count"] == len(handles)
    later = server.summary(window_s=1.0, now=time.monotonic() + 1e6)
    assert later["n_done"] == 0 and later["offered_qps"] == 0.0
    assert not server.step()                    # idle: nothing dispatched


def test_serve_equals_server_and_is_deterministic(parts):
    outs = []
    for _ in range(2):
        eng = _engine(parts)
        reqs = [Request(question=q.copy()) for q in parts[3]]
        eng.serve(reqs)
        outs.append([r.output for r in reqs])
    server = RAGServer(_engine(parts))
    hs = [server.submit(q) for q in parts[3]]
    server.run_until_idle()
    assert outs[0] == outs[1] == [h.output for h in hs]


def test_deadline_expiry_and_step_budget(parts):
    server = RAGServer(_engine(parts))
    late = server.submit(parts[3][0], deadline=0.0)
    ok = server.submit(parts[3][1])
    server.run_until_idle()
    assert late.state is State.EXPIRED and late.output == []
    assert ok.state is State.DONE and server.n_expired == 1
    assert late.result() is late.request        # terminal: returns at once
    server = RAGServer(_engine(parts))
    hs = [server.submit(q) for q in parts[3]]
    server.run_until_idle(max_steps=2)
    assert all(h.done for h in hs)
    assert any(h.state is State.FAILED for h in hs)
    assert sorted(server.engine.pool.free) == [0, 1]


def test_replay_open_loop(parts):
    server = RAGServer(_engine(parts))
    offs = poisson_offsets(200.0, len(parts[3]), seed=1)
    assert np.all(np.diff(offs) > 0)
    hs = server.replay(parts[3], offs, max_new_tokens=[3, None] * 3)
    assert [len(h.output) for h in hs] == [3, 5] * 3
    with pytest.raises(ValueError, match="per-request"):
        server.replay(parts[3], offs, max_new_tokens=[1, 2])
    assert percentiles([]) == {"p50": None, "p95": None, "p99": None}
    assert percentiles([1.0, 2.0])["p50"] == 1.5


def test_chunked_prefill_and_iterative_presets_run(parts):
    for kw in ({"prefill_chunk": 4}, {"iterative_interval": 2,
                                      "retrieval_batch": 2}):
        eng = _engine(parts, **kw)
        reqs = [Request(question=q.copy()) for q in parts[3]]
        eng.serve(reqs)
        assert all(r.state is State.DONE and len(r.output) == 5
                   for r in reqs)
    assert eng.metrics["retrieval_batches"] > 0
    assert all(len(r.retrieved_ids) > 1 for r in reqs)
    assert eng.metrics_snapshot()["append_compiles"] >= 1


def test_health_and_drain_api(parts):
    eng = _engine(parts)
    assert eng.healthy and eng.accepting
    eng.degrade()
    assert eng.health is EngineHealth.DEGRADED
    eng.drain()
    eng.drain()                                  # idempotent
    assert eng.healthy and not eng.accepting
    eng.undrain()
    assert eng.health is EngineHealth.DEGRADED
    eng.fail("test")
    assert not eng.healthy
    with pytest.raises(EngineCrash):
        eng.tick()
    with pytest.raises(EngineCrash):
        eng.drain()
    assert LEGAL_HEALTH_TRANSITIONS[EngineHealth.DEAD] == frozenset()


def test_abort_and_snapshot_are_detached(parts):
    eng = _engine(parts)
    req = Request(question=parts[3][0].copy())
    eng.queue.append(req)
    eng.tick()
    assert req.slot in eng.active
    eng.abort_request(req, "test")
    assert req.state is State.FAILED and req.fail_reason == "test"
    assert not eng.active and sorted(eng.pool.free) == [0, 1]
    snap = eng.metrics_snapshot()
    snap["stage_time_s"]["decode"] = -1.0
    assert eng.metrics["stage_time_s"]["decode"] >= 0
    assert snap["attn_impl"] == "ref" and snap["health"] == "healthy"


def _serve_one(eng) -> Request:
    req = Request(question=np.asarray([1, 2, 3, 4], np.int32))
    eng.serve([req])
    assert req.state is State.DONE and len(req.output) == 5
    assert all(0 <= t < VOCAB for t in req.output)
    return req


@pytest.mark.parametrize("kw,missing", [
    ({"paged": False}, "dense slot pool"),
    ({"fused_decode": False}, "dense slot pool"),
    ({"fanout_queries": 2}, "multi_query"),
])
def test_unported_parts_raise(parts, kw, missing):
    """Each part that raised before it was ported now builds an engine
    that serves a request."""
    eng = _engine(parts, **kw)
    if missing == "dense slot pool":
        assert isinstance(eng.pool, KVCachePool)
    else:
        assert eng.has_executor(missing)
    req = _serve_one(eng)
    if "fused_decode" in kw:
        assert eng.metrics["cache_copy_bytes"] > 0
    if missing == "multi_query":
        assert len(req.query_variants) == 2


@pytest.mark.parametrize("stage", ["rewriter", "reranker", "safety"])
def test_unported_stage_components_raise(parts, stage):
    """Each stage model that made the engine raise before its executor
    was ported now adds that executor, and the engine serves a request."""
    gen, enc, corpus, _ = parts
    cfg = EngineConfig(decode_slots=2, s_max=64, max_new_tokens=5,
                       rewrite_tokens=2, rerank=True)
    eng = RAGEngine(gen, enc, corpus, cfg, device="cpu",
                    **{stage: gen if stage == "rewriter" else enc})
    name = {"rewriter": "rewrite", "reranker": "rerank",
            "safety": "safety_filter"}[stage]
    assert [e.name for e in eng.executors] == [
        n for n in ("rewrite", "retrieval", "rerank", "safety_filter")
        if n in (name, "retrieval")]
    req = _serve_one(eng)
    assert eng.metrics["stage_time_s"][name] > 0
    if stage == "rewriter":
        assert len(req.rewritten) == 4 + 2


def test_engine_refuses_a_missing_gpu(parts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gen, enc, corpus, _ = parts
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RAGEngine(gen, enc, corpus, EngineConfig())


def test_stalled_request_raises(parts):
    """A request the server can never finish surfaces loudly."""
    server = RAGServer(_engine(parts))
    h = server.submit(parts[3][0])
    server.engine.queue.clear()            # lost: the engine never sees it
    with pytest.raises(RequestStalledError):
        h.result()


def test_bucket_len():
    assert [bucket_len(n) for n in (1, 8, 9, 100, 1024)] == \
        [8, 8, 16, 128, 1024]
