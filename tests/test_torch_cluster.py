"""Port vs JAX: the disaggregated cluster on the CPU.

* A 1-prefill + 1-decode cluster of the port serves the greedy tokens of
  the JAX package's 1+1 cluster (``attn_impl="ref"``, one module-scoped
  run) under ``tests/test_torch_engine.py``'s near-tie rule, with equal
  cluster and engine counters, and exactly the tokens of the port's own
  collocated engine.  The stack is that file's (2 layers, JAX weights
  carried by ``repro_torch.bridge``), on IVF-PQ with the JAX index carried
  across.
* The handoff payload: ``payload_checksum`` of a bf16 and an f32 slot
  equals the JAX pool's, and the gathered export is bit-equal to the
  per-page export it replaced.
* ``from_plan(topology="disagg")`` group sizes, ``group_summary`` keys,
  SLO shedding at ``submit``, and ``set_tracer`` reaching every engine
  (one added later too) and the injector.
"""

import dataclasses
import time
from dataclasses import replace

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hardware as jhw
from repro.core.serving_plan import ServingPlan as JServingPlan
from repro.configs import rag_pipelines as jpipes
from repro.models import transformer as jtr
from repro.serving import kv_cache as jkv
from repro.serving.cluster import RAGCluster as JRAGCluster
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import RAGEngine as JRAGEngine
from repro.serving.server import RAGServer as JRAGServer
from repro_torch import bridge
from repro_torch.configs import rag_pipelines as tpipes
from repro_torch.core import hardware as thw
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.models import transformer as tr
from repro_torch.retrieval.backend import IVFPQBackend
from repro_torch.serving import engine as te
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.cluster import RAGCluster
from repro_torch.serving.request import LEGAL_TRANSITIONS, State
from repro_torch.serving.server import RAGServer
from test_torch_engine import _compare_streams, _port, stack  # noqa: F401

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

#: iterative retrieval every 3 tokens, two queries a batch, on IVF-PQ
KW = dict(decode_slots=2, s_max=96, max_new_tokens=7, iterative_interval=3,
          retrieval_batch=2, retrieval_backend="ivfpq", nprobe=4)


def _port_cluster(stack, backend, n_prefill=1, n_decode=1,
                  predicted_ttft=None, injector=None, **kw):
    """A port cluster with the same shape as the JAX one, sharing one
    corpus encode and the carried index."""
    gen, enc, corpus, _ = stack
    cfg = te.EngineConfig(**{**KW, **kw})
    g, e = _port(gen), _port(enc)
    first = te.RAGEngine(g, e, corpus, replace(cfg, decode_slots=1),
                         backend=backend, device="cpu")
    shared = dict(db_vectors=first.db_vectors, backend=first.backend,
                  device="cpu")
    prefill = [first] + [te.RAGEngine(g, e, corpus,
                                      replace(cfg, decode_slots=1), **shared)
                         for _ in range(n_prefill - 1)]
    decode = [te.RAGEngine(g, e, corpus, cfg, **shared)
              for _ in range(n_decode)]
    return RAGCluster(prefill, decode, predicted_ttft=predicted_ttft,
                      injector=injector)


@pytest.fixture(scope="module")
def jax_run(stack):
    """The JAX 1+1 cluster on the "ref" path, and its index carried over."""
    gen, enc, corpus, questions = stack
    cfg = JEngineConfig(attn_impl="ref", **KW)
    first = JRAGEngine(gen, enc, corpus, replace(cfg, decode_slots=1))
    decode = JRAGEngine(gen, enc, corpus, cfg, db_vectors=first.db_vectors,
                        backend=first.backend)
    cluster = JRAGCluster([first], [decode])
    server = JRAGServer.from_cluster(cluster)
    handles = [server.submit(q.copy()) for q in questions]
    server.run_until_idle()
    idx = first.backend.chain[0].index
    index = bridge.index_from_jax(idx.centroids, idx.codebooks, idx.list_ids,
                                  idx.list_codes, idx.n_vectors, device="cpu")
    return cluster, [h.request for h in handles], index


def _backend(index):
    return IVFPQBackend.from_index(index, nprobe=KW["nprobe"], device="cpu")


def _walk_is_legal(req):
    hist = req.state_history
    assert State.HANDOFF in hist
    for a, b in zip(hist, hist[1:]):
        assert b in LEGAL_TRANSITIONS[a], hist


ENGINE_COUNTERS = ("decode_steps", "idle_slot_steps", "prefills",
                   "retrieved_queries", "retrieval_batches", "host_syncs",
                   "decode_host_syncs", "capacity_stops", "prefill_compiles",
                   "append_compiles", "degraded_answers")


def test_cluster_serves_as_jax_cluster_and_as_collocated(stack, jax_run):
    gen, enc, corpus, questions = stack
    jcluster, jreqs, index = jax_run
    cluster = _port_cluster(stack, _backend(index))
    server = RAGServer.from_cluster(cluster)
    handles = [server.submit(q.copy()) for q in questions]
    server.run_until_idle()
    treqs = [h.request for h in handles]
    _compare_streams(stack, jreqs, treqs)
    for r in treqs:
        _walk_is_legal(r)
    assert all(r.retrievals_done >= 1 for r in treqs)
    assert [r.retrievals_done for r in treqs] == \
        [r.retrievals_done for r in jreqs]
    # cluster counters (handoffs, bytes shipped and in full, pages) and
    # every engine's counters as in JAX
    assert cluster.metrics.snapshot() == jcluster.metrics.snapshot()
    assert cluster.metrics["handoffs"] == len(questions)
    assert cluster.metrics["handoff_bytes"] > 0
    for tg, jg in ((cluster.prefill_engines, jcluster.prefill_engines),
                   (cluster.decode_engines, jcluster.decode_engines)):
        for teng, jeng in zip(tg, jg):
            ts, js = teng.metrics_snapshot(), jeng.metrics_snapshot()
            for key in ENGINE_COUNTERS + ("pages_allocated", "pages_shared",
                                          "pages_cow", "pages_evicted"):
                assert ts[key] == js[key], key
    # the handoff's four steps are timed on the engines that ran them
    assert {"export", "checksum"} <= set(
        cluster.prefill_engines[0].metrics["stage_time_s"])
    assert {"verify", "import"} <= set(
        cluster.decode_engines[0].metrics["stage_time_s"])
    # the collocated engine of the port: the handoff is bit-exact, so the
    # streams are equal, not merely near
    colo = RAGServer(te.RAGEngine(_port(gen), _port(enc), corpus,
                                  te.EngineConfig(**KW),
                                  backend=_backend(index), device="cpu"))
    chandles = [colo.submit(q.copy()) for q in questions]
    colo.run_until_idle()
    assert [h.output for h in chandles] == [r.output for r in treqs]
    assert [h.request.retrieved_ids for h in chandles] == \
        [r.retrieved_ids for r in treqs]


def _cfgs():
    fields = dict(name="ck", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=2, d_head=8, d_ff=64, vocab_size=64)
    return jtr.TransformerConfig(**fields), tr.TransformerConfig(**fields)


def _prefix(p, seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((2, 1, p, 2, 8)).astype(dtype)
            for k in ("k", "v")}


def _write_both(jpool, tpool, p, dtype, seed=0):
    import jax.numpy as jnp
    pre = _prefix(p, seed, dtype)
    tokens = np.arange(p, dtype=np.int32)
    js, ts = jpool.alloc(1), tpool.alloc(1)
    jpool.write_prefix(js, {k: jnp.asarray(v) for k, v in pre.items()}, p,
                       tokens=tokens, key_salt=b"16")
    tpool.write_prefix(ts, {k: bridge.tensor_from_numpy(v, device="cpu")
                            for k, v in pre.items()}, p,
                       tokens=tokens, key_salt=b"16")
    return js, ts


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p", [11, 12, 1])
def test_payload_checksum_and_gathered_export(dtype, p):
    """The gathered export holds the per-page export's bytes, and both the
    paged and the dense payloads checksum as the JAX pool's do."""
    import jax.numpy as jnp
    jcfg, tcfg = _cfgs()
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpool = jkv.PagedKVCachePool(jcfg, 2, 16, page_size=4, dtype=jdt)
    tpool = tkv.PagedKVCachePool(tcfg, 2, 16, page_size=4, dtype=tdt,
                                 device="cpu")
    js, ts = _write_both(jpool, tpool, p, np_dtype)
    (jpre, jlen), (tpre, tlen) = jpool.export_slot(js), tpool.export_slot(ts)
    assert tlen == jlen == p and tpre.keys == jpre.keys
    assert tkv.payload_checksum(tpre) == jkv.payload_checksum(jpre)
    assert tkv.payload_nbytes(tpre) == jkv.payload_nbytes(jpre)
    # the per-page export it replaced: two host copies a page
    ps = tpool.page_size
    for j, phys in enumerate(tpool.page_tables[ts]):
        n = min(p - j * ps, ps)
        for k in ("k", "v"):
            want = tkv.to_host(tpool.cache[k][:, phys, :n])
            got = tpre.pages[j][k]
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    # and the import lands the same bytes and tables as JAX's
    jq = jkv.PagedKVCachePool(jcfg, 1, 16, page_size=4, dtype=jdt)
    tq = tkv.PagedKVCachePool(tcfg, 1, 16, page_size=4, dtype=tdt,
                              device="cpu")
    assert tuple(tq.import_slot(tq.alloc(1), tpre)) == \
        tuple(jq.import_slot(jq.alloc(1), jpre))
    assert tq.page_tables == jq.page_tables
    for k in ("k", "v"):
        got = tkv.to_host(tq.cache[k]).view(np.uint8)
        want = np.asarray(jq.cache[k]).view(np.uint8)
        np.testing.assert_array_equal(got, want)
    # the dense pool: one stacked copy, the same checksum
    jd = jkv.KVCachePool(jcfg, 1, 16, dtype=jdt)
    td = tkv.KVCachePool(tcfg, 1, 16, dtype=tdt, device="cpu")
    js, ts = _write_both(jd, td, p, np_dtype, seed=1)
    (jpre, _), (tpre, _) = jd.export_slot(js), td.export_slot(ts)
    assert tkv.payload_checksum(tpre) == jkv.payload_checksum(jpre)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tpre[k],
                                      tkv.to_host(td.cache[k][:, ts, :p]))


def _h100_plan():
    schema = tpipes.iterative()
    system = thw.SystemConfig(n_servers=1, xpus_per_server=4,
                              xpu=thw.H100_SXM)
    return ServingPlan.optimize(schema, system)


def test_from_plan_disagg_group_sizes(stack):
    """The plan for ``iterative`` on 1 x 4 H100s splits prefill@2 ||
    decode@1 as in JAX; ``topology="disagg"`` builds that cluster, every
    engine sharing the first one's corpus encode and index."""
    gen, enc, corpus, questions = stack
    plan = _h100_plan()
    jh100 = jhw.XPUSpec("H100-SXM", 989, 80, 3.35e12, 450e9)
    jplan = JServingPlan.optimize(jpipes.iterative(), jhw.SystemConfig(
        n_servers=1, xpus_per_server=4, xpu=jh100))
    assert plan.group_sizes() == jplan.group_sizes() == (2, 1)
    over = dict(decode_slots=2, s_max=96, max_new_tokens=4,
                iterative_interval=2)
    server = RAGServer.from_plan(plan, _port(gen), _port(enc), corpus,
                                 topology="disagg", device="cpu", **over)
    cl = server.cluster
    assert server.engine is None and cl is not None
    assert (len(cl.prefill_engines), len(cl.decode_engines)) == (2, 1)
    engines = cl.prefill_engines + cl.decode_engines
    assert all(e.backend is engines[0].backend for e in engines)
    assert all(e.db_vectors is engines[0].db_vectors for e in engines)
    assert [e.cfg.decode_slots for e in engines] == [1, 1, 2]
    assert dataclasses.asdict(cl.cfg) == dataclasses.asdict(
        plan.engine_config(**over))
    assert cl.predicted_ttft == plan.predicted["ttft"]
    assert server.cfg is cl.cfg
    handles = [server.submit(q) for q in questions]
    server.run_until_idle()
    assert all(h.state is State.DONE and len(h.output) == 4
               for h in handles)
    # least-loaded dispatch used both prefill engines
    assert set(cl.prefill_of.values()) == {0, 1}
    assert RAGServer.from_plan(plan, _port(gen), _port(enc), corpus,
                               topology="disagg", device="cpu", n_prefill=1,
                               n_decode=2, **over).cluster.describe() \
        .startswith("RAGCluster[1 prefill + 2 decode engines")


def test_cluster_needs_a_card_unless_told_cpu(stack):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gen, enc, corpus, _ = stack
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RAGServer.from_plan(_h100_plan(), _port(gen), _port(enc), corpus,
                            topology="disagg", decode_slots=2, s_max=96,
                            max_new_tokens=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RAGCluster.from_plan(_h100_plan(), _port(gen), _port(enc), corpus,
                             decode_slots=2, s_max=96, max_new_tokens=4)


def _key_tree(obj):
    """The nested key structure of a summary (list entries by their first
    element)."""
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_key_tree(obj[0])]
    return None


def test_group_summary_keys_and_values_as_jax(stack, jax_run):
    jcluster, _, index = jax_run
    cluster = _port_cluster(stack, _backend(index))
    server = RAGServer.from_cluster(cluster)
    for q in stack[3]:
        server.submit(q.copy())
    server.run_until_idle()
    got, want = cluster.group_summary(), jcluster.group_summary()
    assert _key_tree(got) == _key_tree(want)
    def rows(summary, g):
        return [(p["eid"], p["n"], p["passes"])
                for p in summary[g]["per_engine"]]

    for g in ("prefill", "decode"):
        for key in ("n_engines", "ids"):
            assert got[g][key] == want[g][key]
        assert rows(got, g) == rows(want, g)
    assert got["scheduler"] == want["scheduler"]
    assert got["health"] == want["health"] and got["depths"] == want["depths"]
    assert got["prefill"]["ttft_s"]["p99"] > 0
    assert got["decode"]["tpot_s"]["p99"] > 0
    later = cluster.group_summary(window_s=1.0, now=time.monotonic() + 1e6)
    assert later["prefill"]["ttft_s"]["p50"] is None
    assert cluster.describe().startswith("RAGCluster[1 prefill + 1 decode")


def test_slo_admission_sheds_at_submit(stack, jax_run):
    """A deadline under the plan-predicted TTFT is EXPIRED at submission,
    before any retrieval or prefill."""
    cluster = _port_cluster(stack, _backend(jax_run[2]), predicted_ttft=10.0)
    server = RAGServer.from_cluster(cluster)
    doomed = server.submit(stack[3][0], deadline=time.monotonic() + 0.5)
    fine = server.submit(stack[3][1], deadline=time.monotonic() + 60.0)
    server.run_until_idle()
    assert doomed.state is State.EXPIRED and doomed.output == []
    assert doomed.request.state_history == [State.QUEUED, State.EXPIRED]
    assert fine.state is State.DONE
    assert cluster.metrics["shed_requests"] == 1
    assert sum(e.metrics["prefills"] for e in cluster.prefill_engines) == 1
    assert server.n_expired == 1 and server.summary()["n_expired"] == 1


def test_set_tracer_refuses_an_enabled_tracer(stack, jax_run):
    """Since the port has span tracing, an enabled tracer is no longer
    refused: it lands on every engine, the fault injector and an engine
    added later; ``set_tracer(None)`` turns all of them off."""
    from repro_torch.serving.faults import FaultInjector, FaultPlan
    from repro_torch.serving.telemetry import NULL_TRACER, SpanTracer

    cluster = _port_cluster(stack, _backend(jax_run[2]),
                            injector=FaultInjector(FaultPlan([])))
    tracer = SpanTracer()
    cluster.set_tracer(tracer)
    base = cluster.decode_engines[0]
    late = te.RAGEngine(base.gen, base.enc, base.corpus, base.cfg,
                        db_vectors=base.db_vectors, backend=base.backend,
                        device="cpu")
    cluster.add_decode_engine(late)
    engines = cluster.prefill_engines + cluster.decode_engines
    assert late in engines and len(engines) == 3
    assert cluster.tracer is tracer and cluster.injector.tracer is tracer
    assert all(e.tracer is tracer for e in engines)
    cluster.set_tracer(None)                    # off reaches them all
    assert cluster.tracer is NULL_TRACER
    assert cluster.injector.tracer is NULL_TRACER
    assert all(e.tracer is NULL_TRACER for e in engines)


def test_step_hooks_fire_on_every_step(stack, jax_run):
    cluster = _port_cluster(stack, _backend(jax_run[2]))
    server = RAGServer.from_cluster(cluster)
    seen = []
    server.add_step_hook(lambda s: seen.append(s.cluster.busy))
    server.submit(stack[3][0], max_new_tokens=3)
    steps = server.run_until_idle()
    assert len(seen) == steps + 1               # the last, idle step too
    assert seen[-1] is False
