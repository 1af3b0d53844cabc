"""Port vs JAX: span tracing on the CPU.

* The telemetry module's units -- histograms, the metrics registry, the
  span tracer's lifecycle and ring buffer, ``validate_spans``, the null
  tracer, the Perfetto and JSONL exporters, the request's terminal and
  retry hooks -- each run against both packages' functions (the cases of
  ``tests/test_telemetry.py``), and the same hand-built trace exports and
  attributes alike in both.
* The collocated engine (baseline, and chunked prefill with iterative
  retrieval) and a 1+1 cluster serve a closed batch traced on both sides:
  the spans, in commit order and per request, are the JAX package's less
  their times (kind, request, engine track, tick, attempt, attrs), once
  the port's sub-stage spans and the attrs it adds are left out and the
  JAX engine's ``STAGE:append`` spans of one retrieval batch are made
  one, as the port appends a batch in one forward (its ``rows``); both
  traces are well formed, the span-derived TTFT and TPOT bracket the
  request fields, and tracing changes neither the tokens nor
  ``host_syncs``, ``h2d_copies`` and the stages timed.  The cluster's
  handoff steps (export, checksum, verify, import) emit no span.
* The port's sub-stage spans tile the stage they split, and
  ``DECODE_TICK`` and ``EMBED`` carry the work the engine did: live rows,
  their context, the copies to the device, the encoder's padding rows.
* Every ``CHAOS_SCHEDULES`` entry on a 2+2 port cluster gives a
  well-formed trace with disjoint retry attempts; the controller's
  re-plans and resizes land as one ``CONTROL:*`` event each; with tracing
  off no ``Span`` is ever built.

Times are never compared across frameworks: each side's are checked on
their own (``validate_spans``, ``derive_latencies``).  A span closes a few
microseconds after the request field it mirrors is stamped (5-130 us on
this stack in both packages), so the span-derived latencies are held to
the side of the field they must fall on, and to the JAX test's 0.05 s.
The stack is ``tests/test_torch_engine.py``'s.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.serving import telemetry as JT
from repro.serving.cluster import RAGCluster as JRAGCluster
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import RAGEngine as JRAGEngine
from repro.serving.request import Request as JRequest
from repro.serving.request import State as JState
from repro.serving.server import RAGServer as JRAGServer
from repro_torch import bridge
from repro_torch.configs import rag_pipelines as tpipes
from repro_torch.core import hardware as thw
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.serving import engine as te
from repro_torch.serving import telemetry as TT
from repro_torch.serving.controller import ClusterController, DriftDetector
from repro_torch.serving.faults import (CHAOS_SCHEDULES, FaultInjector,
                                        FaultPlan)
from repro_torch.serving.request import TERMINAL_STATES, Request, State
from repro_torch.serving.server import RAGServer
from test_torch_cluster import KW, _backend, _key_tree, _port_cluster
from test_torch_controller import _make_cluster as _control_cluster
from test_torch_engine import _compare_streams, _port, stack  # noqa: F401
from test_torch_faults import _make_cluster as _chaos_cluster

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

PKGS = {"jax": (JT, JRequest, JState), "torch": (TT, Request, State)}
both = pytest.mark.parametrize("pkg", sorted(PKGS))

#: the JAX telemetry test's tolerance on span-derived latencies (s)
LATENCY_TOL = 0.05
#: the port's handoff steps, metered into stage_time_s without a span
HANDOFF_STEPS = ("export", "checksum", "verify", "import")
#: the port's sub-stage spans, in order, by the stage they split (the
#: JAX package has none)
SUB_STAGES = {
    "DECODE_TICK": ("STAGE:decode.prepare", "STAGE:decode.launch",
                    "STAGE:decode.read", "STAGE:decode.retire"),
    "PREFILL": ("STAGE:prefill.launch", "STAGE:prefill.write",
                "STAGE:prefill.read"),
    "STAGE:append": ("STAGE:append.prepare", "STAGE:append.launch"),
}
#: attrs the port's engine adds to a span kind
PORT_ATTRS = {"DECODE_TICK": ("h2d", "graph"),
              "EMBED": ("rows", "pad_rows"),
              "STAGE:append": ("rows", "tokens", "calls", "kernel")}


# ---------------------------------------------------------------------------
# units, each against both packages
# ---------------------------------------------------------------------------

@both
def test_histogram_bucket_math(pkg):
    T = PKGS[pkg][0]
    h = T.Histogram(bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1]
    assert h.count == 5
    assert h.sum == pytest.approx(55.65)
    assert h.mean == pytest.approx(55.65 / 5)
    assert h.min == 0.05 and h.max == 50.0
    assert h.quantile(0.2) == 0.1
    assert h.quantile(0.4) == 0.1
    assert h.quantile(0.5) == 1.0
    assert h.quantile(0.99) == 50.0
    snap = h.snapshot()
    assert snap["counts"] == [2, 1, 1, 1] and snap["p99"] == 50.0
    empty = T.Histogram(bounds=(1.0,))
    assert empty.mean is None and empty.quantile(0.5) is None
    assert empty.snapshot()["min"] is None


@both
def test_histogram_rejects_bad_bounds(pkg):
    T = PKGS[pkg][0]
    with pytest.raises(ValueError):
        T.Histogram(bounds=(1.0, 0.5))
    with pytest.raises(ValueError):
        T.Histogram(bounds=(1.0, 1.0))


@both
def test_registry_is_dict_compatible(pkg):
    T = PKGS[pkg][0]
    m = T.MetricsRegistry({"prefills": 0, "stage_time_s": {}})
    m["prefills"] += 3
    m["stage_time_s"]["prefill"] = (
        m["stage_time_s"].get("prefill", 0.0) + 0.25)
    m["new_counter"] = 7
    assert m["prefills"] == 3 and m["new_counter"] == 7
    assert m["stage_time_s"]["prefill"] == pytest.approx(0.25)
    assert "prefills" in m and len(m) == 3
    assert set(m) == {"prefills", "stage_time_s", "new_counter"}
    fam = m["stage_time_s"]
    m["stage_time_s"] = {"decode": 1.0}
    assert m["stage_time_s"] is fam
    assert dict(fam) == {"decode": 1.0}


@both
def test_registry_snapshot_is_detached(pkg):
    T = PKGS[pkg][0]
    m = T.MetricsRegistry({"n": 1, "stage_time_s": {"prefill": 0.5}})
    m.observe("lat", 0.01, bounds=(0.1, 1.0))
    snap = m.snapshot()
    assert snap["n"] == 1 and snap["stage_time_s"] == {"prefill": 0.5}
    assert snap["histograms"]["lat"]["count"] == 1
    snap["n"] = 99
    snap["stage_time_s"]["prefill"] = 99.0
    snap["histograms"]["lat"]["count"] = 99
    assert m["n"] == 1
    assert m["stage_time_s"]["prefill"] == 0.5
    assert m.snapshot()["histograms"]["lat"]["count"] == 1
    m["n"] += 5
    assert snap["n"] == 99 and m["n"] == 6


@both
def test_span_lifecycle_and_annotate(pkg):
    T = PKGS[pkg][0]
    tr_ = T.SpanTracer()
    tr_.event("SUBMIT", rid=7, t=1.0)
    s = tr_.begin("PREFILL", rid=7, engine="p0", t=1.5)
    tr_.annotate(7, prompt_tokens=32)
    tr_.end(s, t=2.0)
    tr_.end(s, t=9.0)                      # idempotent: first end wins
    assert s.t1 == 2.0 and s.attrs["prompt_tokens"] == 32
    d = tr_.begin("DECODE", rid=7, engine="d0", t=2.0)
    tr_.terminal(7, "done", t=3.0)
    assert d.t1 == 3.0 and d.attrs["closed_by"] == "done"
    assert not tr_.open_spans()
    kinds = [x.kind for x in tr_.spans_for(7)]
    assert kinds == ["SUBMIT", "PREFILL", "DECODE", "TERMINAL"]
    assert T.validate_spans(
        tr_, [SimpleNamespace(rid=7, state="done")]) == []
    as_dicts = [x.to_dict() for x in tr_.spans()]
    assert all(v["t1"] is not None for v in as_dicts)


@both
def test_ring_buffer_bounds_memory_and_counts_drops(pkg):
    T = PKGS[pkg][0]
    tr_ = T.SpanTracer(capacity=8)
    for i in range(20):
        tr_.record("DECODE_TICK", float(i), float(i) + 0.5, engine="d0",
                   tick=i)
    spans = tr_.spans()
    assert len(spans) == 8
    assert tr_.dropped == 12
    assert [s.tick for s in spans] == list(range(12, 20))
    # with drops the completeness checks are skipped
    assert T.validate_spans(tr_, [SimpleNamespace(rid=999,
                                                  state="done")]) == []
    with pytest.raises(ValueError):
        T.SpanTracer(capacity=0)


@both
def test_validate_spans_flags_violations(pkg):
    T = PKGS[pkg][0]

    def mkreq(rid):
        return SimpleNamespace(rid=rid, state="done")

    tr_ = T.SpanTracer()                # an open span after the terminal
    tr_.event("SUBMIT", rid=1, t=0.0)
    tr_.begin("DECODE", rid=1, t=1.0)
    tr_.record("TERMINAL", 2.0, 2.0, rid=1)
    assert any("open spans after terminal" in x
               for x in T.validate_spans(tr_, [mkreq(1)]))

    tr_ = T.SpanTracer()                # two TERMINAL events
    tr_.event("SUBMIT", rid=2, t=0.0)
    tr_.record("TERMINAL", 1.0, 1.0, rid=2)
    tr_.record("TERMINAL", 2.0, 2.0, rid=2)
    assert any("TERMINAL" in x for x in T.validate_spans(tr_, [mkreq(2)]))

    tr_ = T.SpanTracer()                # retry attempts interleaving
    tr_.event("SUBMIT", rid=3, t=0.0)
    tr_.record("PREFILL", 0.0, 5.0, rid=3, attempt=0)
    tr_.record("PREFILL", 1.0, 2.0, rid=3, attempt=1)
    tr_.record("TERMINAL", 6.0, 6.0, rid=3)
    assert any("attempt" in x for x in T.validate_spans(tr_, [mkreq(3)]))

    tr_ = T.SpanTracer()                # no SUBMIT, a span past TERMINAL
    tr_.record("PREFILL", 0.0, 9.0, rid=5)
    tr_.record("TERMINAL", 4.0, 4.0, rid=5)
    v = T.validate_spans(tr_, [mkreq(5)])
    assert any("SUBMIT" in x for x in v)
    assert any("after TERMINAL" in x for x in v)

    tr_ = T.SpanTracer()                # a span that ends before it starts
    tr_.event("SUBMIT", rid=6, t=0.0)
    tr_.record("PREFILL", 2.0, 1.0, rid=6)
    tr_.record("TERMINAL", 3.0, 3.0, rid=6)
    assert any("ends before" in x for x in T.validate_spans(tr_, [mkreq(6)]))
    assert T.validate_spans(T.SpanTracer(), [mkreq(8)]) == \
        ["rid 8: no spans recorded"]

    tr_ = T.SpanTracer()                # a healthy retry
    tr_.event("SUBMIT", rid=4, t=0.0)
    tr_.record("PREFILL", 0.0, 1.0, rid=4, attempt=0)
    tr_.record("RETRY", 1.0, 1.0, rid=4, attempt=1)
    tr_.record("PREFILL", 2.0, 3.0, rid=4, attempt=1)
    tr_.record("TERMINAL", 4.0, 4.0, rid=4)
    assert T.validate_spans(tr_, [mkreq(4)]) == []


@both
def test_null_tracer_is_inert(pkg):
    n = PKGS[pkg][0].NULL_TRACER
    assert n.enabled is False and n.dropped == 0
    assert n.begin("PREFILL", rid=1) is None
    n.end(None)
    n.end_kind(1, "PREFILL")
    n.annotate(1, a=1)
    n.close_open(1)
    n.terminal(1, "done")
    n.event("SUBMIT", rid=1)
    assert n.record("PREFILL", 0.0, 1.0, rid=1) is None
    assert n.spans() == [] and n.spans_for(1) == [] and n.open_spans() == {}


def _synthetic_trace(T):
    """Two engines, two requests, one cluster-scope instant."""
    tr_ = T.SpanTracer()
    for rid, eng in ((1, "prefill0"), (2, "decode0")):
        tr_.event("SUBMIT", rid=rid, t=0.1 * rid)
        s = tr_.begin("PREFILL", rid=rid, engine=eng, t=0.2 * rid)
        tr_.end(s, t=0.2 * rid + 0.05)
        d = tr_.begin("DECODE", rid=rid, engine=eng, t=0.2 * rid + 0.06,
                      attrs={"slot": rid})
        if rid == 2:
            tr_.end(d, t=1.5)
        tr_.terminal(rid, "done", t=1.0 + rid)
    tr_.record("DECODE_TICK", 0.5, 0.6, engine="decode0", tick=3,
               attrs={"n": 2})
    tr_.event("CONTROL:replan", t=0.7, attrs={"trigger": "load"})
    return tr_


@both
def test_perfetto_export_tracks_and_events(pkg, tmp_path):
    T = PKGS[pkg][0]
    tr_ = _synthetic_trace(T)
    path = tmp_path / "trace.json"
    doc = T.export_perfetto(tr_, str(path))
    assert json.loads(path.read_text()) == doc
    ev = doc["traceEvents"]
    meta = [e for e in ev if e["ph"] == "M"]
    names = {(e["pid"], e.get("tid")): e["args"]["name"]
             for e in meta if e["name"] == "thread_name"}
    assert set(names.values()) == {"cluster", "prefill0", "decode0",
                                   "req 1", "req 2"}
    procs = {e["pid"]: e["args"]["name"]
             for e in meta if e["name"] == "process_name"}
    assert set(procs.values()) == {"engines", "requests"}
    xs = [e for e in ev if e["ph"] == "X"]
    assert xs and all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)
    instants = [e for e in ev if e["ph"] == "i"]
    assert {"SUBMIT", "TERMINAL", "CONTROL:replan"} <= {
        e["name"] for e in instants}
    ctl = next(e for e in instants if e["name"] == "CONTROL:replan")
    assert names[(ctl["pid"], ctl["tid"])] == "cluster"
    tick = next(e for e in xs if e["name"] == "DECODE_TICK")
    assert names[(tick["pid"], tick["tid"])] == "decode0"
    assert tick["args"] == {"n": 2, "engine": "decode0", "tick": 3}
    assert doc["otherData"]["dropped_spans"] == 0


@both
def test_jsonl_export_roundtrip(pkg, tmp_path):
    T = PKGS[pkg][0]
    tr_ = _synthetic_trace(T)
    path = tmp_path / "spans.jsonl"
    n = T.export_jsonl(tr_, str(path))
    rows = T.load_spans(str(path))
    assert n == len(rows) == len(tr_.spans())
    assert rows == [s.to_dict() for s in tr_.spans()]
    assert {r["kind"] for r in rows} >= {"SUBMIT", "PREFILL", "TERMINAL",
                                         "DECODE_TICK", "CONTROL:replan"}
    assert all(r["t1"] > r["t0"] and r["engine"]
               for r in rows if r["kind"] == "PREFILL")


@both
def test_request_terminal_state_closes_spans(pkg):
    T, Req, St = PKGS[pkg]
    tr_ = T.SpanTracer()
    req = Req(question=np.zeros(4, np.int32))
    req.tracer = tr_
    tr_.event("SUBMIT", rid=req.rid, t=0.0)
    tr_.begin("DECODE", rid=req.rid, t=0.5)
    for s in (St.RETRIEVING, St.PREFILL, St.HANDOFF, St.DECODE, St.DONE):
        req.state = s
    spans = tr_.spans_for(req.rid)
    assert [s.kind for s in spans][-1] == "TERMINAL"
    assert spans[-1].attrs == {"state": "done"}
    assert not tr_.open_spans()
    assert T.validate_spans(tr_, [req]) == []


@both
def test_reset_for_retry_closes_attempt_and_marks_it(pkg):
    T, Req, St = PKGS[pkg]
    tr_ = T.SpanTracer()
    req = Req(question=np.zeros(4, np.int32))
    req.tracer = tr_
    tr_.event("SUBMIT", rid=req.rid, t=0.0)
    tr_.begin("PREFILL", rid=req.rid, t=0.5)
    req.state = St.RETRIEVING
    req.state = St.PREFILL
    req.reset_for_retry(now=1.0, backoff=0.01)
    kinds = [s.kind for s in tr_.spans_for(req.rid)]
    assert "RETRY" in kinds and not tr_.open_spans()
    retry = next(s for s in tr_.spans_for(req.rid) if s.kind == "RETRY")
    assert retry.attrs["retries"] == 1 and retry.attempt == 1
    prefill = next(s for s in tr_.spans_for(req.rid)
                   if s.kind == "PREFILL")
    assert prefill.attrs["closed_by"] == "retry"
    tr_.begin("PREFILL", rid=req.rid, t=2.0)
    for s in (St.QUEUED, St.RETRIEVING, St.PREFILL):
        req.state = s
    req.reset_for_retry(now=3.0, backoff=0.0, migration=True)
    migrate = next(s for s in tr_.spans_for(req.rid) if s.kind == "MIGRATE")
    assert migrate.attrs["migrations"] == 1 and migrate.attempt == 2


def _attribution(T, tracer, reqs):
    return {"validate": T.validate_spans(tracer, reqs),
            "breakdown": [T.request_breakdown(tracer, r) for r in reqs],
            "slo": [T.slo_attribution(tracer, r) for r in reqs],
            "summary": T.slo_summary(tracer, reqs),
            "latencies": [T.derive_latencies(tracer, r) for r in reqs]}


def test_packages_export_and_attribute_alike(tmp_path):
    """The same trace gives the same Perfetto document, span log and SLO
    attribution in both packages (the port's module is a copy)."""
    reqs = [SimpleNamespace(rid=rid, state="done", t_arrive=0.1 * rid,
                            t_done=1.0 + rid, deadline=(2.0 if rid == 1
                                                        else None),
                            ttft=0.1 * rid + 0.05, output=[0] * (3 + rid))
            for rid in (1, 2)]
    out = {}
    for pkg in sorted(PKGS):
        T = PKGS[pkg][0]
        tr_ = _synthetic_trace(T)
        T.export_jsonl(tr_, str(tmp_path / f"{pkg}.jsonl"))
        out[pkg] = (T.export_perfetto(tr_),
                    T.load_spans(str(tmp_path / f"{pkg}.jsonl")),
                    _attribution(T, tr_, reqs))
    assert out["torch"] == out["jax"]
    assert out["torch"][2]["validate"] == []
    assert TT.STAGE_SPAN_BUCKETS == JT.STAGE_SPAN_BUCKETS
    assert TT.DEFAULT_TIME_BUCKETS == JT.DEFAULT_TIME_BUCKETS
    for stage in ("embed", "retrieve", "prefill", "decode", "rerank"):
        assert TT.stage_kind(stage) == JT.stage_kind(stage)


# ---------------------------------------------------------------------------
# traced serving against the JAX package
# ---------------------------------------------------------------------------

def _is_sub_stage(kind: str) -> bool:
    return kind.startswith("STAGE:") and "." in kind


def _shared_attrs(span):
    """``span.attrs`` less those the port adds (None where none is left,
    as the JAX package leaves them)."""
    drop = PORT_ATTRS.get(span.kind, ())
    if not span.attrs or not drop:
        return span.attrs
    return {k: v for k, v in span.attrs.items() if k not in drop} or None


def _shape(tracer, reqs) -> list:
    """Every committed span but the port's sub-stage spans, oldest first,
    without its times or the port's attrs; a span's request is its index
    in ``reqs``."""
    index = {r.rid: i for i, r in enumerate(reqs)}
    return [(s.kind, index.get(s.rid, s.rid), s.engine, s.tick, s.attempt,
             _shared_attrs(s)) for s in tracer.spans()
            if not _is_sub_stage(s.kind)]


def _batch_appends(shape) -> tuple[list, list]:
    """``shape`` with each run of consecutive ``STAGE:append`` spans of
    one tick made one, and the runs' lengths: the JAX engine appends a
    retrieval batch's documents a request a span, the port's in one."""
    out, runs = [], []
    for entry in shape:
        if entry[0] == "STAGE:append":
            if out and out[-1][0] == "STAGE:append" and \
                    out[-1][3] == entry[3]:
                runs[-1] += 1
                continue
            runs.append(1)
        out.append(entry)
    return out, runs


def _sequences(tracer, reqs) -> list:
    """Each request's spans in time order, without their times."""
    return [[(s.kind, s.engine, s.tick, s.attempt, _shared_attrs(s))
             for s in tracer.spans_for(r.rid)] for r in reqs]


def _plain(value) -> bool:
    if isinstance(value, dict):
        return all(isinstance(k, str) and _plain(v)
                   for k, v in value.items())
    return value is None or type(value) in (int, float, str, bool)


def _check_side(T, tracer, reqs, done):
    """One side's trace on its own: complete, well formed, and its
    latencies where the request fields say."""
    assert tracer.dropped == 0 and not tracer.open_spans()
    assert T.validate_spans(tracer, reqs) == []
    for r in reqs:
        assert r.state is done
        d = T.derive_latencies(tracer, r)
        # the PREFILL span closes after t_first_token is stamped; the
        # DECODE span opens after it (on a cluster at t_decode, the slot
        # assignment after the handoff) and the TERMINAL event fires
        # before t_done is stamped
        assert r.ttft <= d["ttft"] <= r.ttft + LATENCY_TOL
        start = r.t_decode if r.t_decode is not None else r.t_first_token
        tpot = (r.t_done - start) / (len(r.output) - 1)
        assert tpot - LATENCY_TOL <= d["tpot"] <= tpot
        b = T.request_breakdown(tracer, r)
        assert b["total_s"] == pytest.approx(r.latency, abs=LATENCY_TOL)


def _check_port_trace(tracer, tmp_path):
    """The port's attrs are plain Python values, and the trace exports."""
    assert all(_plain(s.attrs) for s in tracer.spans())
    doc = TT.export_perfetto(tracer, str(tmp_path / "trace.json"))
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    n = TT.export_jsonl(tracer, str(tmp_path / "spans.jsonl"))
    assert TT.load_spans(str(tmp_path / "spans.jsonl")) == \
        [s.to_dict() for s in tracer.spans()]
    assert n == len(tracer.spans())


def _breakdown_keys(T, tracer, reqs):
    return [sorted(T.request_breakdown(tracer, r)["stages_s"]) for r in reqs]


PRESETS = {
    "baseline": {},
    "chunked_iterative": {"prefill_chunk": 8, "iterative_interval": 3,
                          "retrieval_batch": 2, "max_new_tokens": 9},
}


BASE = {"decode_slots": 3, "s_max": 96, "max_new_tokens": 6}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_engine_spans_match_jax(stack, preset, tmp_path):
    gen, enc, corpus, questions = stack
    base = {**BASE, **PRESETS[preset]}
    jt, tt = JT.SpanTracer(), TT.SpanTracer()
    jserver = JRAGServer(JRAGEngine(gen, enc, corpus,
                                    JEngineConfig(attn_impl="ref", **base)),
                         tracer=jt)
    jreqs = [jserver.submit_request(JRequest(question=q.copy())).request
             for q in questions]
    jserver.run_until_idle()

    def port_engine():
        return te.RAGEngine(_port(gen), _port(enc), corpus,
                            te.EngineConfig(**base), device="cpu")

    tserver = RAGServer(port_engine(), tracer=tt)
    assert tserver.engine.tracer is tt
    treqs = [tserver.submit_request(Request(question=q.copy())).request
             for q in questions]
    tserver.run_until_idle()
    _compare_streams(stack, jreqs, treqs)
    jshape, runs = _batch_appends(_shape(jt, jreqs))
    assert _shape(tt, treqs) == jshape
    assert [s.attrs["rows"] for s in tt.spans()
            if s.kind == "STAGE:append"] == runs
    assert _sequences(tt, treqs) == _sequences(jt, jreqs)
    kinds = {s.kind for s in tt.spans()}
    assert {"SUBMIT", "ADMIT", "STAGE:retrieval", "EMBED", "RETRIEVE",
            "PREFILL", "DECODE", "DECODE_TICK", "TERMINAL"} <= kinds
    if base.get("prefill_chunk"):
        assert {"PREFILL_CHUNK", "STAGE:append"} <= kinds
    _check_side(JT, jt, jreqs, JState.DONE)
    _check_side(TT, tt, treqs, State.DONE)
    _check_port_trace(tt, tmp_path)
    assert _breakdown_keys(TT, tt, treqs) == _breakdown_keys(JT, jt, jreqs)
    tslo, jslo = tserver.summary()["slo"], jserver.summary()["slo"]
    assert _key_tree(tslo) == _key_tree(jslo)
    assert tslo["n"] == len(treqs)
    # tracing changes neither the tokens, the host syncs and copies, nor
    # the stages timed: the sub-stage spans feed no stage counter
    plain = port_engine()
    preqs = [Request(question=q.copy()) for q in questions]
    plain.serve(preqs)
    assert [r.output for r in preqs] == [r.output for r in treqs]
    snap, traced = plain.metrics_snapshot(), tserver.engine.metrics_snapshot()
    for key in ("host_syncs", "decode_host_syncs", "h2d_copies",
                "decode_steps"):
        assert snap[key] == traced[key], key
    assert traced["h2d_copies"] > 0
    assert set(snap["stage_time_s"]) == set(traced["stage_time_s"])
    assert _stage_counts(snap) == _stage_counts(traced)
    # each engine-track stage's seconds are its spans' own
    for stage, kind in (("decode", "DECODE_TICK"), ("embed", "EMBED"),
                        ("retrieve", "RETRIEVE")):
        spans = [s for s in tt.spans() if s.kind == kind]
        assert traced["stage_time_s"][stage] == pytest.approx(
            sum(s.t1 - s.t0 for s in spans), rel=1e-9)
        assert _stage_counts(traced)[stage] == len(spans)
    assert "slo" not in RAGServer(plain).summary()


def _stage_counts(snap) -> dict:
    return {k.split(":", 1)[1]: h["count"]
            for k, h in snap["histograms"].items()
            if k.startswith("stage_seconds:")}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_sub_stage_spans_tile_their_stage(stack, preset):
    """Each sub-stage span lies inside a span of the stage it splits, on
    the engine's track at that stage's tick, and a stage's sub-stage spans
    follow one another in order, each beginning where the last ended."""
    gen, enc, corpus, questions = stack
    kw = {**BASE, **PRESETS[preset]}
    tracer = TT.SpanTracer()
    server = RAGServer(te.RAGEngine(_port(gen), _port(enc), corpus,
                                    te.EngineConfig(**kw), device="cpu"),
                       tracer=tracer)
    for q in questions:
        server.submit(q.copy())
    server.run_until_idle()
    spans = tracer.spans()
    subs = [s for s in spans if _is_sub_stage(s.kind)]
    chunked = bool(kw.get("prefill_chunk"))
    extends = chunked or bool(kw.get("iterative_interval"))
    assert {s.kind for s in subs} == set(
        SUB_STAGES["DECODE_TICK"]
        + (SUB_STAGES["STAGE:append"] if extends else ())
        + (() if chunked else SUB_STAGES["PREFILL"]))
    parent_of = {sub: parent for parent, kinds in SUB_STAGES.items()
                 for sub in kinds}
    for s in subs:
        assert s.rid is None and s.engine == "engine0" and not s.attrs
        assert s.t0 <= s.t1
        # chunked prefill's chunks extend the cache as appends do
        parents = (("STAGE:append", "PREFILL") if s.kind.startswith(
            "STAGE:append.") else (parent_of[s.kind],))
        assert any(p.kind in parents and p.t0 <= s.t0 and s.t1 <= p.t1
                   and (p.kind != "DECODE_TICK" or p.tick == s.tick)
                   for p in spans), s
    # one run of the sub-stages a stage, in order and contiguous
    for parent, kinds in SUB_STAGES.items():
        run = [s for s in subs if s.kind in kinds]
        assert len(run) % len(kinds) == 0, parent
        for i in range(0, len(run), len(kinds)):
            group = run[i:i + len(kinds)]
            assert tuple(s.kind for s in group) == kinds
            assert all(a.t1 == b.t0 for a, b in zip(group, group[1:]))
    ticks = [s for s in spans if s.kind == "DECODE_TICK"]
    assert len(ticks) == sum(s.kind == "STAGE:decode.prepare" for s in subs)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_tick_and_embed_attrs_count_the_work(stack, preset):
    """``DECODE_TICK`` carries its live rows ``n``, its copies to the
    device ``h2d`` and whether it replayed the CUDA graph ``graph``;
    ``EMBED`` its rows and the encoder's padding rows: the values the
    served requests imply.  ``h2d_copies`` adds up the copies
    of every path."""
    gen, enc, corpus, questions = stack
    kw = {**BASE, **PRESETS[preset]}
    tracer = TT.SpanTracer()
    engine = te.RAGEngine(_port(gen), _port(enc), corpus,
                          te.EngineConfig(**kw), device="cpu")
    encode = engine.metrics["h2d_copies"]        # the corpus's batches
    server = RAGServer(engine, tracer=tracer)
    reqs = [server.submit(q.copy()).request for q in questions]
    server.run_until_idle()
    ticks = [s.attrs for s in tracer.spans() if s.kind == "DECODE_TICK"]
    # the paged step copies tokens, positions, block tables and the mask
    assert all(a["h2d"] == 4 for a in ticks)
    assert all(1 <= a["n"] <= kw["decode_slots"] for a in ticks)
    # every answer token after the first is one row of one step
    assert sum(a["n"] for a in ticks) == sum(len(r.output) - 1
                                             for r in reqs)
    assert all(set(a) == {"n", "h2d", "graph"} for a in ticks)
    # a CPU engine steps eagerly: no tick replays the CUDA graph
    assert all(a["graph"] == 0 for a in ticks)
    embeds = [s.attrs for s in tracer.spans() if s.kind == "EMBED"]
    assert all(a["rows"] + a["pad_rows"] == te.EMBED_BATCH for a in embeds)
    assert sum(a["rows"] for a in embeds) == \
        engine.metrics["retrieved_queries"]
    # admission embeds one question a request
    assert sum(a == {"rows": 1, "pad_rows": te.EMBED_BATCH - 1}
               for a in embeds) >= len(reqs)
    # besides the ticks': an encoder batch's rows; a prefill's prompt and
    # the indices of its fresh pages; an append's or a chunk's block row
    # and tokens
    kinds = [s.kind for s in tracer.spans()]
    assert engine.metrics["h2d_copies"] - encode == (
        sum(a["h2d"] for a in ticks)
        + sum(a["rows"] + a["pad_rows"] for a in embeds) // te.EMBED_BATCH
        + 3 * kinds.count("STAGE:prefill.write")
        + 2 * kinds.count("STAGE:append.prepare"))


def test_cluster_spans_match_jax(stack, tmp_path):
    """A traced 1+1 cluster against the JAX one: ADMIT, HANDOFF and
    DECODE as JAX emits them, and no span for the handoff's steps."""
    gen, enc, corpus, questions = stack
    cfg = JEngineConfig(attn_impl="ref", **KW)
    first = JRAGEngine(gen, enc, corpus, JEngineConfig(
        attn_impl="ref", **{**KW, "decode_slots": 1}))
    jcluster = JRAGCluster([first], [JRAGEngine(
        gen, enc, corpus, cfg, db_vectors=first.db_vectors,
        backend=first.backend)])
    jt = JT.SpanTracer()
    jserver = JRAGServer.from_cluster(jcluster)
    jserver.set_tracer(jt)
    jreqs = [jserver.submit(q.copy()).request for q in questions]
    jserver.run_until_idle()
    idx = first.backend.chain[0].index
    index = bridge.index_from_jax(idx.centroids, idx.codebooks, idx.list_ids,
                                  idx.list_codes, idx.n_vectors, device="cpu")

    tt = TT.SpanTracer()
    cluster = _port_cluster(stack, _backend(index))
    tserver = RAGServer.from_cluster(cluster)
    tserver.set_tracer(tt)
    assert cluster.tracer is tt
    treqs = [tserver.submit(q.copy()).request for q in questions]
    tserver.run_until_idle()
    _compare_streams(stack, jreqs, treqs)
    jshape, runs = _batch_appends(_shape(jt, jreqs))
    assert _shape(tt, treqs) == jshape
    assert [s.attrs["rows"] for s in tt.spans()
            if s.kind == "STAGE:append"] == runs
    assert _sequences(tt, treqs) == _sequences(jt, jreqs)
    kinds = {s.kind for s in tt.spans()}
    assert {"ADMIT", "HANDOFF", "DECODE", "PREFILL"} <= kinds
    assert not kinds & {f"STAGE:{s}" for s in HANDOFF_STEPS}
    assert set(HANDOFF_STEPS) <= (
        set(cluster.prefill_engines[0].metrics["stage_time_s"])
        | set(cluster.decode_engines[0].metrics["stage_time_s"]))
    handoffs = [s for s in tt.spans() if s.kind == "HANDOFF"]
    assert len(handoffs) == len(treqs)
    assert all(s.attrs["bytes_shipped"] > 0 and s.attrs["pages"] > 0
               for s in handoffs)
    _check_side(JT, jt, jreqs, JState.DONE)
    _check_side(TT, tt, treqs, State.DONE)
    _check_port_trace(tt, tmp_path)
    assert _breakdown_keys(TT, tt, treqs) == _breakdown_keys(JT, jt, jreqs)
    tgroup, jgroup = cluster.group_summary(), jcluster.group_summary()
    assert _key_tree(tgroup["slo"]) == _key_tree(jgroup["slo"])
    assert _key_tree(tserver.summary()["slo"]) == \
        _key_tree(jserver.summary()["slo"])
    assert "handoff" in tgroup["slo"]["mean_stage_s"]
    # the same cluster untraced: same tokens, same host syncs
    plain = _port_cluster(stack, _backend(index))
    pserver = RAGServer.from_cluster(plain)
    outs = [pserver.submit(q.copy()) for q in questions]
    pserver.run_until_idle()
    assert [h.output for h in outs] == [r.output for r in treqs]
    for pe, te_ in zip(plain.prefill_engines + plain.decode_engines,
                       cluster.prefill_engines + cluster.decode_engines):
        for key in ("host_syncs", "decode_host_syncs", "h2d_copies"):
            assert pe.metrics[key] == te_.metrics[key], key
    assert "slo" not in plain.group_summary()


# ---------------------------------------------------------------------------
# faults, the controller and the null tracer on port clusters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", sorted(CHAOS_SCHEDULES))
def test_chaos_trace_is_well_formed(stack, schedule, tmp_path):
    """Under every fault schedule each request's trace is well formed --
    every span ended, one SUBMIT and one TERMINAL, retry attempts
    disjoint in time -- and every firing is a FAULT event."""
    inj = FaultInjector(
        FaultPlan.from_schedule(CHAOS_SCHEDULES[schedule], seed=7))
    cluster = _chaos_cluster(stack, inj)
    tracer = TT.SpanTracer()
    server = RAGServer(cluster, tracer=tracer)
    assert inj.tracer is tracer
    reqs = [server.submit(q, max_new_tokens=4).request for q in stack[3]]
    server.run_until_idle(max_steps=5000)
    assert all(r.state in TERMINAL_STATES for r in reqs)
    assert tracer.dropped == 0 and not tracer.open_spans()
    assert TT.validate_spans(tracer, reqs) == []
    faults = [s for s in tracer.spans() if s.kind.startswith("FAULT:")]
    assert [s.kind for s in faults] == [f"FAULT:{p}" for p, *_ in inj.log]
    for r in reqs:
        spans = tracer.spans_for(r.rid)
        assert [s.kind for s in spans].count("TERMINAL") == 1
        assert spans[0].kind == "SUBMIT" and spans[-1].kind == "TERMINAL"
        marks = [s for s in spans if s.kind in ("RETRY", "MIGRATE")]
        assert len(marks) == r.retries + r.migrations
        body = [s for s in spans if s.kind not in ("SUBMIT", "TERMINAL")]
        attempts = sorted({s.attempt for s in body})
        assert attempts == list(range(len(attempts)))
        for a, b in zip(attempts, attempts[1:]):
            assert max(s.t1 for s in body if s.attempt == a) <= \
                min(s.t0 for s in body if s.attempt == b) + 1e-6
    if schedule in ("decode_crash", "prefill_crash", "handoff_corrupt",
                    "handoff_drop", "stage_error", "combined"):
        assert any(r.retries for r in reqs)
    slo = server.summary()["slo"]
    assert slo["n"] == len(reqs)
    assert cluster.group_summary()["slo"]["n"] == len(reqs)
    _check_port_trace(tracer, tmp_path)
    doc = json.loads((tmp_path / "trace.json").read_text())
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"cluster", "prefill0", "prefill1", "decode0",
            "decode1"} <= tracks
    assert {f"req {r.rid}" for r in reqs} <= tracks
    assert sum(e["ph"] == "i" and e["name"] == "TERMINAL"
               for e in doc["traceEvents"]) == len(reqs)


def _systems():
    return (tpipes.baseline(),
            thw.SystemConfig(n_servers=4, xpu=thw.XPU_C))


@pytest.mark.parametrize("how", ["drift", "resize"])
def test_controller_events_land_on_the_trace(stack, how):
    """One ``CONTROL:replan`` or ``CONTROL:resize`` instant per entry of
    ``controller.events``, on the cluster track; a drained engine's
    requests migrate with a MIGRATE event and a well-formed trace."""
    schema, system = _systems()
    plan = ServingPlan.optimize(schema, system)
    tracer = TT.SpanTracer()
    if how == "drift":
        cluster, factory = _control_cluster(stack, n_prefill=1, n_decode=1)
        server = RAGServer(cluster, tracer=tracer)
        ctl = ClusterController(
            server, schema, system, plan, engine_factory=factory,
            window_s=5.0, interval_s=0.0, reference_qps=0.25,
            load_detector=DriftDetector(band=0.5, clear_band=0.2,
                                        patience=2),
            max_engines=2, min_window_arrivals=2, settle_s=0.0)
        ctl.attach()
        reqs = [server.submit(q).request for q in stack[3]]
    else:
        cluster, factory = _control_cluster(stack)
        server = RAGServer(cluster, tracer=tracer)
        ctl = ClusterController(server, schema, system, plan,
                                engine_factory=factory)
        reqs = [server.submit(q).request for q in stack[3]]
        ctl.resize(2, 3)
        added = cluster.decode_engines[2]
        for _ in range(200):
            server.step()
            if added.active:
                break
        assert added.active
        ctl.resize(2, 2)                       # drains the added engine
    server.run_until_idle(max_steps=5000)
    assert all(r.state is State.DONE for r in reqs)
    assert TT.validate_spans(tracer, reqs) == []
    control = [s for s in tracer.spans() if s.kind.startswith("CONTROL:")]
    assert [s.kind for s in control] == \
        [f"CONTROL:{e['event']}" for e in ctl.events]
    assert all(s.rid is None and s.engine is None for s in control)
    assert ctl.resizes >= 1
    if how == "drift":
        assert ctl.replans >= 1
    else:
        assert cluster.metrics["requests_migrated"] >= 1
        migrated = [s for s in tracer.spans() if s.kind == "MIGRATE"]
        assert len(migrated) == sum(r.migrations for r in reqs) >= 1
    assert all(_plain(s.attrs) for s in control)


#: the collocated engines of the null-tracer test: chunked prefill, and
#: whole prefills with iterative appends (the cluster prefills whole)
NULL_ENGINES = {"engine": {"prefill_chunk": 8},
                "iterative": {"iterative_interval": 2}}


@pytest.mark.parametrize("target", ["cluster", "engine", "iterative"])
def test_tracing_off_constructs_no_spans(stack, target, monkeypatch):
    """Zero cost when off: with the default no-op tracer the serving path,
    its sub-stage spans included, never builds a ``Span``."""
    def boom(*a, **kw):
        raise AssertionError("Span constructed with tracing off")

    monkeypatch.setattr(TT, "Span", boom)
    gen, enc, corpus, questions = stack
    if target in NULL_ENGINES:
        eng = te.RAGEngine(_port(gen), _port(enc), corpus,
                           te.EngineConfig(decode_slots=2, s_max=96,
                                           max_new_tokens=4,
                                           **NULL_ENGINES[target]),
                           device="cpu")
        server = RAGServer(eng)
        engines = [eng]
    else:
        inj = FaultInjector(FaultPlan.from_schedule(
            CHAOS_SCHEDULES["combined"], seed=7))
        cluster = _chaos_cluster(stack, inj)
        server = RAGServer(cluster)
        engines = cluster.prefill_engines + cluster.decode_engines
        assert inj.tracer is TT.NULL_TRACER
    assert server.tracer is TT.NULL_TRACER
    assert all(e.tracer is TT.NULL_TRACER for e in engines)
    handles = [server.submit(q, max_new_tokens=4) for q in questions[:3]]
    server.run_until_idle(max_steps=5000)
    assert all(h.request.state in TERMINAL_STATES for h in handles)
    assert all(h.request.tracer is None for h in handles)
    assert "slo" not in server.summary()
