"""Serving telemetry for the port: spans, metrics, exporters, SLO attribution.

A copy of ``repro.serving.telemetry`` (the port imports nothing of the JAX
package), pure Python: nothing here touches a tensor.

* **Span tracer** -- every request carries an ordered sequence of typed
  spans (``SUBMIT``, ``ADMIT``, ``EMBED``, ``RETRIEVE``, ``STAGE:<name>``,
  ``PREFILL``, ``PREFILL_CHUNK``, ``HANDOFF``, ``DECODE``, ``DECODE_TICK``,
  ``RETRY``, ``MIGRATE``, ``TERMINAL``) with monotonic start/end times,
  the engine track that produced them, the decode tick number, the retry
  attempt, and payload sizes in ``attrs``.  Tracing is zero-cost when off
  (the default :data:`NULL_TRACER` no-ops every call behind an
  ``enabled`` flag checked at each instrumentation point) and
  bounded-memory when on (:class:`SpanTracer` keeps a ring buffer and
  counts overwritten spans in ``dropped``).

* **Metrics registry** -- :class:`MetricsRegistry`: typed
  :class:`Counter`/:class:`CounterFamily` cells behind the
  ``metrics["x"] += 1`` dict interface, and ``observe()`` into
  fixed-boundary :class:`Histogram` s.

* **Exporters** -- :func:`export_perfetto` writes a Chrome/Perfetto
  ``trace.json`` (one track per engine, one per request, controller and
  fault events as instants); :func:`export_jsonl` / :func:`load_spans`
  round-trip the raw span log.

* **SLO attribution** -- :func:`request_breakdown` folds a request's spans
  into per-stage wall time (queue vs retrieve vs prefill vs handoff vs
  decode), :func:`slo_attribution` divides by the deadline budget, and
  :func:`slo_summary` aggregates across requests including the p99-TTFT
  request decomposed by stage.

All timestamps use ``time.monotonic`` -- the same clock as the request
lifecycle timestamps (``t_arrive``/``t_first_token``/``t_done``), so spans
and request fields are directly comparable (see :func:`derive_latencies`).

Spans are host time.  On a CUDA device the host runs ahead of the card,
and a span closes when the host returns, not when the card finishes its
work.  ``PREFILL``, ``DECODE_TICK`` and ``RETRIEVE`` each end in a read of
their result on the host, so they cover their device work.  ``EMBED``
returns the query vectors on the device without reading them, so the
encoder's device time lands in the ``RETRIEVE`` span that follows it, as
it does under JAX's asynchronous dispatch.

Inside its stages the port's engine records sub-stage spans, kinds
``STAGE:<stage>.<part>``, on its own track: ``decode.prepare``,
``decode.launch``, ``decode.read`` and ``decode.retire`` tile a
``DECODE_TICK``; ``prefill.launch``, ``prefill.write`` and
``prefill.read`` a prefill; ``append.prepare`` and ``append.launch`` a
paged append or prefill chunk.  They are for the trace alone: they feed
neither ``stage_time_s`` nor the stage histograms.

Tracing adds no synchronisation.  Of the engine's counters,
``host_syncs`` counts the reads of a result on the host and
``h2d_copies`` the copies of host arrays to the device.  On a GPU such a
copy, from pageable memory, also waits for the device's queue to drain
(PyTorch synchronises the stream after it), so a decode tick holds one
read and, on the paged pool, four such copies.
"""

from __future__ import annotations

import bisect
import json
import math
import time
from collections.abc import MutableMapping
from dataclasses import dataclass

MONO = time.monotonic

# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

#: Span kinds that represent a duration attributable to a pipeline stage.
#: Everything else (SUBMIT/ADMIT/RETRY/MIGRATE/TERMINAL/FAULT:*/CONTROL:*)
#: is an instant marker.
STAGE_SPAN_BUCKETS = {
    "EMBED": "embed",
    "RETRIEVE": "retrieve",
    "PREFILL": "prefill",
    "PREFILL_CHUNK": "prefill",
    "HANDOFF": "handoff",
    "DECODE": "decode",
}


def stage_kind(stage: str) -> str:
    """Map an engine ``_timed`` stage name onto a span kind."""
    return {
        "embed": "EMBED",
        "retrieve": "RETRIEVE",
        "prefill": "PREFILL",
        "decode": "DECODE_TICK",
    }.get(stage, f"STAGE:{stage}")


@dataclass(slots=True)
class Span:
    """One traced interval (or instant, when ``t1 == t0``)."""

    kind: str
    t0: float
    t1: float | None = None
    rid: int | None = None
    engine: str | None = None
    tick: int = 0
    attempt: int = 0
    attrs: dict | None = None

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "t0": self.t0, "t1": self.t1,
             "rid": self.rid, "engine": self.engine, "tick": self.tick,
             "attempt": self.attempt}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class _NullCtx:
    """Reusable no-op context manager (shared singleton -- no allocation)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The default tracer: every call is a no-op and allocates nothing.

    Hot paths guard on ``tracer.enabled`` so that with the null tracer the
    per-tick cost is one attribute read and a falsy branch.
    """

    __slots__ = ()
    enabled = False
    dropped = 0

    def event(self, kind, rid=None, engine=None, t=None, tick=0,
              attempt=0, attrs=None):
        return None

    def begin(self, kind, rid=None, engine=None, t=None, tick=0,
              attempt=0, attrs=None):
        return None

    def end(self, span, t=None, attrs=None):
        return None

    def end_kind(self, rid, kind, t=None, attrs=None):
        return None

    def record(self, kind, t0, t1, rid=None, engine=None, tick=0,
               attempt=0, attrs=None):
        return None

    def annotate(self, rid, **attrs):
        return None

    def close_open(self, rid, t=None, outcome=None):
        return None

    def terminal(self, rid, state, t=None):
        return None

    def spans(self):
        return []

    def spans_for(self, rid):
        return []

    def open_spans(self):
        return {}


#: Shared no-op tracer. Engines/clusters/servers default to this.
NULL_TRACER = NullTracer()


class SpanTracer:
    """Bounded-memory span recorder.

    Completed spans land in a ring buffer of ``capacity`` entries; once
    full, the oldest span is overwritten and ``dropped`` incremented, so a
    long traced run degrades to "most recent window" instead of growing
    without bound.  Open (begun, not yet ended) spans live in a per-request
    side table until ended or force-closed by :meth:`close_open`.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = True
        self.dropped = 0
        self._ring: list[Span] = []
        self._head = 0          # overwrite cursor once the ring is full
        self._open: dict[int, list[Span]] = {}

    # -- recording ---------------------------------------------------------

    def _commit(self, span: Span) -> Span:
        if len(self._ring) < self.capacity:
            self._ring.append(span)
        else:
            self._ring[self._head] = span
            self._head = (self._head + 1) % self.capacity
            self.dropped += 1
        return span

    def event(self, kind, rid=None, engine=None, t=None, tick=0,
              attempt=0, attrs=None) -> Span:
        """Record an instant marker (``t1 == t0``)."""
        t = MONO() if t is None else t
        return self._commit(Span(kind, t, t, rid, engine, tick, attempt,
                                 attrs))

    def record(self, kind, t0, t1, rid=None, engine=None, tick=0,
               attempt=0, attrs=None) -> Span:
        """Record an already-completed duration span."""
        return self._commit(Span(kind, t0, t1, rid, engine, tick, attempt,
                                 attrs))

    def begin(self, kind, rid=None, engine=None, t=None, tick=0,
              attempt=0, attrs=None) -> Span:
        """Open a span; it is committed to the ring when ended."""
        t = MONO() if t is None else t
        span = Span(kind, t, None, rid, engine, tick, attempt, attrs)
        if rid is not None:
            self._open.setdefault(rid, []).append(span)
        return span

    def end(self, span: Span, t=None, attrs=None) -> Span:
        """Close an open span and commit it."""
        if span.t1 is not None:          # already closed (e.g. by a retry)
            return span
        span.t1 = MONO() if t is None else t
        if attrs:
            span.attrs = {**(span.attrs or {}), **attrs}
        if span.rid is not None:
            stack = self._open.get(span.rid)
            if stack is not None:
                try:
                    stack.remove(span)
                except ValueError:
                    pass
                if not stack:
                    del self._open[span.rid]
        return self._commit(span)

    def end_kind(self, rid, kind, t=None, attrs=None) -> Span | None:
        """Close the most recent open span of ``kind`` for ``rid``."""
        for span in reversed(self._open.get(rid, ())):
            if span.kind == kind:
                return self.end(span, t=t, attrs=attrs)
        return None

    def annotate(self, rid, **attrs) -> None:
        """Attach attrs to the innermost open span of ``rid`` (e.g. payload
        sizes discovered mid-stage by an executor)."""
        stack = self._open.get(rid)
        if stack:
            span = stack[-1]
            span.attrs = {**(span.attrs or {}), **attrs}

    def close_open(self, rid, t=None, outcome=None) -> None:
        """Force-close every open span of ``rid`` (terminal state or the
        start of a new retry attempt)."""
        stack = self._open.pop(rid, None)
        if not stack:
            return
        t = MONO() if t is None else t
        for span in stack:
            span.t1 = t
            if outcome is not None:
                span.attrs = {**(span.attrs or {}), "closed_by": outcome}
            self._commit(span)

    def terminal(self, rid, state: str, t=None) -> None:
        """Close open spans and mark the request's single terminal event."""
        t = MONO() if t is None else t
        self.close_open(rid, t=t, outcome=state)
        self.event("TERMINAL", rid=rid, t=t, attrs={"state": state})

    # -- reading -----------------------------------------------------------

    def spans(self) -> list[Span]:
        """All committed spans, oldest first."""
        return self._ring[self._head:] + self._ring[:self._head]

    def spans_for(self, rid) -> list[Span]:
        out = [s for s in self.spans() if s.rid == rid]
        out.sort(key=lambda s: (s.t0, s.t1 if s.t1 is not None else s.t0))
        return out

    def open_spans(self) -> dict[int, list[Span]]:
        return {rid: list(stack) for rid, stack in self._open.items()}


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

#: Seconds-scale latency buckets (1e-4 .. 10 s, roughly x3 per step).
DEFAULT_TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3,
                        1.0, 3.0, 10.0)


class Counter:
    """Monotonically-intended scalar cell (assignment still allowed for
    compatibility with existing ``metrics[k] = 0`` resets)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value


class Histogram:
    """Fixed-boundary histogram: ``counts[i]`` counts observations
    ``<= bounds[i]``; the final bucket is the +inf overflow."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds=DEFAULT_TIME_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float | None:
        return (self.sum / self.count) if self.count else None

    def quantile(self, q: float) -> float | None:
        """Upper-bound estimate of the q-quantile from bucket counts (the
        overflow bucket reports the observed max)."""
        if not self.count:
            return None
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target and c:
                if i < len(self.bounds):
                    return min(self.bounds[i], self.max)
                return self.max
        return self.max

    def snapshot(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                "mean": self.mean,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


class CounterFamily(MutableMapping):
    """A labelled counter family (e.g. ``stage_time_s`` keyed by stage).

    Behaves like the plain dict it replaces -- ``fam[k] = fam.get(k, 0) +
    dt`` keeps working -- but snapshots deep-copy it.
    """

    __slots__ = ("_d",)

    def __init__(self, init=None):
        self._d = dict(init or {})

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v

    def __delitem__(self, k):
        del self._d[k]

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __repr__(self):
        return f"CounterFamily({self._d!r})"

    def snapshot(self) -> dict:
        return dict(self._d)


class MetricsRegistry(MutableMapping):
    """Typed metrics behind the old free-form-dict interface.

    ``reg["x"]`` reads a scalar (Counter) or the live
    :class:`CounterFamily`; ``reg["x"] = v`` writes through to the cell
    (creating a Counter for numbers, a CounterFamily for dicts).
    ``reg.observe(name, v)`` feeds a histogram.  ``reg.snapshot()`` returns
    a fully detached plain-dict copy including a ``"histograms"`` key.
    """

    def __init__(self, init=None):
        self._cells: dict = {}
        self._hists: dict[str, Histogram] = {}
        for k, v in dict(init or {}).items():
            self[k] = v

    # -- mapping interface -------------------------------------------------

    def __getitem__(self, k):
        cell = self._cells[k]
        if isinstance(cell, Counter):
            return cell.value
        return cell

    def __setitem__(self, k, v):
        cell = self._cells.get(k)
        if isinstance(cell, Counter):
            cell.value = v
        elif isinstance(cell, CounterFamily):
            if v is not cell:            # replace contents, keep identity
                cell._d = dict(v)
        elif isinstance(v, MutableMapping) or isinstance(v, dict):
            self._cells[k] = CounterFamily(v)
        elif isinstance(v, (Counter, CounterFamily)):
            self._cells[k] = v
        else:
            self._cells[k] = Counter(v)

    def __delitem__(self, k):
        del self._cells[k]

    def __iter__(self):
        return iter(self._cells)

    def __len__(self):
        return len(self._cells)

    def __repr__(self):
        return f"MetricsRegistry({self.snapshot()!r})"

    # -- histograms --------------------------------------------------------

    def histogram(self, name, bounds=DEFAULT_TIME_BUCKETS) -> Histogram:
        hist = self._hists.get(name)
        if hist is None:
            hist = self._hists[name] = Histogram(bounds)
        return hist

    def observe(self, name, value, bounds=DEFAULT_TIME_BUCKETS) -> None:
        self.histogram(name, bounds).observe(value)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Deep, detached copy: mutating the result never touches live
        cells (the historical ``metrics_snapshot`` aliasing bug)."""
        out = {}
        for k, cell in self._cells.items():
            if isinstance(cell, Counter):
                out[k] = cell.value
            else:
                out[k] = cell.snapshot()
        if self._hists:
            out["histograms"] = {k: h.snapshot()
                                 for k, h in self._hists.items()}
        return out


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def export_jsonl(tracer, path) -> int:
    """Write one JSON object per span; returns the number written."""
    spans = tracer.spans()
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.to_dict()) + "\n")
    return len(spans)


def load_spans(path) -> list[dict]:
    """Read a JSONL span log back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def export_perfetto(tracer, path=None) -> dict:
    """Build a Chrome/Perfetto ``trace.json`` document.

    Track layout:

    * ``pid 1`` ("engines") -- one thread per engine track, plus thread 0
      ("cluster") for engine-less events (controller re-plans/resizes,
      cluster-scope faults) rendered as instants.
    * ``pid 2`` ("requests") -- one thread per request id carrying its
      span timeline (stages, handoff, decode, retries, terminal).

    Duration spans become ``"X"`` complete events (ts/dur in µs relative
    to the first span); instants become ``"i"`` events.
    """
    spans = tracer.spans()
    events: list[dict] = []
    base = min((s.t0 for s in spans), default=0.0)

    engines = sorted({s.engine for s in spans if s.engine is not None})
    engine_tid = {name: i + 1 for i, name in enumerate(engines)}
    rids = sorted({s.rid for s in spans if s.rid is not None})

    events.append({"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                   "args": {"name": "engines"}})
    events.append({"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
                   "args": {"name": "cluster"}})
    for name, tid in engine_tid.items():
        events.append({"ph": "M", "pid": 1, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    events.append({"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
                   "args": {"name": "requests"}})
    for rid in rids:
        events.append({"ph": "M", "pid": 2, "tid": rid + 1,
                       "name": "thread_name", "args": {"name": f"req {rid}"}})

    for s in spans:
        if s.rid is not None:
            pid, tid = 2, s.rid + 1
        elif s.engine is not None:
            pid, tid = 1, engine_tid[s.engine]
        else:
            pid, tid = 1, 0
        args = dict(s.attrs or {})
        if s.engine is not None:
            args["engine"] = s.engine
        if s.attempt:
            args["attempt"] = s.attempt
        if s.tick:
            args["tick"] = s.tick
        ts = (s.t0 - base) * 1e6
        ev = {"name": s.kind, "pid": pid, "tid": tid, "ts": ts,
              "args": args}
        if s.t1 is not None and s.t1 > s.t0:
            ev["ph"] = "X"
            ev["dur"] = (s.t1 - s.t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)

    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"dropped_spans": tracer.dropped}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


# ---------------------------------------------------------------------------
# Well-formedness
# ---------------------------------------------------------------------------

def validate_spans(tracer, requests, eps=1e-6) -> list[str]:
    """Check the span well-formedness invariants; return violations.

    For every request that reached a terminal state:

    * every started span ended (no span of its rid is still open);
    * exactly one ``TERMINAL`` event;
    * every span nests within ``[SUBMIT.t0 - eps, TERMINAL.t1 + eps]``;
    * retry attempts are disjoint in time: all spans of attempt *n* end
      before any span of attempt *n+1* begins.

    If the ring buffer dropped spans the completeness checks (SUBMIT
    present, exactly-one-TERMINAL) are skipped -- the ring only promises
    the most recent window.
    """
    violations: list[str] = []
    open_by_rid = tracer.open_spans()
    complete = tracer.dropped == 0
    for req in requests:
        rid = req.rid
        state = getattr(req.state, "value", req.state)
        if state not in ("done", "expired", "failed"):
            continue
        if open_by_rid.get(rid):
            kinds = [s.kind for s in open_by_rid[rid]]
            violations.append(f"rid {rid}: open spans after terminal: "
                              f"{kinds}")
        spans = tracer.spans_for(rid)
        if not spans:
            if complete:
                violations.append(f"rid {rid}: no spans recorded")
            continue
        for s in spans:
            if s.t1 is None:
                violations.append(f"rid {rid}: committed span {s.kind} "
                                  "has no end time")
            elif s.t1 < s.t0 - eps:
                violations.append(f"rid {rid}: span {s.kind} ends before "
                                  "it starts")
        terminals = [s for s in spans if s.kind == "TERMINAL"]
        if complete:
            if len(terminals) != 1:
                violations.append(f"rid {rid}: {len(terminals)} TERMINAL "
                                  "events (want exactly 1)")
            submits = [s for s in spans if s.kind == "SUBMIT"]
            if len(submits) != 1:
                violations.append(f"rid {rid}: {len(submits)} SUBMIT "
                                  "events (want exactly 1)")
        if terminals and complete:
            lo = min(s.t0 for s in spans)
            hi = terminals[-1].t1
            for s in spans:
                if s.t1 is not None and s.t1 > hi + eps:
                    violations.append(
                        f"rid {rid}: span {s.kind} ends {s.t1 - hi:.6f}s "
                        "after TERMINAL")
        # retry attempts must not interleave
        by_attempt: dict[int, list[Span]] = {}
        for s in spans:
            if s.kind in ("SUBMIT", "TERMINAL"):
                continue
            by_attempt.setdefault(s.attempt, []).append(s)
        attempts = sorted(by_attempt)
        for a, b in zip(attempts, attempts[1:]):
            end_a = max(s.t1 for s in by_attempt[a] if s.t1 is not None)
            start_b = min(s.t0 for s in by_attempt[b])
            if start_b < end_a - eps:
                violations.append(
                    f"rid {rid}: attempt {b} starts before attempt {a} "
                    "ends (span sequences not disjoint)")
    return violations


# ---------------------------------------------------------------------------
# SLO attribution
# ---------------------------------------------------------------------------

def _bucket_of(span: Span) -> str | None:
    if span.kind in STAGE_SPAN_BUCKETS:
        return STAGE_SPAN_BUCKETS[span.kind]
    if span.kind.startswith("STAGE:"):
        return span.kind.split(":", 1)[1]
    return None


def request_breakdown(tracer, req) -> dict:
    """Fold a request's spans into per-stage wall time.

    Returns ``{"total_s", "queue_s", "stages_s": {stage: s}}`` where
    ``queue_s`` is the residual of the request lifetime not covered by any
    stage span (admission queueing, retry backoff, decode-slot wait).
    """
    spans = tracer.spans_for(req.rid)
    t_submit = next((s.t0 for s in spans if s.kind == "SUBMIT"),
                    req.t_arrive)
    t_end = next((s.t1 for s in reversed(spans) if s.kind == "TERMINAL"),
                 req.t_done)
    stages: dict[str, float] = {}
    covered = 0.0
    for s in spans:
        bucket = _bucket_of(s)
        if bucket is None or s.t1 is None:
            continue
        dur = s.t1 - s.t0
        stages[bucket] = stages.get(bucket, 0.0) + dur
        if bucket != "decode" or s.kind == "DECODE":
            covered += dur
    # DECODE (slot residency) already covers its DECODE_TICK ticks; avoid
    # double-counting the residual ("queue") computation.
    total = (t_end - t_submit) if (t_end is not None
                                   and t_submit is not None) else 0.0
    queue = max(total - covered, 0.0)
    return {"total_s": total, "queue_s": queue, "stages_s": stages}


def slo_attribution(tracer, req) -> dict:
    """Per-stage share of the request's deadline budget (falls back to its
    total latency when no deadline was set)."""
    b = request_breakdown(tracer, req)
    budget = None
    if req.deadline is not None and req.t_arrive is not None:
        budget = max(req.deadline - req.t_arrive, 1e-9)
    denom = budget if budget else max(b["total_s"], 1e-9)
    frac = {k: v / denom for k, v in b["stages_s"].items()}
    frac["queue"] = b["queue_s"] / denom
    return {"state": getattr(req.state, "value", req.state),
            "total_s": b["total_s"], "budget_s": budget,
            "stages_s": {**b["stages_s"], "queue": b["queue_s"]},
            "budget_frac": frac}


def slo_summary(tracer, requests, pct=99.0) -> dict:
    """Aggregate SLO attribution across terminal requests.

    Returns mean per-stage seconds over all terminal requests, the same
    restricted to EXPIRED requests (where the deadline budget went), and
    the p99-TTFT request's pre-first-token decomposition.
    """
    terminal = [r for r in requests
                if getattr(r.state, "value", r.state) in
                ("done", "expired", "failed")]
    if not terminal:
        return {"n": 0}

    def _mean_stages(rs):
        acc: dict[str, float] = {}
        for r in rs:
            b = request_breakdown(tracer, r)
            for k, v in b["stages_s"].items():
                acc[k] = acc.get(k, 0.0) + v
            acc["queue"] = acc.get("queue", 0.0) + b["queue_s"]
        return {k: v / len(rs) for k, v in acc.items()}

    out = {"n": len(terminal), "mean_stage_s": _mean_stages(terminal)}
    expired = [r for r in terminal
               if getattr(r.state, "value", r.state) == "expired"]
    if expired:
        out["expired_mean_stage_s"] = _mean_stages(expired)
        out["n_expired"] = len(expired)

    with_ttft = [r for r in terminal if r.ttft is not None]
    if with_ttft:
        with_ttft.sort(key=lambda r: r.ttft)
        idx = min(len(with_ttft) - 1,
                  max(0, math.ceil(pct / 100.0 * len(with_ttft)) - 1))
        worst = with_ttft[idx]
        b = request_breakdown(tracer, worst)
        pre = {k: v for k, v in b["stages_s"].items() if k != "decode"}
        pre["queue"] = b["queue_s"]
        out["ttft_p99_s"] = worst.ttft
        out["ttft_p99_rid"] = worst.rid
        out["ttft_p99_breakdown_s"] = pre
    return out


# ---------------------------------------------------------------------------
# Span-vs-timestamp cross-check
# ---------------------------------------------------------------------------

def derive_latencies(tracer, req) -> dict:
    """Re-derive TTFT/TPOT purely from spans, for cross-checking against
    the ``Request`` timestamp fields.

    TTFT: end of the last PREFILL/PREFILL_CHUNK span minus SUBMIT -- the
    last attempt's prefill is the one that produced the surviving first
    token (earlier attempts were reset by :meth:`Request.reset_for_retry`).
    TPOT: decode-slot residency of the final attempt divided by the number
    of decoded steps after the first token.
    """
    spans = tracer.spans_for(req.rid)
    t_submit = next((s.t0 for s in spans if s.kind == "SUBMIT"), None)
    out: dict = {"ttft": None, "tpot": None}
    pf_ends = [s.t1 for s in spans
               if s.kind in ("PREFILL", "PREFILL_CHUNK")
               and s.t1 is not None]
    if pf_ends and t_submit is not None:
        out["ttft"] = max(pf_ends) - t_submit
    decodes = [s for s in spans if s.kind == "DECODE" and s.t1 is not None]
    n = len(req.output)
    if decodes and n > 1:
        last = max(decodes, key=lambda s: s.t0)
        out["tpot"] = (last.t1 - last.t0) / (n - 1)
    return out
