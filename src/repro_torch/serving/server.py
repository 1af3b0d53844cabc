"""Open-loop streaming front-end over the port's engine or cluster (mirror
of ``repro.serving.server``).

``RAGEngine`` owns the execution machinery; ``RAGServer`` owns traffic:
requests are submitted one at a time with their own arrival timestamps
(open loop), may carry a deadline, and stream their tokens back through a
callback or an iterator on the returned :class:`RequestHandle`.

    server = RAGServer(engine)        # or RAGServer.from_plan(plan, ...)
    h = server.submit(question, max_new_tokens=32)
    for tok in h.tokens():                     # drives the server
        ...
    server.run_until_idle()                    # or step() from a caller loop

``step()`` advances the engine by exactly one continuous-batching tick, so
a server fed every request up front gives the same tokens as the engine's
closed-batch ``serve(list)``.  Deadlines are absolute ``time.monotonic``
seconds; a request whose deadline passes while it is still queued ends
``State.EXPIRED`` and is never prefilled.

Topology: the server fronts either ONE collocated engine --
``RAGServer(engine)`` -- or a disaggregated
:class:`~repro_torch.serving.cluster.RAGCluster` -- ``RAGServer(cluster)``
/ ``RAGServer.from_cluster`` / ``RAGServer.from_plan(...,
topology="disagg")`` -- where prefill and decode engine groups exchange
requests through a KV-cache handoff.  Submission, streaming, deadline
screening and replay are the same on both; the cluster adds SLO-aware
admission and deadline-aware decode-slot scheduling underneath.
``add_step_hook`` is where a
:class:`~repro_torch.serving.controller.ClusterController` attaches.
``replay_trace`` replays a JSONL arrival trace
(``repro_torch.serving.trace``) against the wall clock.  ``set_tracer``
(or the ``tracer`` argument) installs a
:class:`~repro_torch.serving.telemetry.SpanTracer` across the deployment;
``summary()["slo"]`` then attributes each request's time to its stages.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.serving.cluster import RAGCluster, percentiles
from repro_torch.serving.engine import RAGEngine
from repro_torch.serving.request import Request, State
from repro_torch.serving.telemetry import (NULL_TRACER, MetricsRegistry,
                                           slo_summary)


class RequestStalledError(RuntimeError):
    """The server went idle while a request was still non-terminal."""


class RequestHandle:
    """Caller-side view of one submitted request."""

    def __init__(self, server: "RAGServer", request: Request,
                 on_token: Callable[["RequestHandle", int], None] | None):
        self.server = server
        self.request = request
        self._on_token = on_token
        self._streamed: list[int] = []

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def state(self) -> State:
        return self.request.state

    @property
    def done(self) -> bool:
        return self.request.done

    @property
    def output(self) -> list[int]:
        return list(self.request.output)

    @property
    def streamed(self) -> list[int]:
        """Tokens delivered so far, in stream order."""
        return list(self._streamed)

    def _deliver(self) -> int:
        """Stream any newly generated tokens (fires the callback)."""
        new = self.request.output[len(self._streamed):]
        for tok in new:
            self._streamed.append(tok)
            if self._on_token is not None:
                self._on_token(self, tok)
        return len(new)

    def tokens(self) -> Iterator[int]:
        """Per-token stream.  Iterating drives the server until this
        request is terminal; raises :class:`RequestStalledError` if the
        server goes idle with the request still in flight."""
        i = 0
        while True:
            while i < len(self._streamed):
                yield self._streamed[i]
                i += 1
            if self.done:
                return
            if not self.server.step() and not self.done \
                    and len(self._streamed) == i:
                raise RequestStalledError(
                    f"server idle with request {self.rid} still in state "
                    f"{self.state.value!r}; it will never reach a "
                    f"terminal state")

    def result(self) -> Request:
        """Drive the server until this request is terminal; return it."""
        for _ in self.tokens():
            pass
        if not self.done:
            raise RequestStalledError(
                f"request {self.rid} finished streaming in non-terminal "
                f"state {self.state.value!r}")
        return self.request


class RAGServer:
    """Open-loop serving front-end over one continuously batched
    :class:`~repro_torch.serving.engine.RAGEngine` or a disaggregated
    :class:`~repro_torch.serving.cluster.RAGCluster`."""

    def __init__(self, engine, tracer=None):
        """``engine``: a collocated :class:`~repro_torch.serving.engine.
        RAGEngine` or a :class:`~repro_torch.serving.cluster.RAGCluster`.
        ``tracer``: an optional :class:`~repro_torch.serving.telemetry.
        SpanTracer` installed across the deployment (default: inherit
        whatever the engine or cluster already carries -- the no-op
        tracer unless one was set)."""
        self.cluster = engine if isinstance(engine, RAGCluster) else None
        self.engine = None if self.cluster is not None else engine
        self.handles: dict[int, RequestHandle] = {}
        self._live: list[RequestHandle] = []
        self._step_hooks: list[Callable[["RAGServer"], None]] = []
        # server-level latency histograms (TTFT/TPOT/latency), fed as
        # requests reach terminal states in _deliver
        self.metrics = MetricsRegistry()
        if tracer is not None:
            self.set_tracer(tracer)
        else:
            self.tracer = (self.cluster or self.engine).tracer

    def set_tracer(self, tracer) -> None:
        """Install a span tracer on this server and the deployment under
        it (engine or whole cluster)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        (self.cluster or self.engine).set_tracer(self.tracer)

    def add_step_hook(self, fn: Callable[["RAGServer"], None]) -> None:
        """Register a callback fired after every :meth:`step` (idle steps
        included): the control plane's attachment point.  Hooks run on
        every tick, so they must be cheap and rate-limit themselves by
        wall clock."""
        self._step_hooks.append(fn)

    @property
    def cfg(self):
        return (self.cluster or self.engine).cfg

    @property
    def n_expired(self) -> int:
        return sum(1 for h in self.handles.values()
                   if h.request.state is State.EXPIRED)

    # ---------------- deployment -------------------------------------------

    @classmethod
    def from_plan(cls, plan, generative, encoder, corpus_tokens, *,
                  rewriter=None, reranker=None, safety=None,
                  topology: str = "single", n_prefill=None, n_decode=None,
                  device="cuda", **config_overrides) -> "RAGServer":
        """Deploy an optimizer-chosen :class:`~repro_torch.core.serving_plan.
        ServingPlan`: the plan's schema and schedule become the engine
        configuration (``plan.engine_config()``), the caller supplies the
        model components and the corpus.  ``config_overrides`` win last.

        ``topology="single"`` runs every stage on one collocated engine on
        ``device``; ``topology="disagg"`` instantiates the plan's
        placement as a :class:`~repro_torch.serving.cluster.RAGCluster`
        whose engines all live on ``device`` (prefill and decode groups
        sized by ``plan.group_sizes()`` unless ``n_prefill``/``n_decode``
        override them)."""
        if topology in ("disagg", "disaggregated"):
            return cls(RAGCluster.from_plan(
                plan, generative, encoder, corpus_tokens,
                rewriter=rewriter, reranker=reranker, safety=safety,
                n_prefill=n_prefill, n_decode=n_decode, device=device,
                **config_overrides))
        if topology not in ("single", "collocated"):
            raise ValueError(f"unknown topology {topology!r}")
        cfg = plan.engine_config(**config_overrides)
        engine = RAGEngine(generative, encoder, corpus_tokens, cfg,
                           rewriter=rewriter, reranker=reranker,
                           safety=safety, device=device)
        return cls(engine)

    @classmethod
    def from_cluster(cls, cluster: RAGCluster) -> "RAGServer":
        """Open-loop front-end over an existing disaggregated cluster."""
        return cls(cluster)

    # ---------------- submission -------------------------------------------

    def submit(self, question, max_new_tokens: int | None = None,
               deadline: float | None = None,
               arrival_time: float | None = None,
               on_token=None) -> RequestHandle:
        """Submit one question (open loop).  ``arrival_time`` defaults to
        now; ``deadline`` is absolute ``time.monotonic`` seconds."""
        req = Request(question=np.asarray(question, np.int32),
                      max_new_tokens=(max_new_tokens
                                      if max_new_tokens is not None
                                      else self.cfg.max_new_tokens),
                      deadline=deadline)
        return self.submit_request(req, arrival_time=arrival_time,
                                   on_token=on_token)

    def submit_request(self, req: Request,
                       arrival_time: float | None = None,
                       on_token=None) -> RequestHandle:
        """Submit a pre-built Request (the closed-batch ``serve()`` path)."""
        req.t_arrive = (arrival_time if arrival_time is not None
                        else time.monotonic())
        req.max_new_tokens = min(req.max_new_tokens,
                                 self.cfg.max_new_tokens)
        if self.tracer.enabled:
            # before dispatch: SLO-aware shedding may terminate the
            # request inside cluster.submit, and SUBMIT must precede it
            if req.tracer is None:
                req.tracer = self.tracer
            self.tracer.event("SUBMIT", rid=req.rid, t=req.t_arrive,
                              attrs={"q_tokens": int(len(req.question)),
                                     "deadline": req.deadline})
        if self.cluster is not None:
            self.cluster.submit(req)     # may shed (SLO-aware admission)
        else:
            self.engine.queue.append(req)
        handle = RequestHandle(self, req, on_token)
        self.handles[req.rid] = handle
        self._live.append(handle)
        return handle

    # ---------------- serving loop -----------------------------------------

    def _expire(self) -> None:
        """Drop queued requests whose deadline has passed (EXPIRED, never
        prefilled or decoded).  Single-engine path: the cluster runs its
        own deadline sweep over its waiting pools."""
        queue = self.engine.queue
        if not any(r.deadline is not None for r in queue):
            return
        now = time.monotonic()
        keep = []
        for req in queue:
            if req.deadline is not None and now > req.deadline:
                req.state = State.EXPIRED
                req.t_done = now
            else:
                keep.append(req)
        queue[:] = keep

    def _deliver(self) -> None:
        still = []
        for h in self._live:
            h._deliver()
            if h.done:
                self._observe_terminal(h.request)
            else:
                still.append(h)
        self._live = still

    def _observe_terminal(self, req: Request) -> None:
        """Feed the latency histograms once per request."""
        if req.ttft is not None:
            self.metrics.observe("ttft_s", req.ttft)
        if req.latency is not None:
            self.metrics.observe("latency_s", req.latency)
        if (req.state is State.DONE and req.ttft is not None
                and len(req.output) > 1):
            self.metrics.observe(
                "tpot_s", (req.latency - req.ttft) / (len(req.output) - 1))

    def _busy(self) -> bool:
        if self.cluster is not None:
            return self.cluster.busy
        return bool(self.engine.queue or self.engine.active)

    def step(self) -> bool:
        """One serving iteration + token delivery, then the step hooks.
        Single engine: admit -> chunked-prefill advance -> iterative
        dispatch -> decode.  Cluster: health and deadline sweeps ->
        prefill dispatch -> KV handoff and decode-slot assignment -> decode
        tick.  Returns True while work remains; idle calls dispatch
        nothing."""
        if self.cluster is not None:
            more = self.cluster.step()
        else:
            self._expire()
            more = self._busy()
            if more:
                self.engine.tick()
                more = self._busy()
        self._deliver()
        for fn in self._step_hooks:
            fn(self)
        return more

    def _flush(self) -> None:
        """Force out sub-batch iterative retrievals (drain tail)."""
        if self.cluster is not None:
            self.cluster.flush()
        else:
            self.engine._dispatch_iterative(force=True)

    def _abort(self, req: Request, reason: str, now=None) -> None:
        if self.cluster is not None:
            self.cluster.abort_request(req, reason, now)
        else:
            self.engine.abort_request(req, reason, now)

    def run_until_idle(self, max_steps: int = 10000) -> int:
        """Drain all submitted work; returns the steps taken.  Requests
        still in flight when the budget runs out end ``State.FAILED``
        (their slots released), so every submitted request ends
        terminal."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        self._flush()
        self._deliver()
        if self._busy():
            now = time.monotonic()
            for h in list(self.handles.values()):
                if not h.request.done:
                    self._abort(h.request,
                                f"step budget exhausted after {steps} steps",
                                now)
            self._deliver()
        return steps

    # ---------------- open-loop replay --------------------------------------

    def replay(self, questions, offsets, *, max_new_tokens=None,
               deadline=None, on_token=None,
               max_steps: int = 1_000_000) -> list[RequestHandle]:
        """Open-loop trace replay against the wall clock: submission ``i``
        arrives ``offsets[i]`` seconds after the replay starts, whether or
        not earlier requests finished.  ``deadline`` is relative seconds
        from each arrival.  ``max_new_tokens`` and ``deadline`` may be
        scalars or per-request sequences (None entries take the server
        defaults)."""
        offsets = np.asarray(offsets, float)
        n = len(questions)

        def per_request(v):
            if v is None or np.isscalar(v):
                return [v] * n
            if len(v) != n:
                raise ValueError(f"per-request field has {len(v)} entries "
                                 f"for {n} questions")
            return list(v)

        mnt = per_request(max_new_tokens)
        dls = per_request(deadline)
        t0 = time.monotonic()
        handles: list[RequestHandle] = []
        i, steps = 0, 0
        while i < n or self._busy():
            now = time.monotonic()
            while i < n and t0 + offsets[i] <= now:
                at = t0 + float(offsets[i])
                handles.append(self.submit(
                    questions[i], max_new_tokens=mnt[i],
                    deadline=(at + dls[i]) if dls[i] is not None else None,
                    arrival_time=at, on_token=on_token))
                i += 1
            if not self.step() and i < n:
                # idle until the next arrival (poll at most every 5 ms)
                time.sleep(max(0.0, min(
                    t0 + offsets[i] - time.monotonic(), 0.005)))
            steps += 1
            if steps >= max_steps:
                break
        self._flush()
        self._deliver()
        return handles

    def replay_trace(self, trace, *, on_token=None,
                     max_new_tokens=None, deadline=None,
                     max_steps: int = 1_000_000) -> list[RequestHandle]:
        """Replay a JSONL arrival-trace file (or a list of
        :class:`~repro_torch.serving.trace.TraceEntry`) against the wall
        clock.  Per-entry ``max_new_tokens``/``deadline_s`` win over the
        ``max_new_tokens``/``deadline`` defaults given here."""
        from repro_torch.serving.trace import TraceEntry, load_trace
        if not (entries := trace if isinstance(trace, (list, tuple))
                else load_trace(trace)):
            return []
        if not all(isinstance(e, TraceEntry) for e in entries):
            raise TypeError("replay_trace takes a trace file or a list of "
                            "TraceEntry")
        return self.replay(
            [e.question for e in entries],
            [e.arrival_s for e in entries],
            max_new_tokens=[e.max_new_tokens if e.max_new_tokens is not None
                            else max_new_tokens for e in entries],
            deadline=[e.deadline_s if e.deadline_s is not None
                      else deadline for e in entries],
            on_token=on_token, max_steps=max_steps)

    # ---------------- reporting --------------------------------------------

    def summary(self, *, window_s: float | None = None,
                now: float | None = None) -> dict:
        """Means plus the p50/p95/p99 tail over everything submitted, or
        over a rolling window of ``window_s`` seconds ending at ``now``."""
        now = time.monotonic() if now is None else now
        cutoff = None if window_s is None else now - window_s

        def in_win(t):
            return t is not None and (cutoff is None or t >= cutoff)

        reqs = [h.request for h in self.handles.values()]
        arrived = [r for r in reqs if cutoff is None or r.t_arrive >= cutoff]
        done = [r for r in reqs if r.state is State.DONE and in_win(r.t_done)]
        ttfts = [r.ttft for r in reqs
                 if r.ttft is not None and in_win(r.t_first_token)]
        tpots = [(r.latency - r.ttft) / (len(r.output) - 1)
                 for r in done if r.ttft is not None and len(r.output) > 1]
        if cutoff is None:
            span = (max((r.t_done for r in done), default=0.0)
                    - min((r.t_arrive for r in reqs), default=0.0))
            offered_span = span
        else:
            span = offered_span = window_s
        out = {
            "n_submitted": len(reqs),
            "n_arrived": len(arrived),
            "n_done": len(done),
            "n_expired": self.n_expired,
            "window_s": window_s,
            "qps": len(done) / span if span > 0 else 0.0,
            "offered_qps": (len(arrived) / offered_span
                            if offered_span > 0 else 0.0),
            "ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "tpot_s": float(np.mean(tpots)) if tpots else None,
        }
        for key, vals in (("ttft", ttfts), ("tpot", tpots)):
            for p, v in percentiles(vals).items():
                out[f"{key}_{p}_s"] = v
        hists = self.metrics.snapshot().get("histograms")
        if hists:
            out["hist"] = hists
        if self.tracer.enabled:
            # span-derived deadline-budget attribution per stage,
            # including the p99-TTFT request decomposed by stage
            out["slo"] = slo_summary(self.tracer, reqs)
        return out


def poisson_offsets(rate_qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process at
    ``rate_qps`` -- the open-loop traffic model."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
