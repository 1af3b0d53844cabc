"""Disaggregated RAG serving cluster on PyTorch/CUDA (mirror of
``repro.serving.cluster``): prefill and decode engine groups connected by
an explicit KV-cache handoff.

RAGO's headline optimization axis is *task placement* -- whether the
pre-decode stages (rewrite, embed/retrieve, rerank, safety, prefill) share
chips with the continuous-batching decode loop or run on their own group.
``ServingPlan`` records that decision (``placement`` + the chip split);
:class:`RAGCluster` instantiates it: N prefill engines run every
prefill-group stage of the registry's routing
(``REGISTRY.route_groups(schema)``), M decode engines own decode slots and
the mid-generation work (iterative retrieval dispatch + safety screening of
iteratively retrieved content), and a finished prefill travels to a decode
slot as an exported KV-cache prefix (``export_slot`` / ``import_slot`` --
bit-exact, so a 1+1 cluster is token-for-token identical to the collocated
single-engine ``RAGServer``).  With the default paged pools the handoff is
page-granular: the payload carries per-page chain keys, the importing pool
references pages its prefix cache already holds instead of writing them,
and only the rest counts as shipped -- ``handoff_bytes`` (shipped, counted
only after a confirmed import) vs ``handoff_bytes_full`` (what a dense
whole-prefix export would move), plus ``handoff_pages`` /
``handoff_pages_shared`` page counts.

Scheduling, per :meth:`RAGCluster.step`:

* **SLO-aware admission** (at :meth:`submit`): a request whose deadline is
  already unmeetable under the plan-predicted TTFT is shed immediately
  (``State.EXPIRED`` before any compute).
* **Least-loaded prefill dispatch**: each step hands at most one queued
  request to each *healthy* prefill engine, least cumulative prompt
  tokens first.
* **Deadline-aware decode assignment**: handoffs wait in an
  earliest-deadline-first queue; free decode slots go to the most urgent
  request, on the healthy decode engine with the most free slots.  A
  request whose deadline passes while waiting here expires *between* the
  groups (``PREFILL -> HANDOFF -> EXPIRED``).

Fault tolerance (``repro_torch.serving.faults``): every engine carries a health
state (HEALTHY / DEGRADED / DEAD) and each step opens with a health sweep.
A dead prefill engine's mid-prefill request re-dispatches to a healthy
engine; a dead decode engine's in-slot requests re-enter the pipeline via
re-prefill, both under a bounded retry budget with exponential backoff
(``Request.retries`` / ``t_retry``, ``State.RETRYING``).  Handoff payloads
carry a CRC32 checksum computed at export and verified before import, so a
corrupt (or dropped) payload is rejected and retried instead of decoded.
Graceful degradation: the engines' retrieval fallback chain answers
through exact scan or no-context when the primary backend fails, and a
brownout policy sheds the lowest-urgency queued requests when healthy
decode capacity falls below the offered load.  The invariant the whole
layer enforces: **every submitted request reaches exactly one terminal
state (DONE / EXPIRED / FAILED) under any fault schedule**, with greedy
decode making a recovered request's tokens bit-identical to an unfaulted
run (retry parity).

Live resize (``repro_torch.serving.controller`` drives it; the primitives live
here): engine groups are mutable at runtime.  :meth:`add_prefill_engine` /
:meth:`add_decode_engine` attach a new engine under a stable per-group id;
:meth:`drain_engine` parks one in ``EngineHealth.DRAINING`` -- it stops
receiving new dispatch while the health sweep migrates its in-flight
requests via the same re-prefill path fault recovery uses (counted in
``Request.migrations``, NOT against the bounded fault-retry budget, so a
resize can never drop a request by exhausting retries) -- and the sweep
reaps fully drained engines out of their group (``retired``).  Brownout
shedding is the only pressure valve mid-resize.  If a crash races a
resize and a group's last alive engines are all DRAINING, their drains
are aborted (``undrain`` -> DEGRADED) instead of failing queued work.

Requests are driven through the same open-loop front-end as the single
engine: ``RAGServer(cluster)`` (or ``RAGServer.from_plan(...,
topology="disagg")``) gives submission, streaming, deadlines and trace
replay on top of this class.  Tail latency is first-class:
:meth:`group_summary` reports p50/p95/p99 TTFT per prefill engine and
p50/p95/p99 TPOT per decode engine, plus handoff traffic, shed counts,
per-engine health and the fault-layer counters -- lifetime by default, or
over a rolling window (``window_s=``) so a controller sees the current
regime instead of the whole run.

On the card the handoff moves through host memory: the prefill engine's
pool gathers the slot's pages on the device and copies them to the host
once (``export_slot``), the payload is checksummed there, and the decode
engine's pool verifies it and writes the pages it lacks with one copy back
(``import_slot``).  Each of the four steps is timed into its engine's
``stage_time_s`` (``export`` and ``checksum`` on the prefill engine,
``verify`` and ``import`` on the decode engine) and emits no span
(:meth:`RAGEngine._metered`), so a trace holds the JAX cluster's spans.
Every engine of a cluster runs on one device and one Python thread, so
on one card the groups take turns rather than run side by side.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np

from repro_torch.serving.engine import RAGEngine
from repro_torch.serving.faults import (EngineCrash, EngineHealth,
                                        FaultInjector, TransientStageError)
from repro_torch.serving.kv_cache import (payload_checksum, payload_nbytes,
                                          payload_summary)
from repro_torch.serving.request import Request, State
from repro_torch.serving.telemetry import (NULL_TRACER, MetricsRegistry,
                                           slo_summary)


def percentiles(values, digits: int = 5) -> dict:
    """p50/p95/p99 summary of a latency sample (empty -> None entries)."""
    out = {}
    for p in (50, 95, 99):
        out[f"p{p}"] = (round(float(np.percentile(values, p)), digits)
                        if len(values) else None)
    return out


class RAGCluster:
    """A ServingPlan's placement, instantiated: prefill engines + decode
    engines + the KV handoff, scheduler and fault-recovery layer between
    them."""

    def __init__(self, prefill_engines: list[RAGEngine],
                 decode_engines: list[RAGEngine], *,
                 predicted_ttft: float | None = None,
                 injector: FaultInjector | None = None,
                 max_retries: int = 3, retry_backoff: float = 0.02,
                 brownout_headroom: float | None = 8.0):
        """``max_retries`` bounds fault recoveries per request (then
        FAILED); ``retry_backoff`` is the base of the exponential backoff
        (``backoff * 2**retries`` seconds).  ``brownout_headroom``: once
        any engine is dead, queued requests beyond ``healthy decode slots
        * headroom`` are shed lowest-urgency-first (None disables)."""
        if not prefill_engines or not decode_engines:
            raise ValueError("need at least one engine per group")
        self.predicted_ttft = predicted_ttft
        self.injector = injector
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.brownout_headroom = brownout_headroom
        self.queue: list[Request] = []        # cluster admission queue
        # (req, kv_prefix, length, seq, checksum)
        self.handoff: list[tuple] = []
        self.retrying: list[Request] = []     # fault-recovery backoff pool
        self._seq = 0                         # FIFO tiebreak for EDF
        self.requests: list[Request] = []
        # engine groups are mutable at runtime (live resize): each engine
        # gets a stable per-group integer id at attach time (ids are never
        # reused), kept in a list parallel to the engine list, so every
        # bookkeeping map below survives engines joining or leaving
        self.prefill_engines: list[RAGEngine] = []
        self.decode_engines: list[RAGEngine] = []
        self._prefill_ids: list[int] = []
        self._decode_ids: list[int] = []
        self._next_eid = {"prefill": 0, "decode": 0}
        self.retired: list[tuple] = []        # (group, eid, engine)
        self._prefill_load: dict[int, int] = {}   # eid -> prompt tokens
        # rid -> engine id of the request's LATEST pass through the
        # group (deliberately overwritten on retry: the group summary
        # attributes the request to the engine that actually served it);
        # *_history keeps every pass for per-engine failure accounting
        self.prefill_of: dict[int, int] = {}
        self.decode_of: dict[int, int] = {}
        self.prefill_history: dict[int, list[int]] = {}
        self.decode_history: dict[int, list[int]] = {}
        self._dead_seen: set = set()          # (group, eid) counted once
        self.tracer = NULL_TRACER             # swapped in via set_tracer
        self.metrics = MetricsRegistry(
            {"shed_requests": 0, "expired_queued": 0,
             "expired_in_handoff": 0, "expired_retrying": 0,
             "handoffs": 0,
             # shipped at decode-slot assignment, counted only
             # after the import succeeded; pages the
             # destination pool already cached are referenced,
             # not transferred
             "handoff_bytes": 0, "handoff_pages": 0,
             "handoff_pages_shared": 0,
             # what a dense whole-prefix export would have moved
             "handoff_bytes_full": 0,
             # fault layer
             "engine_failures": 0, "requests_retried": 0,
             "retries_exhausted": 0, "handoff_corrupt": 0,
             "handoff_dropped": 0, "stage_errors": 0,
             "brownout_shed": 0, "failed_no_capacity": 0,
             "aborted": 0,
             # live resize
             "requests_migrated": 0, "engines_added": 0,
             "engines_removed": 0, "drains_aborted": 0})
        for eng in prefill_engines:
            self._attach("prefill", eng)
        for eng in decode_engines:
            self._attach("decode", eng)

    # ---------------- construction -----------------------------------------

    @classmethod
    def from_plan(cls, plan, generative, encoder, corpus_tokens, *,
                  rewriter=None, reranker=None, safety=None,
                  n_prefill: int | None = None, n_decode: int | None = None,
                  injector: FaultInjector | None = None,
                  max_retries: int = 3, retry_backoff: float = 0.02,
                  brownout_headroom: float | None = 8.0, device="cuda",
                  **config_overrides) -> "RAGCluster":
        """Instantiate a ServingPlan's placement as engine groups.

        Group sizes default to the plan's chip split
        (:meth:`~repro_torch.core.serving_plan.ServingPlan.group_sizes`);
        the offline corpus encode and the built retrieval index are shared
        across all engines.  Prefill engines hold one staging slot each (a
        prefill's cache is exported and the slot freed before the next
        admission); decode engines keep the plan's full ``decode_slots``.
        Every engine is built on ``device``."""
        cfg = plan.engine_config(**config_overrides)
        p_default, d_default = plan.group_sizes()
        n_p = n_prefill if n_prefill is not None else p_default
        n_d = n_decode if n_decode is not None else d_default
        kw = dict(rewriter=rewriter, reranker=reranker, safety=safety,
                  device=device)
        first = RAGEngine(generative, encoder, corpus_tokens,
                          replace(cfg, decode_slots=1), **kw)
        # one offline corpus encode and one built retrieval index serve
        # the whole cluster
        shared = dict(db_vectors=first.db_vectors, backend=first.backend,
                      **kw)
        prefill = [first] + [
            RAGEngine(generative, encoder, corpus_tokens,
                      replace(cfg, decode_slots=1), **shared)
            for _ in range(n_p - 1)]
        decode = [RAGEngine(generative, encoder, corpus_tokens, cfg,
                            **shared) for _ in range(n_d)]
        return cls(prefill, decode,
                   predicted_ttft=plan.predicted.get("ttft"),
                   injector=injector, max_retries=max_retries,
                   retry_backoff=retry_backoff,
                   brownout_headroom=brownout_headroom)

    @property
    def cfg(self):
        """Reference config (deadline clamps, max_new_tokens defaults)."""
        return self.decode_engines[0].cfg

    # ---------------- admission (SLO-aware) --------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue one request; shed it instantly if the plan-predicted
        TTFT says its deadline is already unmeetable (the optimizer's
        prediction doing admission control)."""
        if self.tracer.enabled and req.tracer is None:
            # direct submitters (no RAGServer in front) still get the
            # terminal-state span hook
            req.tracer = self.tracer
        self.requests.append(req)
        if (req.deadline is not None and self.predicted_ttft is not None
                and req.t_arrive + self.predicted_ttft > req.deadline):
            req.state = State.EXPIRED
            req.t_done = time.monotonic()
            self.metrics["shed_requests"] += 1
            return
        self.queue.append(req)

    # ---------------- engine groups (live resize) ---------------------------

    def _attach(self, group: str, eng: RAGEngine) -> int:
        """Attach one engine to a group under a fresh stable id (ids are
        per-group and never reused, so bookkeeping keyed by id survives
        any add/remove sequence)."""
        eid = self._next_eid[group]
        self._next_eid[group] = eid + 1
        if group == "prefill":
            self.prefill_engines.append(eng)
            self._prefill_ids.append(eid)
            self._prefill_load[eid] = 0
        else:
            self.decode_engines.append(eng)
            self._decode_ids.append(eid)
        if self.injector is not None:
            eng.set_injector(self.injector)
        eng.trace_name = f"{group}{eid}"      # stable span track id
        eng.set_tracer(self.tracer)
        return eid

    def set_tracer(self, tracer) -> None:
        """Install one span tracer across the whole cluster: every engine
        (live and future, via :meth:`_attach`) and the fault injector emit
        onto it.  ``None``/``NULL_TRACER`` turns tracing off."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        for eng in self.prefill_engines + self.decode_engines:
            eng.set_tracer(self.tracer)
        if self.injector is not None:
            self.injector.tracer = self.tracer

    def add_prefill_engine(self, eng: RAGEngine) -> int:
        """Grow the prefill group at runtime; returns the engine's stable
        id.  The engine must share the cluster's corpus encode/backend
        family (same contract as construction)."""
        self.metrics["engines_added"] += 1
        return self._attach("prefill", eng)

    def add_decode_engine(self, eng: RAGEngine) -> int:
        """Grow the decode group at runtime; returns the engine's stable
        id."""
        self.metrics["engines_added"] += 1
        return self._attach("decode", eng)

    def engine_id(self, eng: RAGEngine) -> tuple[str, int]:
        """(group, stable id) of an attached engine."""
        for group, engines, ids in (
                ("prefill", self.prefill_engines, self._prefill_ids),
                ("decode", self.decode_engines, self._decode_ids)):
            for eid, e in zip(ids, engines):
                if e is eng:
                    return group, eid
        raise ValueError("engine is not attached to this cluster")

    def drain_engine(self, eng: RAGEngine, *, force: bool = False) -> None:
        """Start a zero-drop removal: the engine goes DRAINING (no new
        dispatch), the next health sweep migrates its in-flight requests
        via the re-prefill path, and once empty it is reaped out of its
        group.  Refuses to drain the last accepting engine of a group
        (the group would go unservable) unless ``force=True``."""
        group, _eid = self.engine_id(eng)
        engines = (self.prefill_engines if group == "prefill"
                   else self.decode_engines)
        others = [e for e in engines if e is not eng and e.accepting]
        if not others and not force:
            raise ValueError(
                f"refusing to drain the last accepting {group} engine "
                f"(force=True overrides)")
        eng.drain()

    def _reap_drained(self) -> None:
        """Remove fully drained engines from their groups.  A DRAINING
        engine with no in-flight state (its migrated requests re-enter
        through the admission queue, never back onto it) is detached and
        recorded in ``retired``; its id stays valid in the bookkeeping
        maps, so history attribution survives the removal."""
        for group, engines, ids in (
                ("prefill", self.prefill_engines, self._prefill_ids),
                ("decode", self.decode_engines, self._decode_ids)):
            keep_e, keep_i = [], []
            for eid, eng in zip(ids, engines):
                if (eng.health is EngineHealth.DRAINING
                        and not eng.active and not eng.prefilling
                        and not eng.pending_retrievals):
                    self.retired.append((group, eid, eng))
                    self.metrics["engines_removed"] += 1
                else:
                    keep_e.append(eng)
                    keep_i.append(eid)
            engines[:] = keep_e
            ids[:] = keep_i

    # ---------------- fault detection / recovery ---------------------------

    def _note_dead(self, group: str, idx: int) -> None:
        if (group, idx) not in self._dead_seen:
            self._dead_seen.add((group, idx))
            self.metrics["engine_failures"] += 1

    def _schedule_retry(self, req: Request, reason: str,
                        now: float | None = None, *,
                        migration: bool = False) -> None:
        """Recover one in-flight request: back into the pipeline via
        re-prefill after an exponential backoff, unless its deadline
        passed or its retry budget is spent (then EXPIRED / FAILED --
        still exactly one terminal state).

        ``migration=True`` is the live-resize path (a drain evicting
        healthy work): no retry budget is charged or checked and the
        backoff is zero -- an operator resize must never be able to fail
        a request, so migration can only delay, not drop (the zero-drop
        invariant)."""
        if req.done:
            return
        now = time.monotonic() if now is None else now
        if req.deadline is not None and now > req.deadline:
            req.state = State.EXPIRED
            req.t_done = now
            self.metrics["expired_retrying"] += 1
            return
        if not migration and req.retries >= self.max_retries:
            req.state = State.FAILED
            req.fail_reason = f"retry budget exhausted ({reason})"
            req.t_done = now
            self.metrics["retries_exhausted"] += 1
            return
        backoff = (0.0 if migration
                   else self.retry_backoff * (2 ** req.retries))
        req.reset_for_retry(now, backoff, migration=migration)
        req.fail_reason = None
        key = "requests_migrated" if migration else "requests_retried"
        self.metrics[key] += 1
        self.retrying.append(req)

    def _requeue_retries(self, now: float) -> None:
        """Move retries whose backoff elapsed back into the admission
        queue (they re-run the full pipeline from the top)."""
        due = [r for r in self.retrying if now >= r.t_retry]
        if not due:
            return
        self.retrying = [r for r in self.retrying if now < r.t_retry]
        for req in due:
            req.state = State.QUEUED
            self.queue.append(req)

    def _evacuate_decode(self, eid: int, eng: RAGEngine, now: float, *,
                         migration: bool = False) -> None:
        """Recover every request holding state on a decode engine that can
        no longer serve it: slots are released (page refcounts return to
        idle -- the bookkeeping is host-side and survives a simulated
        crash) and the requests re-enter the pipeline via re-prefill.
        Two callers: a DEAD engine (fault path, charges the retry budget)
        and a DRAINING one (live resize, ``migration=True`` -- budget-free
        and backoff-free)."""
        if not migration:
            self._note_dead("decode", eid)
        reason = (f"decode engine {eid} draining" if migration
                  else f"decode engine {eid} died")
        for slot, req in list(eng.active.items()):
            eng.active.pop(slot)
            eng.prefilling.pop(slot, None)
            eng.pool.release(slot)
            self._schedule_retry(req, reason, now, migration=migration)
        eng.pending_retrievals.clear()

    def _health_sweep(self, now: float) -> None:
        """Step-phase health check: evacuate requests stranded on dead
        decode engines (retry path) and on DRAINING ones (migration
        path), abort drains that would leave a group with no accepting
        engine (a crash racing a resize), reap fully drained engines out
        of their groups, and fail fast when a whole group is gone (no
        healthy engine can ever serve them -- parking the requests
        forever would break the one-terminal-state invariant)."""
        for eid, eng in zip(self._decode_ids, self.decode_engines):
            if not eng.healthy:
                if eng.active or eng.pending_retrievals:
                    self._evacuate_decode(eid, eng, now)
                else:
                    self._note_dead("decode", eid)
            elif (eng.health is EngineHealth.DRAINING
                    and (eng.active or eng.pending_retrievals)):
                self._evacuate_decode(eid, eng, now, migration=True)
        for eid, eng in zip(self._prefill_ids, self.prefill_engines):
            if not eng.healthy:
                self._note_dead("prefill", eid)
        # resize racing a crash: never let a drain leave a group
        # unservable -- abort the drain (DRAINING -> DEGRADED) instead of
        # failing queued work
        for engines in (self.prefill_engines, self.decode_engines):
            if engines and not any(e.accepting for e in engines):
                for eng in engines:
                    if eng.health is EngineHealth.DRAINING:
                        eng.undrain()
                        self.metrics["drains_aborted"] += 1
        self._reap_drained()
        no_prefill = not any(e.healthy for e in self.prefill_engines)
        no_decode = not any(e.healthy for e in self.decode_engines)
        if no_prefill or no_decode:
            group = "prefill" if no_prefill else "decode"
            doomed = self.queue + self.retrying
            self.queue, self.retrying = [], []
            if no_decode:
                doomed += [item[0] for item in self.handoff]
                self.handoff = []
            for req in doomed:
                if req.done:
                    continue
                req.state = State.FAILED
                req.fail_reason = f"no healthy {group} engines"
                req.t_done = now
                self.metrics["failed_no_capacity"] += 1

    def _brownout(self, now: float) -> None:
        """Graceful degradation under lost capacity: once any engine has
        stopped accepting work (dead, or draining mid-resize), queued
        requests beyond ``accepting decode slots * headroom`` are shed
        lowest-urgency-first (no deadline sheds before latest deadline)
        so the survivors' tail SLOs stay defensible instead of everything
        timing out together.  This is the only pressure valve during a
        live resize."""
        if self.brownout_headroom is None:
            return
        engines = self.prefill_engines + self.decode_engines
        if all(e.accepting for e in engines):
            return
        cap = sum(e.cfg.decode_slots
                  for e in self.decode_engines if e.accepting)
        limit = int(cap * self.brownout_headroom)
        excess = len(self.queue) - limit
        if excess <= 0:
            return
        victims = sorted(
            self.queue,
            key=lambda r: (r.deadline is not None,
                           -(r.deadline if r.deadline is not None
                             else 0.0)))[:excess]
        victim_ids = {id(r) for r in victims}
        self.queue[:] = [r for r in self.queue if id(r) not in victim_ids]
        for req in victims:
            req.state = State.FAILED
            req.fail_reason = "brownout shed"
            req.t_done = now
            self.metrics["brownout_shed"] += 1

    def abort_request(self, req: Request, reason: str,
                      now: float | None = None) -> None:
        """Force one request to FAILED and release everything it holds
        anywhere in the cluster (queue, handoff, backoff pool, decode
        slot).  The last-resort terminal path (step budget exhausted)."""
        if req.done:
            return
        now = time.monotonic() if now is None else now
        # identity, not ==: Request is a dataclass over numpy fields
        self.queue[:] = [r for r in self.queue if r is not req]
        self.retrying = [r for r in self.retrying if r is not req]
        self.handoff = [it for it in self.handoff if it[0] is not req]
        for eng in self.decode_engines:
            for slot, r in list(eng.active.items()):
                if r is req:
                    eng.active.pop(slot)
                    eng.prefilling.pop(slot, None)
                    eng.pool.release(slot)
            eng.pending_retrievals = [r for r in eng.pending_retrievals
                                      if r is not req]
        req.state = State.FAILED
        req.fail_reason = reason
        req.t_done = now
        self.metrics["aborted"] += 1

    # ---------------- scheduler phases -------------------------------------

    def _expire(self, now: float) -> None:
        """Deadline sweep over every waiting pool (admission queue,
        handoff queue, retry backoff).  Requests already holding a decode
        slot run to completion (same policy as the single-engine
        server)."""
        keep = []
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                req.state = State.EXPIRED
                req.t_done = now
                self.metrics["expired_queued"] += 1
            else:
                keep.append(req)
        self.queue[:] = keep
        kept = []
        for item in self.handoff:
            req = item[0]
            if req.deadline is not None and now > req.deadline:
                req.state = State.EXPIRED       # HANDOFF -> EXPIRED
                req.t_done = now
                self.metrics["expired_in_handoff"] += 1
            else:
                kept.append(item)
        self.handoff[:] = kept
        still = []
        for req in self.retrying:
            if req.deadline is not None and now > req.deadline:
                req.state = State.EXPIRED       # RETRYING -> EXPIRED
                req.t_done = now
                self.metrics["expired_retrying"] += 1
            else:
                still.append(req)
        self.retrying[:] = still

    def _run_prefill(self, eid: int, eng: RAGEngine, req: Request) -> None:
        """Full prefill-group pass on engine ``eid``: executors, prompt
        assembly, bucketed prefill, then KV export + slot release.  The
        request leaves in ``HANDOFF`` carrying its exported cache prefix
        and its checksum.  The staging slot is released on EVERY path
        (``finally``), so an exception can never leak it; the caller
        (:meth:`_dispatch_prefill`) classifies the failure and recovers
        the request."""
        if self.tracer.enabled:
            self.tracer.event("ADMIT", rid=req.rid, engine=eng.trace_name,
                              attempt=req.retries + req.migrations)
        inj = self.injector
        if inj is not None and inj.fire("stage_error", engine=eid,
                                        rid=req.rid):
            raise TransientStageError(
                f"injected stage error on prefill engine {eid}")
        for ex in eng.executors:
            with eng._timed(ex.name, req=req):
                ex.run(eng, req)
        req.prompt = eng._assemble_prompt(req)
        if inj is not None and inj.fire("prefill_crash", engine=eid,
                                        rid=req.rid):
            eng.fail("injected prefill crash")
            raise EngineCrash(f"prefill engine {eid} crashed mid-request")
        slot = eng.pool.alloc(req.rid)
        try:
            with eng._timed("prefill", req=req):
                eng.prefill_compute(req, slot)
            # ends in the copy to host memory, which waits for the device
            with eng._metered("export"):
                kv, length = eng.pool.export_slot(slot)
        finally:
            eng.pool.release(slot)
        # checksum at export; verified before import, so wire corruption
        # is rejected instead of decoded
        with eng._metered("checksum"):
            checksum = payload_checksum(kv)
        full_bytes = payload_nbytes(kv)
        kv_summary = payload_summary(kv, length)   # before any injection
        if inj is not None:
            if inj.fire("handoff_drop", engine=eid, rid=req.rid):
                kv = None                      # lost "on the wire"
            elif inj.fire("handoff_corrupt", engine=eid, rid=req.rid):
                kv = inj.corrupt(kv)
        req.state = State.HANDOFF
        if self.tracer.enabled:
            # open until the decode-side import succeeds (or a retry /
            # expiry closes it): the span measures queue + transit time
            self.tracer.begin("HANDOFF", rid=req.rid, engine=eng.trace_name,
                              attempt=req.retries + req.migrations,
                              attrs=kv_summary)
        self.prefill_history.setdefault(req.rid, []).append(eid)
        self.prefill_of[req.rid] = eid
        self._prefill_load[eid] += len(req.prompt)
        self.metrics["handoffs"] += 1
        # full payload accounted here; what actually ships is known only
        # at import time (the destination may already cache some pages)
        self.metrics["handoff_bytes_full"] += full_bytes
        self.handoff.append((req, kv, length, self._seq, checksum))
        self._seq += 1

    def _dispatch_prefill(self) -> None:
        """Least-loaded dispatch over the ACCEPTING prefill engines
        (HEALTHY/DEGRADED -- a DRAINING engine sheds work, never gains
        it): at most one queued request per engine per step (load =
        cumulative prompt tokens processed), so a burst saturates the
        whole group instead of head-of-line blocking one engine.  A
        failure during the pass never wedges the cluster: the engine is
        marked (DEAD for a crash, DEGRADED for a transient error) and the
        request recovers through the retry path."""
        used: set[int] = set()
        while self.queue:
            ready = [(eid, e) for eid, e in zip(self._prefill_ids,
                                                self.prefill_engines)
                     if e.accepting and eid not in used]
            if not ready:
                break
            eid, eng = min(ready, key=lambda t: self._prefill_load[t[0]])
            used.add(eid)
            req = self.queue.pop(0)
            try:
                self._run_prefill(eid, eng, req)
            except EngineCrash:
                eng.fail("crashed mid-prefill")
                self._note_dead("prefill", eid)
                self._schedule_retry(req, f"prefill engine {eid} died")
            except Exception as e:      # transient stage error or a bug
                eng.degrade()
                self.metrics["stage_errors"] += 1
                self._schedule_retry(req, f"stage error: {e!r}")

    def _assign_decode(self) -> None:
        """Deadline-aware decode-slot assignment: earliest deadline first
        (FIFO among deadline-free requests), each placed on the healthy
        decode engine with the most free slots.  The payload checksum is
        verified first and traffic is charged only AFTER the import
        succeeded -- a corrupt, dropped or unimportable payload sends the
        request back through the retry path instead of decoding garbage
        (and never inflates ``handoff_bytes``)."""
        self.handoff.sort(key=lambda it: (
            it[0].deadline if it[0].deadline is not None else float("inf"),
            it[3]))
        waiting = []
        now = time.monotonic()
        for item in self.handoff:
            req, kv, length, _seq, checksum = item
            if kv is None:                     # payload lost in transit
                self.metrics["handoff_dropped"] += 1
                self._schedule_retry(req, "handoff payload dropped", now)
                continue
            ready = [(eid, e) for eid, e in zip(self._decode_ids,
                                                self.decode_engines)
                     if e.accepting]
            if not ready:
                waiting.append(item)           # health sweep will fail them
                continue
            eid, eng = max(ready, key=lambda t: len(t[1].pool.free))
            if not eng.pool.free:
                waiting.append(item)        # every healthy engine is full
                continue
            with eng._metered("verify"):
                intact = payload_checksum(kv) == checksum
            if not intact:
                self.metrics["handoff_corrupt"] += 1
                self._schedule_retry(req, "handoff payload corrupt", now)
                continue
            slot = eng.pool.alloc(req.rid)
            try:
                # the host-to-device copy waits for the device; the
                # indexed write after it is left queued
                with eng._metered("import"):
                    stats = eng.pool.import_slot(slot, kv, length)
            except Exception as e:             # malformed payload
                eng.pool.release(slot)
                self.metrics["handoff_corrupt"] += 1
                self._schedule_retry(req, f"handoff import failed: {e!r}",
                                     now)
                continue
            self.metrics["handoff_bytes"] += stats.nbytes
            self.metrics["handoff_pages"] += stats.pages
            self.metrics["handoff_pages_shared"] += stats.pages_shared
            req.slot = slot
            req.t_decode = time.monotonic()
            if self.tracer.enabled:
                self.tracer.end_kind(
                    req.rid, "HANDOFF", t=req.t_decode,
                    attrs={"bytes_shipped": stats.nbytes,
                           "pages": stats.pages,
                           "pages_shared": stats.pages_shared})
                self.tracer.begin("DECODE", rid=req.rid,
                                  engine=eng.trace_name, t=req.t_decode,
                                  attempt=req.retries + req.migrations,
                                  attrs={"slot": slot})
            req.state = State.DECODE
            eng.active[slot] = req
            self.decode_history.setdefault(req.rid, []).append(eid)
            self.decode_of[req.rid] = eid
        self.handoff[:] = waiting

    def _decode_tick(self) -> None:
        """One decode iteration per busy healthy decode engine (iterative
        retrieval dispatch + fused decode step).  An injected or detected
        crash drains the engine's requests back into the pipeline in the
        same step."""
        for eid, eng in zip(self._decode_ids, self.decode_engines):
            if not eng.healthy:
                continue
            if not (eng.active or eng.pending_retrievals):
                continue
            if self.injector is not None and self.injector.fire(
                    "decode_crash", engine=eid):
                eng.fail("injected decode crash")
                self._evacuate_decode(eid, eng, time.monotonic())
                continue
            try:
                eng._dispatch_iterative(
                    force=not any(r.state is State.DECODE
                                  for r in eng.active.values()))
                eng._decode_step()
            except EngineCrash:
                eng.fail("crashed mid-decode")
                self._evacuate_decode(eid, eng, time.monotonic())

    # ---------------- driving ----------------------------------------------

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.handoff or self.retrying
                    or any(e.active or e.pending_retrievals
                           for e in self.decode_engines))

    def step(self) -> bool:
        """One cluster iteration: health sweep -> deadline sweep -> retry
        requeue -> brownout -> prefill dispatch -> decode-slot assignment
        -> decode tick.  Returns True while work remains anywhere in the
        cluster (including requests waiting out a retry backoff)."""
        now = time.monotonic()
        self._health_sweep(now)
        self._expire(now)
        if not self.busy:
            return False
        self._requeue_retries(now)
        self._brownout(now)
        self._dispatch_prefill()
        self._assign_decode()
        self._decode_tick()
        return self.busy

    def flush(self) -> None:
        """Force out sub-batch iterative retrievals (drain tail)."""
        for eng in self.decode_engines:
            if eng.healthy:
                eng._dispatch_iterative(force=True)

    # ---------------- tail-latency accounting ------------------------------

    def group_summary(self, *, window_s: float | None = None,
                      now: float | None = None) -> dict:
        """Per-group and per-engine tail latency: TTFT is the prefill
        group's product (arrival -> first token, wherever the request
        later decoded), TPOT the decode group's -- measured from
        decode-slot assignment (``t_decode``), so time spent waiting in
        the handoff queue is charged to the scheduler, not to the decode
        engine's per-token speed.  A retried request is attributed to the
        engine that served its final pass (``prefill_of``/``decode_of``);
        ``*_history`` in this summary counts every pass, so failed
        attempts stay visible per engine.  ``health`` reports each
        engine's HEALTHY/DEGRADED/DRAINING/DEAD state, ``depths`` the
        scheduler queue occupancy (the controller's backlog signal).

        ``window_s`` restricts the latency samples to a rolling window
        ending at ``now`` (engine clock; defaults to the current time):
        TTFT samples by when the first token landed, TPOT samples by when
        the request finished -- so a controller sees the current regime's
        tails, not the run's lifetime aggregate.  Counters in
        ``scheduler`` stay lifetime (they are monotone; window by
        differencing snapshots).  Samples attributed to retired engines
        stay in the group aggregate but have no per-engine row."""
        now = time.monotonic() if now is None else now
        cutoff = None if window_s is None else now - window_s
        by_prefill: dict[int, list] = {eid: [] for eid in self._prefill_ids}
        by_decode: dict[int, list] = {eid: [] for eid in self._decode_ids}
        all_ttft, all_tpot = [], []
        for req in self.requests:
            if (req.ttft is not None and req.rid in self.prefill_of
                    and (cutoff is None or req.t_first_token >= cutoff)):
                all_ttft.append(req.ttft)
                eid = self.prefill_of[req.rid]
                if eid in by_prefill:
                    by_prefill[eid].append(req.ttft)
            if (req.state is State.DONE and req.t_decode is not None
                    and len(req.output) > 1 and req.rid in self.decode_of
                    and (cutoff is None or req.t_done >= cutoff)):
                tpot = (req.t_done - req.t_decode) / (len(req.output) - 1)
                all_tpot.append(tpot)
                eid = self.decode_of[req.rid]
                if eid in by_decode:
                    by_decode[eid].append(tpot)
        passes_p = {eid: 0 for eid in self._prefill_ids}
        for rids in self.prefill_history.values():
            for i in rids:
                if i in passes_p:
                    passes_p[i] += 1
        passes_d = {eid: 0 for eid in self._decode_ids}
        for rids in self.decode_history.values():
            for i in rids:
                if i in passes_d:
                    passes_d[i] += 1
        scheduler = self.metrics.snapshot()
        live = self.prefill_engines + self.decode_engines
        every = live + [e for _g, _eid, e in self.retired]
        scheduler["degraded_answers"] = sum(
            e.metrics["degraded_answers"] for e in every)
        backends = {id(e.backend): e.backend for e in every
                    if hasattr(e.backend, "metrics")}
        scheduler["retrieval_fallbacks"] = sum(
            b.metrics.get("fallbacks", 0) for b in backends.values())
        scheduler["retrieval_no_context"] = sum(
            b.metrics.get("no_context", 0) for b in backends.values())
        out = {
            "window_s": window_s,
            "prefill": {
                "n_engines": len(self.prefill_engines),
                "ids": list(self._prefill_ids),
                "ttft_s": percentiles(all_ttft),
                "per_engine": [
                    {"eid": eid, "n": len(by_prefill[eid]),
                     "passes": passes_p[eid],
                     "ttft_s": percentiles(by_prefill[eid])}
                    for eid in self._prefill_ids],
            },
            "decode": {
                "n_engines": len(self.decode_engines),
                "ids": list(self._decode_ids),
                "tpot_s": percentiles(all_tpot),
                "per_engine": [
                    {"eid": eid, "n": len(by_decode[eid]),
                     "passes": passes_d[eid],
                     "tpot_s": percentiles(by_decode[eid])}
                    for eid in self._decode_ids],
            },
            "depths": {"queue": len(self.queue),
                       "handoff": len(self.handoff),
                       "retrying": len(self.retrying)},
            "retired": [{"group": g, "eid": eid}
                        for g, eid, _e in self.retired],
            "health": {
                "prefill": [e.health.value for e in self.prefill_engines],
                "decode": [e.health.value for e in self.decode_engines],
            },
            "scheduler": scheduler,
        }
        if self.tracer.enabled:
            # span-derived deadline-budget attribution (queue vs stages vs
            # prefill vs handoff vs decode) across terminal requests
            out["slo"] = slo_summary(self.tracer, self.requests)
        return out

    def describe(self) -> str:
        m = self.metrics
        return (f"RAGCluster[{len(self.prefill_engines)} prefill + "
                f"{len(self.decode_engines)} decode engines "
                f"(+{m['engines_added']}/-{m['engines_removed']} resized), "
                f"{m['handoffs']} handoffs "
                f"({m['handoff_bytes'] / 1e6:.2f} MB shipped of "
                f"{m['handoff_bytes_full'] / 1e6:.2f} MB, "
                f"{m['handoff_pages_shared']} pages deduped), "
                f"shed {m['shed_requests']}, "
                f"expired {m['expired_queued']}+{m['expired_in_handoff']}, "
                f"failures {m['engine_failures']}, "
                f"retried {m['requests_retried']}, "
                f"migrated {m['requests_migrated']}]")
