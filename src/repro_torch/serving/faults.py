"""Fault injection and engine health for the port (a copy of
``repro.serving.faults``).

A seeded :class:`FaultPlan` names which injection point fires on which
occurrence; a :class:`FaultInjector` threads through the engine and
cluster hot paths and raises or flips exactly there, so every run of the
same plan produces the same failure schedule and the recovery invariant
("every submitted request reaches exactly one terminal state") is a
reproducible assertion.

Injection points (``FaultInjector.POINTS``):

* ``prefill_crash``   -- the prefill engine dies mid-prefill (the request
  being prefilled is recovered onto a healthy engine).
* ``decode_crash``    -- a decode engine dies mid-generation (its in-slot
  requests re-enter the pipeline via re-prefill with retry backoff).
* ``handoff_corrupt`` -- the exported KV payload is bit-flipped "on the
  wire"; the importer's checksum rejects it and the request retries
  instead of decoding garbage.
* ``handoff_drop``    -- the payload is lost entirely (same recovery).
* ``retrieval_timeout`` / ``retrieval_error`` -- the primary retrieval
  backend times out / errors; the fallback chain degrades to exact scan.
* ``retrieval_blackout`` -- every backend in the chain fails; the request
  is answered with no retrieved context and flagged ``degraded``.
* ``stage_error``     -- a transient exception inside a pre-prefill stage
  executor (the engine survives; the request retries).

No process is killed: engines expose a ``fail()`` / ``health`` API
(:class:`EngineHealth`) and the injector drives it.  The injector is also
the only source of randomness (corruption byte positions), seeded from
the plan, so fault runs are bit-reproducible.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.telemetry import NULL_TRACER


class EngineHealth(enum.Enum):
    """Per-engine health state driven by the fault layer (or by a real
    health prober in a deployment).  DRAINING sits between HEALTHY and
    DEAD: the engine is alive but accepts no new dispatch while the
    cluster's health sweep migrates its in-flight work elsewhere -- the
    state a live resize parks an engine in before removing it."""
    HEALTHY = "healthy"
    DEGRADED = "degraded"     # survived a transient fault; still serving
    DRAINING = "draining"     # live resize: no new work, migrating out
    DEAD = "dead"             # removed from scheduling; never recovers


#: Legal health-state transitions (the engine-level sibling of
#: ``request.LEGAL_TRANSITIONS``).  A drain can be aborted back to
#: DEGRADED (the cluster un-drains an engine rather than failing work when
#: it is the last alive member of its group), and anything alive can die;
#: DEAD is terminal.  ``RAGEngine.fail/degrade/drain/undrain`` enforce
#: this graph.
LEGAL_HEALTH_TRANSITIONS: dict[EngineHealth, frozenset[EngineHealth]] = {
    EngineHealth.HEALTHY: frozenset({EngineHealth.DEGRADED,
                                     EngineHealth.DRAINING,
                                     EngineHealth.DEAD}),
    EngineHealth.DEGRADED: frozenset({EngineHealth.DRAINING,
                                      EngineHealth.DEAD}),
    EngineHealth.DRAINING: frozenset({EngineHealth.DEGRADED,
                                      EngineHealth.DEAD}),
    EngineHealth.DEAD: frozenset(),
}


class EngineCrash(RuntimeError):
    """An injected (or detected) engine death: the engine is DEAD and its
    in-flight requests must be recovered elsewhere."""


class TransientStageError(RuntimeError):
    """An injected transient exception inside a stage executor: the
    request retries, the engine survives (DEGRADED)."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: *point* fires on its ``at``-th matching
    occurrence (1-based), ``count`` consecutive times.  ``engine`` /
    ``rid`` restrict matching to one engine index / request id (None
    matches any).  ``mode`` carries point-specific detail (unused today;
    reserved for e.g. partial-corruption variants)."""
    point: str
    at: int = 1
    count: int = 1
    engine: int | None = None
    rid: int | None = None
    mode: str | None = None

    def matches(self, engine, rid) -> bool:
        return ((self.engine is None or self.engine == engine)
                and (self.rid is None or self.rid == rid))


@dataclass
class FaultPlan:
    """A seeded, deterministic fault schedule.

    ``specs`` is the full schedule; ``seed`` feeds the injector's RNG
    (corruption bytes), so two runs of the same plan inject bit-identical
    faults.  :meth:`from_schedule` builds a plan from plain dicts -- the
    form of ``CHAOS_SCHEDULES``."""
    specs: list[FaultSpec] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_schedule(cls, schedule: list[dict], seed: int = 0) -> "FaultPlan":
        return cls([FaultSpec(**s) for s in schedule], seed=seed)


class FaultInjector:
    """Threads a :class:`FaultPlan` through the serving hot paths.

    Call :meth:`fire` at an injection point; it deterministically counts
    the occurrence (per spec, honoring engine/rid filters) and returns
    the armed :class:`FaultSpec` when one is due, else None.  The caller
    enacts the fault (raise :class:`EngineCrash`, corrupt the payload,
    ...).  ``log`` records every firing for assertions and reports."""

    POINTS = frozenset({
        "prefill_crash", "decode_crash", "handoff_corrupt", "handoff_drop",
        "retrieval_timeout", "retrieval_error", "retrieval_blackout",
        "stage_error",
    })

    def __init__(self, plan: FaultPlan):
        for spec in plan.specs:
            if spec.point not in self.POINTS:
                raise ValueError(
                    f"unknown injection point {spec.point!r}; "
                    f"known: {sorted(self.POINTS)}")
            if spec.at < 1 or spec.count < 1:
                raise ValueError(f"bad FaultSpec occurrence window: {spec}")
        self.plan = plan
        self._seen = [0] * len(plan.specs)      # matching occurrences so far
        self.rng = np.random.default_rng(plan.seed)
        self.log: list[tuple] = []              # (point, occurrence, eng, rid)
        # telemetry: the cluster's set_tracer swaps in a SpanTracer so
        # every injected fault lands on the trace as a FAULT:<point> event
        self.tracer = NULL_TRACER

    def fire(self, point: str, engine: int | None = None,
             rid: int | None = None) -> FaultSpec | None:
        """Count this occurrence of ``point``; return the due spec (and
        log the firing) or None.  At most one spec fires per call."""
        assert point in self.POINTS, point
        hit, hit_occ = None, 0
        for i, spec in enumerate(self.plan.specs):
            if spec.point != point or not spec.matches(engine, rid):
                continue
            self._seen[i] += 1
            if hit is None and \
                    spec.at <= self._seen[i] < spec.at + spec.count:
                hit, hit_occ = spec, self._seen[i]
                self.log.append((point, self._seen[i], engine, rid))
        if hit is not None and self.tracer.enabled:
            self.tracer.event(f"FAULT:{point}", rid=rid,
                              attrs={"engine": engine,
                                     "occurrence": hit_occ})
        return hit

    def corrupt(self, payload):
        """Bit-flip one K-page of an exported KV payload in place
        (deterministically, via the plan-seeded RNG) -- simulates wire
        corruption.  Works on both handoff payload layouts: the paged
        :class:`~repro_torch.serving.kv_cache.PagedPrefix` and the dense
        ``{"k","v"}`` dict.  A bf16 page travels as int16 bits, so the same
        seed flips the same byte as in the JAX package."""
        arrays = (list(payload.pages.values())[0]
                  if hasattr(payload, "pages") else payload)
        buf = np.asarray(arrays["k"]).view(np.uint8).copy()
        pos = int(self.rng.integers(buf.size))
        buf.flat[pos] ^= 0xFF
        arrays["k"] = buf.view(np.asarray(arrays["k"]).dtype).reshape(
            np.asarray(arrays["k"]).shape)
        return payload


#: Named schedules for the chaos matrix (tests and ``chip_smoke.py``):
#: each is deterministic and exercises one recovery path (plus "combined",
#: which exercises all of them in a single run).
CHAOS_SCHEDULES: dict[str, list[dict]] = {
    "prefill_crash": [{"point": "prefill_crash", "at": 2}],
    "decode_crash": [{"point": "decode_crash", "at": 3}],
    "handoff_corrupt": [{"point": "handoff_corrupt", "at": 1, "count": 2}],
    "handoff_drop": [{"point": "handoff_drop", "at": 2}],
    "retrieval_timeout": [{"point": "retrieval_timeout", "at": 1,
                           "count": 3}],
    "retrieval_blackout": [{"point": "retrieval_blackout", "at": 2}],
    "stage_error": [{"point": "stage_error", "at": 1}],
    "combined": [
        {"point": "stage_error", "at": 1},
        {"point": "handoff_corrupt", "at": 2},
        {"point": "retrieval_timeout", "at": 2, "count": 2},
        {"point": "decode_crash", "at": 4},
    ],
}
