"""Engine health states for the port (a copy of the health half of
``repro.serving.faults``).

:class:`EngineHealth`, the legal health transitions and
:class:`EngineCrash` are what ``RAGEngine``'s health and drain API needs;
the deterministic fault injector is not ported yet.
"""

from __future__ import annotations

import enum


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
