"""Serving telemetry for the port: the metrics registry and the no-op tracer.

A copy of the parts of ``repro.serving.telemetry`` that the engine's hot
path uses: :class:`MetricsRegistry` (typed Counter/Gauge/CounterFamily
cells behind the old ``metrics["x"] += 1`` dict interface, plus
fixed-boundary histograms), :data:`NULL_TRACER` (every call a no-op behind
an ``enabled`` flag) and :func:`stage_kind`.  The span tracer and its
exporters are not ported yet.
"""

from __future__ import annotations

import bisect
import math
from collections.abc import MutableMapping


def stage_kind(stage: str) -> str:
    """Map an engine ``_timed`` stage name onto a span kind."""
    return {
        "embed": "EMBED",
        "retrieve": "RETRIEVE",
        "prefill": "PREFILL",
        "decode": "DECODE_TICK",
    }.get(stage, f"STAGE:{stage}")


class NullTracer:
    """The default tracer: every call is a no-op and allocates nothing.

    Hot paths guard on ``tracer.enabled`` so that with the null tracer the
    per-tick cost is one attribute read and a falsy branch.
    """

    __slots__ = ()
    enabled = False

    def event(self, kind, rid=None, engine=None, t=None, tick=0,
              attempt=0, attrs=None):
        return None

    def begin(self, kind, rid=None, engine=None, t=None, tick=0,
              attempt=0, attrs=None):
        return None

    def end(self, span, t=None, attrs=None):
        return None

    def record(self, kind, t0, t1, rid=None, engine=None, tick=0,
               attempt=0, attrs=None):
        return None

    def close_open(self, rid, t=None, outcome=None):
        return None

    def terminal(self, rid, state, t=None):
        return None


#: Shared no-op tracer. Engines/clusters/servers default to this.
NULL_TRACER = NullTracer()


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


class Gauge:
    """Scalar cell that is set, not accumulated."""

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

    ``reg["x"]`` reads a scalar (Counter/Gauge) or the live
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
        if isinstance(cell, (Counter, Gauge)):
            return cell.value
        return cell

    def __setitem__(self, k, v):
        cell = self._cells.get(k)
        if isinstance(cell, (Counter, Gauge)):
            cell.value = v
        elif isinstance(cell, CounterFamily):
            if v is not cell:            # replace contents, keep identity
                cell._d = dict(v)
        elif isinstance(v, MutableMapping) or isinstance(v, dict):
            self._cells[k] = CounterFamily(v)
        elif isinstance(v, (Counter, Gauge, CounterFamily)):
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

    # -- typed access ------------------------------------------------------

    def counter(self, name) -> Counter:
        cell = self._cells.setdefault(name, Counter(0))
        if not isinstance(cell, Counter):
            raise TypeError(f"{name} is not a Counter")
        return cell

    def gauge(self, name) -> Gauge:
        cell = self._cells.get(name)
        if cell is None:
            cell = self._cells[name] = Gauge(0)
        if not isinstance(cell, Gauge):
            raise TypeError(f"{name} is not a Gauge")
        return cell

    def family(self, name) -> CounterFamily:
        cell = self._cells.setdefault(name, CounterFamily())
        if not isinstance(cell, CounterFamily):
            raise TypeError(f"{name} is not a CounterFamily")
        return cell

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
            if isinstance(cell, (Counter, Gauge)):
                out[k] = cell.value
            else:
                out[k] = cell.snapshot()
        if self._hists:
            out["histograms"] = {k: h.snapshot()
                                 for k, h in self._hists.items()}
        return out
