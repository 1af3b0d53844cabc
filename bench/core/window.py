"""Window arithmetic over the requests' own timestamps.

The engine stamps each request (``t_arrive``: the due time the harness
gave it, ``t_first_token``, ``t_done``, ``output``); these functions turn
the stamps of one window into the end-to-end metrics.  A percentile is
taken over every request in the window, never over medians of chunks.
The arithmetic copies ``RAGServer.summary``'s (TTFT from the due time,
TPOT per request), restricted to one window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class Stamp:
    """One request as the window sees it."""
    due: float                 # the time it was due (open) or sent (closed)
    first: float | None        # first token
    done: float | None         # last token
    n_out: int                 # tokens served
    n_want: int                # tokens asked for
    ok: bool                   # ended DONE, whole
    rid: int = -1              # the program's request id


def quantile(values, q: float) -> float | None:
    """Linear interpolation between order statistics (numpy's default):
    the q-quantile of every value."""
    xs = sorted(values)
    if not xs:
        return None
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft(s: Stamp) -> float | None:
    return None if s.first is None else s.first - s.due


def tpot(s: Stamp) -> float | None:
    """(t_done - t_first_token) / (tokens - 1)."""
    if not s.ok or s.first is None or s.done is None or s.n_out < 2:
        return None
    return (s.done - s.first) / (s.n_out - 1)


def done_in(stamps, t0: float, t1: float):
    return [s for s in stamps if s.ok and s.done is not None
            and t0 <= s.done < t1]


def p95(values) -> float | None:
    vals = [v for v in values if v is not None]
    return quantile(vals, 0.95) if vals else None


def rate(stamps, t0: float, t1: float) -> float:
    """Answers completed in [t0, t1) over the whole window."""
    return len(done_in(stamps, t0, t1)) / (t1 - t0)
