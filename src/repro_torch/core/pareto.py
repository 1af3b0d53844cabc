"""Pareto-frontier utilities over (latency, throughput) points.

Points are (latency_s, throughput_rps, meta).  A point dominates another if
latency <= and throughput >=, with at least one strict.  Composition rules
used by the optimizer (exact, enabling pruning without losing frontier
points -- the search is still exhaustive over the schedule space):

* serial stages (disaggregated):  lat_a + lat_b, min(tput_a, tput_b)
* time-multiplexed (collocated):  lat_a + lat_b, 1/(1/tput_a + 1/tput_b)

Copied from ``src/repro/core/pareto.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations


def pareto(points: list[tuple]) -> list[tuple]:
    """Keep the (min-latency, max-throughput) frontier.  Points are
    (lat, tput, meta)."""
    pts = sorted(points, key=lambda p: (p[0], -p[1]))
    out = []
    best_tput = -1.0
    for p in pts:
        if p[1] > best_tput * 1.001:   # epsilon: ignore <0.1% tput gains
            out.append(p)
            best_tput = p[1]
    return out


def combine_serial(a: list[tuple], b: list[tuple],
                   cap: int | None = None) -> list[tuple]:
    """Pipeline composition: latencies add, throughput is the bottleneck."""
    pts = [(pa[0] + pb[0], min(pa[1], pb[1]), (pa[2], pb[2]))
           for pa in a for pb in b]
    out = pareto(pts)
    return out[:cap] if cap else out


def combine_collocated(a: list[tuple], b: list[tuple],
                       cap: int | None = None) -> list[tuple]:
    """Time-multiplexed composition on shared chips: service rates add."""
    pts = [(pa[0] + pb[0], 1.0 / (1.0 / pa[1] + 1.0 / pb[1]), (pa[2], pb[2]))
           for pa in a for pb in b]
    out = pareto(pts)
    return out[:cap] if cap else out
