"""Engine tick: the share of the window's decode ticks replayed from the
engine's CUDA graph, the mean of the ``graph`` attr over its
``DECODE_TICK`` spans (1 replayed, 0 stepped eagerly) (%)."""


def read(obs):
    g = [s.attrs["graph"] for s in obs.spans
         if s.kind == "DECODE_TICK" and obs.t0 <= s.t0 < obs.t1
         and s.attrs and "graph" in s.attrs]
    return 100.0 * sum(g) / len(g) if g else None
