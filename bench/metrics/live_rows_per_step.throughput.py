"""Engine tick: rows a decode step advances, the mean of the ``n`` attr
over the window's ``DECODE_TICK`` spans (requests waiting for a
retrieval or an append do not step)."""


def read(obs):
    n = [s.attrs["n"] for s in obs.spans
         if s.kind == "DECODE_TICK" and obs.t0 <= s.t0 < obs.t1
         and s.attrs and "n" in s.attrs]
    return sum(n) / len(n) if n else None
