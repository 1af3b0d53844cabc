"""Engine tick: host arrays copied to the device in a decode tick, the
mean of the ``h2d`` attr over the window's ``DECODE_TICK`` spans (each
such copy from pageable memory ends in a stream synchronisation)."""


def read(obs):
    n = [s.attrs["h2d"] for s in obs.spans
         if s.kind == "DECODE_TICK" and obs.t0 <= s.t0 < obs.t1
         and s.attrs and "h2d" in s.attrs]
    return sum(n) / len(n) if n else None
