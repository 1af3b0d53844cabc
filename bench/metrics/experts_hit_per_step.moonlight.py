"""Model: distinct routed experts a decode step's live rows chose, the
mean over the window's ``DECODE_TICK`` spans of their ``experts_hit``
attr (itself the mean over the routed layers): how many experts'
weights a step has to read.  Nothing on a program whose ticks lack it."""


def read(obs):
    hit = [s.attrs["experts_hit"] for s in obs.spans
           if s.kind == "DECODE_TICK" and obs.t0 <= s.t0 < obs.t1
           and s.attrs and "experts_hit" in s.attrs]
    return sum(hit) / len(hit) if hit else None
