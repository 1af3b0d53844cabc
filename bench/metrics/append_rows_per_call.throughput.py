"""Engine tick: the rows of a retrieval batch that one chunk-extend
forward appends (rows): the window's ``STAGE:append`` spans' ``rows``
summed over their ``calls``, the forwards each span made (one a prompt
bucket)."""


def read(obs):
    spans = [s.attrs for s in obs.spans
             if s.kind == "STAGE:append" and obs.t0 <= s.t0 < obs.t1
             and s.attrs and "rows" in s.attrs and "calls" in s.attrs]
    calls = sum(a["calls"] for a in spans)
    return sum(a["rows"] for a in spans) / calls if calls else None
