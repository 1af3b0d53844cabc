"""95th percentile, over the window's requests, of the wait from SUBMIT to
ADMIT on the program's span tracer (server layer, s)."""

from bench.core import window as W


def read(obs):
    submit, admit = {}, {}
    for s in obs.spans:
        if s.kind == "SUBMIT":
            submit[s.rid] = s.t0
        elif s.kind == "ADMIT":
            admit.setdefault(s.rid, s.t0)
    waits = [admit[s.rid] - submit[s.rid] for s in obs.judged
             if s.rid in submit and s.rid in admit]
    return W.p95(waits)
