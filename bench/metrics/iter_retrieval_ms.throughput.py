"""Executors and retrieval: iterative retrieval's host time per answer in
the window (ms): its embed and retrieve (those stages less the admission
``retrieval`` executor that holds its own) and its appends."""

from bench.core import window as W


def read(obs):
    st = obs.stage_s
    if not st.get("append"):
        return None
    answers = len(W.done_in(obs.stamps, obs.t0, obs.t1))
    if not answers:
        return None
    iterative = (st.get("embed", 0.0) + st.get("retrieve", 0.0)
                 - st.get("retrieval", 0.0) + st["append"])
    return 1e3 * iterative / answers
