"""95th percentile, over the window's answered requests, of
(t_done - t_first_token) / (tokens - 1) (ms)."""

from bench.core import window as W


def read(obs):
    v = W.p95([W.tpot(s) for s in obs.judged])
    return None if v is None else 1e3 * v
