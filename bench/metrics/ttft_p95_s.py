"""95th percentile, over every request due in the window, of the time
from its due time to its first token (s)."""

from bench.core import window as W


def read(obs):
    return W.p95([W.ttft(s) for s in obs.judged])
