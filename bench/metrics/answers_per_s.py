"""Questions answered whole in the window, over the window (answers/s)."""

from bench.core import window as W


def read(obs):
    return W.rate(obs.stamps, obs.t0, obs.t1)
