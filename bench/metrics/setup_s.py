"""From the process's start to the window's: loading, weights, the
corpus encode, warm-up (s)."""


def read(obs):
    return obs.setup_s
