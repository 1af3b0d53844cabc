"""Engine tick: host wall time of a prefill, the engine's ``prefill``
stage seconds over its prefills in the window (ms)."""


def read(obs):
    n = obs.stage_n.get("prefill", 0)
    return 1e3 * obs.stage_s["prefill"] / n if n else None
