"""Engine tick: host wall time of a decode step, the engine's ``decode``
stage seconds over the steps that stepped a request in the window (ms)."""


def read(obs):
    n = obs.stage_n.get("decode", 0)
    return 1e3 * obs.stage_s["decode"] / n if n else None
