"""Device: share of the traced slice with no device activity, from the
union of activity intervals in the ``torch.profiler`` trace (%)."""


def read(obs):
    dt = obs.device_trace
    if not dt or not dt["window_s"] or not dt["busy_s"]:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])
