"""Device: idle time of the traced slice that falls while the engine's
``STAGE:decode.launch`` span is the innermost stage open on the host (the
host enqueueing a decode step's layers and its argmax), over the slice
(%)."""

KIND = "STAGE:decode.launch"


def read(obs):
    dt = obs.device_trace
    if not dt or not dt["window_s"] or KIND not in dt["idle_by_stage"]:
        return None
    return 100.0 * dt["idle_by_stage"][KIND] / dt["window_s"]
