"""Engine tick: the host's own work in a decode tick, the engine's
``STAGE:decode.prepare`` (write targets, the inputs and their copies to
the device) and ``STAGE:decode.retire`` (advance, tokens, releases) span
seconds in the window, over its ``DECODE_TICK`` spans (ms)."""

KINDS = ("STAGE:decode.prepare", "STAGE:decode.retire")


def read(obs):
    host, ticks = 0.0, 0
    for s in obs.spans:
        if not obs.t0 <= s.t0 < obs.t1:
            continue
        if s.kind == "DECODE_TICK":
            ticks += 1
        elif s.kind in KINDS:
            host += s.t1 - s.t0
    return 1e3 * host / ticks if ticks and host else None
