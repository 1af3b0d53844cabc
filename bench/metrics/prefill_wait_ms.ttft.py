"""Engine tick: the host's wait for a prefill, from its forward enqueued
to its first token read: the engine's ``STAGE:prefill.write`` and
``STAGE:prefill.read`` span seconds in the window, over the window's
``PREFILL`` spans (ms).  The first blocking call after the launch holds
the wait for the forward's device time (today ``write_prefix``'s index
copies, in ``.write``; with those copies asynchronous, the token's read,
in ``.read``); the page keys and page writes lie in the same span."""

KINDS = ("STAGE:prefill.write", "STAGE:prefill.read")


def read(obs):
    wait, prefills = 0.0, 0
    for s in obs.spans:
        if not obs.t0 <= s.t0 < obs.t1:
            continue
        if s.kind == "PREFILL":
            prefills += 1
        elif s.kind in KINDS:
            wait += s.t1 - s.t0
    return 1e3 * wait / prefills if prefills and wait else None
