"""Executors and retrieval: the ``embed`` and ``retrieve`` stage seconds
over the requests the ``retrieval`` executor admitted in the window (ms).
Embed's device time lands in ``retrieve``, whose result is read back."""


def read(obs):
    n = obs.stage_n.get("retrieval", 0)
    if not n:
        return None
    return 1e3 * (obs.stage_s.get("embed", 0.0)
                  + obs.stage_s.get("retrieve", 0.0)) / n
