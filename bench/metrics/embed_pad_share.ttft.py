"""Executors and retrieval: the share of the query encoder's rows that
are padding, the ``pad_rows`` over the ``rows`` + ``pad_rows`` attrs
summed over the window's ``EMBED`` spans (the encoder runs batches of a
fixed size) (%)."""


def read(obs):
    rows = pad = 0
    for s in obs.spans:
        if (s.kind == "EMBED" and obs.t0 <= s.t0 < obs.t1 and s.attrs
                and "pad_rows" in s.attrs):
            rows += s.attrs["rows"]
            pad += s.attrs["pad_rows"]
    return 100.0 * pad / (rows + pad) if rows + pad else None
