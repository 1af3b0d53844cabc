"""Kernels: the paged chunk-extend attention's share of the traced slice:
the device seconds of its kernel (``csrc/paged_chunk_attention.cu``),
which the iterative appends' chunk-extend forwards launch once a layer,
over the slice's ``window_s`` (%).  Nothing where no such kernel ran."""

NAMES = ("paged_chunk_attention",)


def read(obs):
    dt = obs.device_trace
    if not dt or not dt["window_s"]:
        return None
    t = sum(s for n, s in dt["kernel_s"].items()
            if any(k in n for k in NAMES))
    return 100.0 * t / dt["window_s"] if t else None
