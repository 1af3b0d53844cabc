"""Kernels: the paged decode attention's bound (``core/counts.
paged_decode_bound_s``) over the device time of its split and merge
kernels (``csrc/paged_decode_attention.cu``, ``decode_split.cuh``), both
summed over the traced slice (%).  The dense decode kernel shares the
names; no cell that lists this metric runs it."""

NAMES = ("split_kernel", "merge_kernel")


def read(obs):
    dt = obs.device_trace
    if not dt:
        return None
    t = sum(s for n, s in dt["kernel_s"].items()
            if any(k in n for k in NAMES))
    b = obs.work.get("decode_bound_s", 0.0)
    return 100.0 * b / t if t and b else None
