"""Kernels: causal flash attention's bound over every prefill in the
traced slice (``core/counts.flash_prefill_bound_s``, real prompt tokens)
over the device time of the bf16 flash kernels
(``csrc/flash_attention.cu``; the encoder's float32 kernel is not
counted) (%)."""

NAMES = ("flash_bf16",)


def read(obs):
    dt = obs.device_trace
    if not dt:
        return None
    t = sum(s for n, s in dt["kernel_s"].items()
            if any(k in n for k in NAMES))
    b = obs.work.get("prefill_bound_s", 0.0)
    return 100.0 * b / t if t and b else None
