"""Model: the window's prefill FLOPs (``core/counts.prefill_flops``, real
prompt tokens) over the engine's ``prefill`` stage seconds and the bf16
peak (%)."""

from bench.core import counts as C


def read(obs):
    s = obs.stage_s.get("prefill", 0.0)
    f = obs.work.get("prefill_flops", 0.0)
    return 100.0 * f / (s * C.BF16_FLOPS) if s and f else None
