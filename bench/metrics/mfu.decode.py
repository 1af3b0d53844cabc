"""Model: the window's decode FLOPs (``core/counts.decode_flops``) over the
engine's ``decode`` stage seconds and the bf16 peak (%)."""

from bench.core import counts as C


def read(obs):
    s = obs.stage_s.get("decode", 0.0)
    f = obs.work.get("decode_flops", 0.0)
    return 100.0 * f / (s * C.BF16_FLOPS) if s and f else None
