"""MIND [arXiv:1904.08030]: embed 64, 4 interests, 3 capsule routing
iterations, multi-interest interaction.
A copy of ``repro.configs.mind`` on the port's model config.
"""
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.recsys import MINDConfig

CONFIG = MINDConfig()

SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "forward", {"batch": 512}),
    ShapeSpec("serve_bulk", "forward", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "score", {"batch": 1, "n_candidates": 1000000}),
)


def reduced() -> MINDConfig:
    return MINDConfig(name="mind-reduced", n_items=200, hist_len=8,
                      embed_dim=16, n_interests=2)


ARCH = ArchSpec(arch_id="mind", family="recsys", config=CONFIG, shapes=SHAPES,
                reduced=reduced, source="arXiv:1904.08030")
