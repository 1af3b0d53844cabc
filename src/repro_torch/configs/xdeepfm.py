"""xDeepFM [arXiv:1803.05170]: 39 sparse, embed 10, CIN 200-200-200,
MLP 400-400.
A copy of ``repro.configs.xdeepfm`` on the port's model config.
"""
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.recsys import XDeepFMConfig

CONFIG = XDeepFMConfig()

SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "forward", {"batch": 512}),
    ShapeSpec("serve_bulk", "forward", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "score", {"batch": 1, "n_candidates": 1000000}),
)


def reduced() -> XDeepFMConfig:
    return XDeepFMConfig(name="xdeepfm-reduced", vocab_per_field=100,
                         cin_layers=(8, 8), mlp=(16,), embed_dim=4,
                         n_sparse=6)


ARCH = ArchSpec(arch_id="xdeepfm", family="recsys", config=CONFIG,
                shapes=SHAPES, reduced=reduced, source="arXiv:1803.05170")
