"""DLRM-RM2 [arXiv:1906.00091]: 13 dense, 26 sparse, embed 64,
bot 13-512-256-64, top 512-512-256-1, dot interaction.
A copy of ``repro.configs.dlrm_rm2`` on the port's model config.
"""
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.recsys import DLRMConfig

CONFIG = DLRMConfig()

SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "forward", {"batch": 512}),
    ShapeSpec("serve_bulk", "forward", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "score", {"batch": 1, "n_candidates": 1000000}),
)


def reduced() -> DLRMConfig:
    return DLRMConfig(name="dlrm-reduced", vocab_per_field=100,
                      bot_mlp=(32, 16), top_mlp=(32, 1), embed_dim=16)


ARCH = ArchSpec(arch_id="dlrm-rm2", family="recsys", config=CONFIG,
                shapes=SHAPES, reduced=reduced, source="arXiv:1906.00091")
