"""Two-tower retrieval [Yi et al., RecSys'19 (YouTube)]: embed 256,
tower MLP 1024-512-256, dot interaction, sampled softmax.
A copy of ``repro.configs.two_tower_retrieval`` on the port's model config.
"""
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig()

SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "forward", {"batch": 512}),
    ShapeSpec("serve_bulk", "forward", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "score", {"batch": 1, "n_candidates": 1000000}),
)


def reduced() -> TwoTowerConfig:
    return TwoTowerConfig(name="two-tower-reduced", n_users=200, n_items=400,
                          hist_len=5, tower_mlp=(32, 16), embed_dim=16)


ARCH = ArchSpec(arch_id="two-tower-retrieval", family="recsys", config=CONFIG,
                shapes=SHAPES, reduced=reduced, source="RecSys'19 (YouTube)")
