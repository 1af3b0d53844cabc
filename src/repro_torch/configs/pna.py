"""PNA [arXiv:2004.05718]: 4L d_hidden=75, aggregators mean/max/min/std,
scalers id/amp/atten.  Per-shape feature/class dims follow the standard
datasets for the brief's node/edge counts (Cora / Reddit / ogbn-products /
ZINC-like molecules).
A copy of ``repro.configs.pna`` on the port's model config.
"""
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.gnn import PNAConfig

CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75)

SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_classes": 7}),
    ShapeSpec("minibatch_lg", "train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602, "n_classes": 41}),
    ShapeSpec("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_classes": 47}),
    ShapeSpec("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
               "n_classes": 1}),
)


def config_for_shape(shape: ShapeSpec) -> PNAConfig:
    from dataclasses import replace
    return replace(CONFIG, d_feat=shape.dims["d_feat"],
                   n_classes=shape.dims["n_classes"],
                   graph_level=(shape.name == "molecule"))


def reduced() -> PNAConfig:
    return PNAConfig(name="pna-reduced", n_layers=2, d_hidden=16, d_feat=8,
                     n_classes=4)


ARCH = ArchSpec(arch_id="pna", family="gnn", config=CONFIG, shapes=SHAPES,
                reduced=reduced, source="arXiv:2004.05718")
