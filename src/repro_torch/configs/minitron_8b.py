"""Minitron-8B (pruned Nemotron) [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000; squared-ReLU FFN.
A copy of ``repro.configs.minitron_8b`` on the port's
``TransformerConfig``.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=16384, vocab_size=256000,
    ffn_type="relu2")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512, ffn_type="relu2")


ARCH = ArchSpec(
    arch_id="minitron-8b", family="lm", config=CONFIG,
    shapes=lm_shapes(full_attention=True), reduced=reduced,
    source="arXiv:2407.14679")
