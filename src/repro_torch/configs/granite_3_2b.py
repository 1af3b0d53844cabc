"""IBM Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155, dense.  A copy of
``repro.configs.granite_3_2b`` on the port's ``TransformerConfig``.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
    n_kv_heads=8, d_head=64, d_ff=8192, vocab_size=49155)


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="granite-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512)


ARCH = ArchSpec(
    arch_id="granite-3-2b", family="lm", config=CONFIG,
    shapes=lm_shapes(full_attention=True), reduced=reduced,
    source="hf:ibm-granite/granite-3.0-2b-base")
