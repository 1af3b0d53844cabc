"""ChatGLM3-6B [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024; partial (2d) RoPE.
A copy of ``repro.configs.chatglm3_6b`` on the port's
``TransformerConfig``.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
    n_kv_heads=2, d_head=128, d_ff=13696, vocab_size=65024,
    rotary_frac=0.5)


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="chatglm3-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512, rotary_frac=0.5)


ARCH = ArchSpec(
    arch_id="chatglm3-6b", family="lm", config=CONFIG,
    shapes=lm_shapes(full_attention=True), reduced=reduced,
    source="arXiv:2406.12793")
