"""Moonlight-16B-A3B (Kimi/Moonshot) [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) d_ff=1408(/expert) vocab=163840,
MoE 64 experts top-6.  A copy of ``repro.configs.moonshot_v1_16b_a3b``
on the port's ``TransformerConfig``, field for field.  Like the
reference it is not the published model: that one has 27 layers, latent
attention (MLA), 2 shared experts and sigmoid routing scores.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=1408, vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6))


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="moonshot-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=32, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2))


ARCH = ArchSpec(
    arch_id="moonshot-v1-16b-a3b", family="lm", config=CONFIG,
    shapes=lm_shapes(full_attention=True), reduced=reduced,
    source="hf:moonshotai/Moonlight-16B-A3B")
