"""Llama-4 Scout 17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192(/expert) vocab=202048,
MoE 16 experts top-1.  A copy of ``repro.configs.llama4_scout_17b_a16e``
on the port's ``TransformerConfig``.  At 101.7 B parameters (203 GB in
bf16) it does not fit one 80 GB card; the port serves it reduced.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_head=128, d_ff=8192, vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1))


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-scout-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=64, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=1))


ARCH = ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm", config=CONFIG,
    shapes=lm_shapes(full_attention=True), reduced=reduced,
    source="hf:meta-llama/Llama-4-Scout-17B-16E")
