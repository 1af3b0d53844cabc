"""The dense family: a GQA decoder with partial interleaved RoPE, RMSNorm
and a SwiGLU FFN (ChatGLM3, Granite), served by the program's
``TransformerConfig`` with ``ffn_type="swiglu"``.

A thin adapter over ``core/model.py`` (weights, program config),
``core/counts.py`` (FLOPs and kernel bounds) and ``reference/lm.py``; the
interface a family module provides is in ``core/spec.py``.  Its kernels
are the bf16 flash prefill (``prefill_bound_s``) and the paged decode
attention (``decode_bound_s``).
"""

from __future__ import annotations

from bench.core import counts as C
from bench.core import model as M

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=128,
            vocab_size=512)
REFERENCE = "lm"


def program_config(m: dict, name: str):
    return M.program_config(m, name)


def draw_weights(m: dict, program_cfg, seed: int, device) -> dict:
    return M.draw_weights(m, program_cfg.padded_vocab, seed, device)


def program_component(m: dict, weights: dict, name: str, control: bool):
    from repro_torch.models import transformer as tr
    params = tr.TransformerParams(weights)
    if control:
        params = tr.quantize_for_serving(params)
    return program_config(m, name), params


def prefill_flops(m: dict, n: int) -> float:
    return C.prefill_flops(C.Dims.from_model(m), n)


def decode_flops(m: dict, ctxs) -> float:
    return C.decode_flops(C.Dims.from_model(m), ctxs)


def prefill_bounds(m: dict, n: int) -> dict:
    return {"prefill_bound_s": C.flash_prefill_bound_s(C.Dims.from_model(m),
                                                       n)}


def decode_bounds(m: dict, ctxs) -> dict:
    return {"decode_bound_s": C.paged_decode_bound_s(C.Dims.from_model(m),
                                                     ctxs)}
