"""A configuration's model as the program takes it, and its weights.

The weights are the benchmark's input: drawn on the device from the seed,
one call a stacked tensor, in the type they are served in.  The program
gets them wrapped in its parameter container; the reference reads the
same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def component_seeds(seed: int) -> tuple[int, int]:
    """Generator seeds of the served model and of the encoder."""
    a, b = np.random.default_rng(seed).integers(0, 2 ** 62, size=2)
    return int(a), int(b)


def draw_weights(m: dict, padded_vocab: int, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """Normal weights scaled by 1/sqrt(fan-in) (the embedding by 0.02),
    norm weights 1 in float32, laid out as the program's stacked tree."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d, h, kv, hd, f = (m["num_hidden_layers"], m["hidden_size"],
                          m["num_attention_heads"], m["num_key_value_heads"],
                          m["head_dim"], m["intermediate_size"])

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(scale)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    layers = {
        "ln1": ones(L, d), "ln2": ones(L, d),
        "wq": normal((L, d, h * hd), 1 / math.sqrt(d)),
        "wk": normal((L, d, kv * hd), 1 / math.sqrt(d)),
        "wv": normal((L, d, kv * hd), 1 / math.sqrt(d)),
        "wo": normal((L, h * hd, d), 1 / math.sqrt(h * hd)),
        "w_gate": normal((L, d, f), 1 / math.sqrt(d)),
        "w_up": normal((L, d, f), 1 / math.sqrt(d)),
        "w_down": normal((L, f, d), 1 / math.sqrt(f)),
    }
    return {"embed": normal((padded_vocab, d), 0.02),
            "head": normal((d, padded_vocab), 1 / math.sqrt(d)),
            "ln_f": ones(d), "layers": layers}


def program_config(m: dict, name: str):
    """The program's ``TransformerConfig`` for a ``model`` or ``encoder``
    group (published key names)."""
    from repro_torch.models.transformer import TransformerConfig
    if m["hidden_act"] != "silu" or m["ffn"] != "swiglu":
        raise ValueError(f"{name}: only SwiGLU FFNs are served")
    return TransformerConfig(
        name=name, n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_head=m["head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        rope_theta=float(m["rope_theta"]),
        rotary_frac=float(m["partial_rotary_factor"]),
        causal=not m["bidirectional"], norm_eps=float(m["rms_norm_eps"]))
