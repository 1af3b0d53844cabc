"""The DeepSeek-V3 family (Moonlight-16B-A3B): multi-head latent attention
and, after ``first_k_dense_replace`` dense SwiGLU layers, sigmoid-routed
SwiGLU experts with shared experts (``noaux_tc`` with one group), served
by the program's ``LatentMoEConfig`` on its latent page pool.

The interface a family module provides is in ``core/spec.py``.  Weights
are the program's layout (``tr.LatentMoEConfig``): ``layers`` (attention
and norms, every layer), ``dense_layers`` (the first layers' FFN) and
``moe_layers`` (router, correction bias, experts, shared experts).  No
kernel of the port computes latent attention yet, so the family names one
bound, the least time of the decode step's latent attention
(``latent_decode_bound_s``), which a kernel's roofline will read (the
benchmark's tests ask every family to name one).
"""

from __future__ import annotations

import math

import torch

from bench.core import counts as C

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
            moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=2, vocab_size=512)
REFERENCE = "lm_deepseek_v3"

# published keys the program serves at these values only
SUPPORTED = {"model_type": "deepseek_v3", "hidden_act": "silu",
             "q_lora_rank": None, "scoring_func": "sigmoid",
             "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "moe_layer_freq": 1, "attention_bias": False,
             "tie_word_embeddings": False, "norm_topk_prob": True}
BIAS_SCALE = 0.05        # the correction bias's draw (``assumed``)
# the routers' channel (``assumed``): the residual stream's first
# hidden_size / ROUTE_SHARE dims carry the token's embedding alone, at
# ROUTE_EMBED per dim; no layer writes them and only the routers read them
ROUTE_SHARE = 32
ROUTE_EMBED = 2.0


def _check(m: dict) -> None:
    for key, want in SUPPORTED.items():
        if m[key] != want:
            raise ValueError(f"{key}={m[key]!r}: only {want!r} is served")
    if m["num_key_value_heads"] != m["num_attention_heads"]:
        raise ValueError("latent attention has one key head a query head")


def program_config(m: dict, name: str):
    from repro_torch.models import transformer as tr
    _check(m)
    mla = tr.MLAConfig(m["kv_lora_rank"], m["qk_nope_head_dim"],
                       m["qk_rope_head_dim"], m["v_head_dim"])
    routed = tr.RoutedMoEConfig(
        n_experts=m["n_routed_experts"], top_k=m["num_experts_per_tok"],
        d_expert=m["moe_intermediate_size"], n_shared=m["n_shared_experts"],
        first_dense=m["first_k_dense_replace"],
        routed_scale=float(m["routed_scaling_factor"]))
    return tr.LatentMoEConfig(
        name=name, n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_attention_heads"], d_head=mla.qk_head_dim,
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        mla=mla, routed=routed)


def draw_weights(m: dict, program_cfg, seed: int, device) -> dict:
    """Normal bf16 weights over sqrt(fan-in) (the embedding times 0.02),
    drawn on ``device`` one stacked tensor a call; norms 1 and the
    correction bias (normal x ``BIAS_SCALE``) in float32.

    One structure a trained model has and random weights lack: routers
    with margins.  Random routers put a share of tokens within bf16
    rounding of a tie between the k-th and the next expert at every
    layer, and a swapped expert moves the residual stream enough to swap
    later layers' choices (on an H100, at published widths: 4.9% of
    tokens at layer 1, 93% by layer 26, the bf16 program's logits as far
    from the f32 reference as int8's).  So the routers get a channel of
    their own: the first ``hidden_size / ROUTE_SHARE`` dims of the
    residual stream hold the token's embedding (normal x
    ``ROUTE_EMBED``); every matrix that writes the residual stream
    (``wo``, the dense, routed and shared ``w_down``) has zero output
    columns there, every other matrix that reads it (``wq``, ``wkv_a``,
    each ``w_gate`` and ``w_up``, the head) zero input rows, and every
    router reads only those dims (normal over sqrt of their number, times
    sqrt(depth): the residual stream's RMS, which divides them, grows so).
    Routing is then a per-layer random function of the token, over every
    expert, that a rounding elsewhere does not move, and the rest of the
    model is the plain draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d, h = (m["num_hidden_layers"], m["hidden_size"],
               m["num_attention_heads"])
    nd = m["first_k_dense_replace"]
    n, E = L - nd, m["n_routed_experts"]
    r, rope, nope, v = (m["kv_lora_rank"], m["qk_rope_head_dim"],
                        m["qk_nope_head_dim"], m["v_head_dim"])
    f, fe = m["intermediate_size"], m["moe_intermediate_size"]
    fs = m["n_shared_experts"] * fe

    def normal(shape, fan_in=None, scale=None):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return w.mul_(scale or 1 / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    layers = {"ln1": ones(L, d), "ln2": ones(L, d),
              "wq": normal((L, d, h * (nope + rope)), d),
              "wkv_a": normal((L, d, r + rope), d), "ln_kv": ones(L, r),
              "wkv_b": normal((L, r, h * (nope + v)), r),
              "wo": normal((L, h * v, d), h * v)}
    dense = {"w_gate": normal((nd, d, f), d), "w_up": normal((nd, d, f), d),
             "w_down": normal((nd, f, d), f)}
    moe = {"router": normal((n, d, E), d),
           "router_bias": torch.randn((n, E), generator=gen, device=device,
                                      dtype=torch.float32).mul_(BIAS_SCALE),
           "w_gate": normal((n, E, d, fe), d),
           "w_up": normal((n, E, d, fe), d),
           "w_down": normal((n, E, fe, d), fe),
           "s_gate": normal((n, d, fs), d), "s_up": normal((n, d, fs), d),
           "s_down": normal((n, fs, d), fs)}
    vp = program_cfg.padded_vocab
    embed = normal((vp, d), scale=0.02)
    rd = d // ROUTE_SHARE
    embed[:, :rd] *= ROUTE_EMBED / 0.02
    for w in (layers["wo"], dense["w_down"], moe["w_down"], moe["s_down"]):
        w[..., :rd] = 0                 # no layer writes the channel
    head = normal((d, vp), d)
    for w in (layers["wq"], layers["wkv_a"], dense["w_gate"], dense["w_up"],
              moe["s_gate"], moe["s_up"]):
        w[:, :rd] = 0                   # and only the routers read it
    moe["w_gate"][:, :, :rd] = 0
    moe["w_up"][:, :, :rd] = 0
    head[:rd] = 0
    moe["router"][:, rd:] = 0
    # the logits' spread held over depth: the residual stream's RMS, which
    # divides the router's input, grows as sqrt(depth)
    for i in range(n):
        moe["router"][i, :rd] *= math.sqrt(d / rd * (nd + i))
    return {"embed": embed, "head": head, "ln_f": ones(d),
            "layers": layers, "dense_layers": dense, "moe_layers": moe}


def program_component(m: dict, weights: dict, name: str, control: bool):
    """The program's config and weights.  The control is the program's
    int8 path with one change and one move.  The embedding keeps a scale
    of its own for the routers' channel: its columns are drawn 100x the
    rest, and one scale a row would round every other column to 0 or one
    step, a fault of the draw and not of int8.  Then ``weights``, which
    the reference reads after the window, move to the host, so the card
    holds the int8 weights and the pool and not the bf16 copy beside
    them."""
    from repro_torch.models import transformer as tr
    params = tr.TransformerParams(weights)
    if not control:
        return program_config(m, name), params
    tree = tr.quantize_for_serving(params).tree()
    tree["embed"] = _channel_int8(weights["embed"],
                                  m["hidden_size"] // ROUTE_SHARE)
    for group in (weights, *(g for g in weights.values()
                             if isinstance(g, dict))):
        for key, w in group.items():
            if torch.is_tensor(w):
                group[key] = w.cpu()
    return program_config(m, name), tr.TransformerParams(tree)


def _channel_int8(embed: torch.Tensor, rd: int) -> dict:
    """Per-row int8 of the embedding with two scales a row: one over the
    channel's first ``rd`` columns, one over the rest."""
    from repro_torch.models import common as cm
    ch, rest = cm.quantize_int8(embed[:, :rd]), cm.quantize_int8(embed[:, rd:])
    scale = torch.cat([ch["scale"].expand(-1, rd),
                       rest["scale"].expand(-1, embed.shape[1] - rd)], dim=1)
    return {"q": torch.cat([ch["q"], rest["q"]], dim=1), "scale": scale}


# ---------------- counts ----------------------------------------------------
#
# Model FLOPs are 2 x the matmul weights a token passes through plus the
# attention's products (``core/counts.py``'s rules).  A token's weights:
#   attention  d x H(nope+rope) (wq) + d x (r+rope) (wkv_a) + H v x d (wo),
#              and in the decompressed prefill r x H(nope+v) (wkv_b), in
#              the absorbed decode H nope x r (q W_UK^T) + H r x v (W_UV);
#   FFN        the first layers' 3 d f; every other layer's router d x E
#              and its k routed and n_shared shared experts, 3 d fe each;
#   head       d x V, once a prefill (the last token's) and a decode row.
# Attention a token and layer: prefill (decompressed) 2 H (nope+rope+v)
# per causal position, decode (absorbed) 2 H ((r+rope) + r) per position.

def _layer_weights(m: dict, absorbed: bool) -> tuple[float, float, float]:
    """(attention weights a layer, a dense layer's FFN, a routed layer's
    FFN) a token passes through."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    r, rope, nope, v = (m["kv_lora_rank"], m["qk_rope_head_dim"],
                        m["qk_nope_head_dim"], m["v_head_dim"])
    attn = d * h * (nope + rope) + d * (r + rope) + h * v * d
    attn += (h * nope * r + h * r * v) if absorbed else r * h * (nope + v)
    dense = 3 * d * m["intermediate_size"]
    routed = (d * m["n_routed_experts"]
              + (m["num_experts_per_tok"] + m["n_shared_experts"])
              * 3 * d * m["moe_intermediate_size"])
    return attn, dense, routed


def _token_weights(m: dict, absorbed: bool) -> float:
    attn, dense, routed = _layer_weights(m, absorbed)
    L, nd = m["num_hidden_layers"], m["first_k_dense_replace"]
    return L * attn + nd * dense + (L - nd) * routed


def prefill_flops(m: dict, n: int) -> float:
    """One prefill of ``n`` real tokens, decompressed form."""
    h, L = m["num_attention_heads"], m["num_hidden_layers"]
    width = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    attn = 2.0 * h * width * L * n * (n + 1) / 2
    return (2.0 * _token_weights(m, False) * n
            + 2.0 * m["hidden_size"] * m["vocab_size"] + attn)


def decode_flops(m: dict, ctxs) -> float:
    """One decode step of rows at contexts ``ctxs``, absorbed form."""
    h, L, r = (m["num_attention_heads"], m["num_hidden_layers"],
               m["kv_lora_rank"])
    width = (r + m["qk_rope_head_dim"]) + r
    attn = 2.0 * h * width * L * float(sum(ctxs))
    return (2.0 * (_token_weights(m, True)
                   + m["hidden_size"] * m["vocab_size"]) * len(ctxs) + attn)


def prefill_bounds(m: dict, n: int) -> dict:
    return {}


def decode_bounds(m: dict, ctxs) -> dict:
    """Least time of the step's latent attention over every layer: each
    row's live latent rows (r + rope, bf16) read once, its absorbed
    queries read and latent outputs written (H x (r + rope) and H x r)."""
    h, L, r = (m["num_attention_heads"], m["num_hidden_layers"],
               m["kv_lora_rank"])
    row = r + m["qk_rope_head_dim"]
    ctx, rows = float(sum(ctxs)), len(ctxs)
    per_layer = max((ctx * row + rows * h * (row + r)) * 2 / C.HBM_BYTES_S,
                    2.0 * h * (row + r) * ctx / C.BF16_FLOPS)
    return {"latent_decode_bound_s": L * per_layer}
