"""Float32 reference of the DeepSeek-V3 decoder (Moonlight-16B-A3B), one
sequence at a time, in the decompressed form of the published modeling
code (``modeling_deepseek.py``), written from the configuration's keys.

A layer: RMSNorm; queries ``x wq`` split per head into ``q_nope`` and
``q_pe``; ``x wkv_a`` split into the latent ``c`` (RMS-normed by
``ln_kv``) and the shared ``k_pe``; ``c wkv_b`` split per head into
``k_nope`` and ``v``; RoPE on ``q_pe`` and ``k_pe`` as the published
code applies it (each de-interleaved into evens then odds, then rotated
half against half); causal softmax attention of ``[q_nope, q_pe]``
against ``[k_nope, k_pe]`` scaled by 1/sqrt(qk_nope + qk_rope); ``wo``
and the residual.  Then RMSNorm and the FFN: a dense SwiGLU in the first
``first_k_dense_replace`` layers; in the rest the ``noaux_tc`` router
with one group (sigmoid scores in float32, the top k of scores plus
``router_bias`` chosen, weights the chosen scores normalised to sum 1 and
times ``routed_scaling_factor``), each expert run on the tokens that
chose it, plus the shared experts, one SwiGLU.

``weights`` is the tree the benchmark drew: ``embed``, ``head``,
``ln_f``, and the stacked groups ``layers``, ``dense_layers`` and
``moe_layers`` (names in ``bench/blocks/deepseek_v3.py``), on the
sequences' device or on the host.  Each layer's weights are moved to the
sequences' device in float32 once and applied to every sequence before
the next layer.  It imports nothing of the program, calls no kernel and
keeps no cache; the caller turns TF32 off.
"""

from __future__ import annotations

import math

import torch

QUERY_BLOCK = 512      # query rows a block of attention scores holds


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (S, H, D): the published ``apply_rotary_pos_emb``: the dims
    de-interleaved (evens, then odds), then ``x cos + rotate_half(x) sin``
    with the angles of position s at frequencies theta^(-2i/D)."""
    s, h, d = x.shape
    x = x.reshape(s, h, d // 2, 2).transpose(2, 3).reshape(s, h, d)
    pos = torch.arange(s, device=x.device, dtype=torch.float64)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float64) / d)
    ang = torch.cat([pos[:, None] * inv[None]] * 2, dim=-1)      # (S, D)
    cos = torch.cos(ang).float()[:, None]
    sin = torch.sin(ang).float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v, scale: float):
    """Causal attention: q, k (S, H, Dk), v (S, H, Dv) -> (S, H, Dv), in
    blocks of query rows."""
    s = q.shape[0]
    out = q.new_empty(s, q.shape[1], v.shape[-1])
    keys = torch.arange(s, device=q.device)
    for r0 in range(0, s, QUERY_BLOCK):
        r1 = min(s, r0 + QUERY_BLOCK)
        sc = torch.einsum("qhd,khd->hqk", q[r0:r1], k) * scale
        rows = torch.arange(r0, r1, device=q.device)
        sc = sc.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        out[r0:r1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1),
                                  v)
    return out


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    return (g * torch.sigmoid(g) * (x @ w_up)) @ w_down


def moe(x, lw: dict, m: dict):
    """The routed experts' weighted sum plus the shared experts: x (S, d)."""
    scores = torch.sigmoid(x @ lw["router"])
    idx = torch.topk(scores + lw["router_bias"], m["num_experts_per_tok"],
                     dim=-1).indices
    w = torch.gather(scores, -1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * m["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(m["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            y = swiglu(x[tok], lw["w_gate"][e], lw["w_up"][e],
                       lw["w_down"][e])
            out.index_add_(0, tok, y * w[tok, slot, None])
    return out + swiglu(x, lw["s_gate"], lw["s_up"], lw["s_down"])


def layer(x, lw: dict, m: dict):
    """One layer on one sequence x (S, d)."""
    s = x.shape[0]
    h, nope, rope_d, r, vd = (m["num_attention_heads"],
                              m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                              m["kv_lora_rank"], m["v_head_dim"])
    eps, theta = m["rms_norm_eps"], float(m["rope_theta"])
    xn = rms_norm(x, lw["ln1"], eps)
    q = (xn @ lw["wq"]).reshape(s, h, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = xn @ lw["wkv_a"]
    c = rms_norm(ckv[:, :r], lw["ln_kv"], eps)
    k_pe = ckv[:, None, r:]
    kv = (c @ lw["wkv_b"]).reshape(s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe, k_pe = rope(q_pe, theta), rope(k_pe, theta)
    qf = torch.cat([q_nope, q_pe], dim=-1)
    kf = torch.cat([k_nope, k_pe.expand(s, h, rope_d)], dim=-1)
    att = attention(qf, kf, v, 1.0 / math.sqrt(nope + rope_d))
    x = x + att.reshape(s, h * vd) @ lw["wo"]
    xn = rms_norm(x, lw["ln2"], eps)
    if "router" in lw:
        return x + moe(xn, lw, m)
    return x + swiglu(xn, lw["w_gate"], lw["w_up"], lw["w_down"])


def _layer_weights(weights: dict, m: dict, i: int, device) -> dict:
    nd = m["first_k_dense_replace"]
    group, j = ("dense_layers", i) if i < nd else ("moe_layers", i - nd)
    f32 = dict(device=device, dtype=torch.float32)
    lw = {k: v[i].to(**f32) for k, v in weights["layers"].items()}
    lw.update({k: v[j].to(**f32) for k, v in weights[group].items()})
    return lw


def decoder_logits(weights: dict, m: dict, seqs, wants) -> list:
    """Causal forward of each token sequence ``seqs[j]`` (1-D long
    tensors); returns the logits (len(wants[j]), vocab) at positions
    ``wants[j]``, over the published vocabulary only."""
    eps, vocab = m["rms_norm_eps"], m["vocab_size"]
    dev, embed = seqs[0].device, weights["embed"]
    f32 = dict(device=dev, dtype=torch.float32)
    hs = [embed[s.to(embed.device)].to(**f32) for s in seqs]
    for i in range(m["num_hidden_layers"]):
        lw = _layer_weights(weights, m, i, dev)
        hs = [layer(x, lw, m) for x in hs]
        del lw
    ln_f = weights["ln_f"].to(**f32)
    head = weights["head"][:, :vocab].to(**f32)
    return [rms_norm(x[want], ln_f, eps) @ head
            for x, want in zip(hs, wants)]
