"""Float32 decoder and encoder forward passes, layer by layer.

``weights`` is the tree the benchmark drew (``embed`` (V_pad, d), ``head``
(d, V_pad), ``ln_f``, and ``layers`` stacked on axis 0: ``ln1``, ``ln2``,
``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``); ``m`` a
configuration's ``model`` or ``encoder`` group.  Each layer's weights are
cast to float32 once and applied to every sequence before the next layer,
so a batch of long sequences fits beside the served weights.
"""

from __future__ import annotations

import contextlib
import math

import torch

QUERY_BLOCK = 512      # query rows a block of attention scores holds


@contextlib.contextmanager
def fp32_exact():
    """Float32 matmuls in float32: TF32 off while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float, frac: float):
    """Rotate interleaved pairs (x[2i], x[2i+1]) of the first ``frac`` of
    each head's dims by position.  x: (B, S, H, D)."""
    s, d = x.shape[1], x.shape[-1]
    d_rot = int(d * frac)
    d_rot -= d_rot % 2
    pos = torch.arange(s, device=x.device, dtype=torch.float64)
    inv = 1.0 / (theta ** (torch.arange(0, d_rot, 2, device=x.device,
                                        dtype=torch.float64) / d_rot))
    ang = pos[:, None] * inv[None]                       # (S, d_rot/2)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., 0:d_rot:2], x[..., 1:d_rot:2]
    out = x.clone()
    out[..., 0:d_rot:2] = x1 * cos - x2 * sin
    out[..., 1:d_rot:2] = x2 * cos + x1 * sin
    return out


def attention(q, k, v, causal: bool):
    """q: (B, S, H, D); k, v: (B, S, H_kv, D) -> (B, S, H, D), softmax
    over keys in float32, in blocks of query rows."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    qg = q.reshape(b, s, h_kv, g, d).permute(0, 2, 3, 1, 4)   # (B,Hk,G,S,D)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                     # (B,Hk,1,D,S)
    vt = v.permute(0, 2, 1, 3)[:, :, None]                     # (B,Hk,1,S,D)
    out = torch.empty_like(qg)
    scale = 1.0 / math.sqrt(d)
    keys = torch.arange(s, device=q.device)
    for r0 in range(0, s, QUERY_BLOCK):
        r1 = min(s, r0 + QUERY_BLOCK)
        sc = torch.matmul(qg[..., r0:r1, :], kt) * scale       # (...,rows,S)
        if causal:
            rows = torch.arange(r0, r1, device=q.device)
            sc = sc.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        out[..., r0:r1, :] = torch.matmul(torch.softmax(sc, dim=-1), vt)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def layer(x, lw: dict, m: dict, causal: bool):
    """One pre-norm block: x + attn(norm(x)), then + SwiGLU(norm(x))."""
    b, s, _ = x.shape
    h, h_kv, d = (m["num_attention_heads"], m["num_key_value_heads"],
                  m["head_dim"])
    eps, theta, frac = (m["rms_norm_eps"], m["rope_theta"],
                        m["partial_rotary_factor"])
    xn = rms_norm(x, lw["ln1"], eps)
    q = rope((xn @ lw["wq"]).reshape(b, s, h, d), theta, frac)
    k = rope((xn @ lw["wk"]).reshape(b, s, h_kv, d), theta, frac)
    v = (xn @ lw["wv"]).reshape(b, s, h_kv, d)
    x = x + attention(q, k, v, causal).reshape(b, s, h * d) @ lw["wo"]
    xn = rms_norm(x, lw["ln2"], eps)
    gate = xn @ lw["w_gate"]
    return x + (gate * torch.sigmoid(gate) * (xn @ lw["w_up"])) @ lw["w_down"]


def _layer_weights(weights: dict, i: int) -> dict:
    return {k: v[i].float() for k, v in weights["layers"].items()}


def decoder_logits(weights: dict, m: dict, seqs, wants) -> list:
    """Causal forward of each token sequence ``seqs[j]`` (1-D long
    tensors); returns the logits (len(wants[j]), vocab) at positions
    ``wants[j]``, over the published vocabulary only."""
    eps, vocab = m["rms_norm_eps"], m["vocab_size"]
    hs = [weights["embed"][s].float()[None] for s in seqs]
    for i in range(m["num_hidden_layers"]):
        lw = _layer_weights(weights, i)
        hs = [layer(h, lw, m, causal=True) for h in hs]
        del lw
    ln_f = weights["ln_f"].float()
    head = weights["head"][:, :vocab].float()
    return [rms_norm(h[0, want], ln_f, eps) @ head
            for h, want in zip(hs, wants)]


def encode(weights: dict, m: dict, tokens, block: int = 64):
    """Bidirectional encoder over (N, S) token rows, mean-pooled and
    L2-normalized (norm + 1e-6), in blocks of ``block`` rows."""
    eps = m["rms_norm_eps"]
    layers = [_layer_weights(weights, i)
              for i in range(m["num_hidden_layers"])]
    ln_f = weights["ln_f"].float()
    outs = []
    for r0 in range(0, tokens.shape[0], block):
        x = weights["embed"][tokens[r0:r0 + block]].float()
        for lw in layers:
            x = layer(x, lw, m, causal=False)
        pooled = torch.mean(rms_norm(x, ln_f, eps), dim=1)
        outs.append(pooled / (torch.linalg.norm(pooled, dim=-1, keepdim=True)
                              + 1e-6))
    return torch.cat(outs)
