"""Shared model building blocks in PyTorch (mirror of ``repro.models.common``).

Every function keeps the JAX package's layouts and dtype flow step for
step, so the same numpy inputs give the same numbers in both frameworks:
norms and softmax statistics run in float32, matmuls in the caller's
compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """float32 statistics, times the (float32) weight, cast back to x's dtype."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight).to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, rotary_frac: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    d_rot = int(d_head * rotary_frac)
    d_rot -= d_rot % 2
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).

    Rotates INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` and stacks
    them back, as the JAX package does -- not the half-split layout most
    PyTorch code uses.  ``rotary_frac < 1`` rotates only the leading
    fraction of the head dims.
    """
    d_head = x.shape[-1]
    inv_freq = rope_freqs(d_head, theta, rotary_frac, device=x.device)
    d_rot = inv_freq.shape[0] * 2
    angles = positions[..., :, None].float() * inv_freq     # (..., S, d_rot/2)
    cos = torch.cos(angles)[..., :, None, :]                 # (..., S, 1, d_rot/2)
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    # bf16 x times f32 cos promotes to f32, as jnp does
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention (plain reference paths; the CUDA kernels live in repro_torch.kernels)
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, H_kv, D) -> (B, S, H_kv * n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def naive_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: int | None = None) -> torch.Tensor:
    """Materialized-scores causal attention.  q,k,v: (B, S, H, D)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A chunk's attention over caches at an offset: q (B, T, H, D) over
    k/v (B, S, H_kv, D) in the cache's dtype, cast to the compute dtype as
    JAX attends; ``mask`` (B or 1, 1, T, S) is True where a query sees a
    position."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[2] // k.shape[2]
    kr = repeat_kv(k.to(compute_dtype), n_rep)
    vr = repeat_kv(v.to(compute_dtype), n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
    scores = torch.where(mask, scores, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, block_kv: int = 1024,
                             window: int | None = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks; never materializes the
    (S, S) score matrix.  q,k,v: (B, S, H, D) with equal q/kv length."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    n_blocks = -(-s // block_kv)
    pad = n_blocks * block_kv - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for blk in range(n_blocks):
        k_blk = k[:, blk * block_kv:(blk + 1) * block_kv]
        v_blk = v[:, blk * block_kv:(blk + 1) * block_kv]
        kpos = blk * block_kv + torch.arange(block_kv, device=q.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        mask = mask & (kpos[None, :] < s)
        scores = torch.where(mask[None, None], scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), v_blk).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)            # (B, S, H, D)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention.  q: (B, 1, H, D); caches: (B, S, H, D).

    ``cache_len`` masks out unwritten cache slots (scalar or (B,))."""
    b, s, h, d = k_cache.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    cache_len = torch.as_tensor(cache_len, device=q.device)
    valid = torch.arange(s, device=q.device)[None, :] < cache_len.reshape(-1, 1)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache)


# ---------------------------------------------------------------------------
# Int8 serving quantization
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor, axis: int = -1) -> dict:
    """Symmetric per-channel int8 quantization."""
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = (amax / 127.0 + 1e-12).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_int8(wq: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (wq["q"].float() * wq["scale"]).to(dtype)


def maybe_dequant(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Weight in ``dtype``.  A weight already held in ``dtype`` is returned
    as is, so weights stored once in the compute dtype cost no cast per
    call -- and give the same numbers as casting an f32 master per call."""
    if isinstance(w, dict) and "q" in w:
        return dequantize_int8(w, dtype)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3] by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    hi = 1.0 - lo
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = lo + u * (hi - lo)
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)


def count_params(params) -> int:
    """Elements of every tensor leaf of a tree of nested dicts and lists
    (an int8 leaf's ``q`` and ``scale`` both count, as in JAX), or of a
    module's parameters and buffers."""
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, list):
        return sum(count_params(v) for v in params)
    if isinstance(params, torch.nn.Module):
        return sum(t.numel() for t in params.parameters()) + sum(
            t.numel() for t in params.buffers())
    return params.numel() if isinstance(params, torch.Tensor) else 0


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy.  logits: (..., V); labels: int (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
