"""Decoder-only transformer in PyTorch (mirror of ``repro.models.transformer``).

The weights live in a :class:`TransformerParams` module with every layer
weight stacked on axis 0, as ``repro.models.transformer.init_params``
lays them out; the entry points are plain functions over tensors with the
JAX package's names and signatures.  A Python loop over layers takes the
place of ``jax.lax.scan``.

Serving subset: ``forward`` (full sequence, optional KV collection),
``encode``, the dense-cache entry points ``make_cache``, ``decode_step``,
``chunk_extend`` and ``greedy_generate``, and the paged ones
``make_paged_cache``, ``paged_decode_step`` and ``paged_chunk_extend``.
JAX returns a new cache from the decode and extend entry points; the port
writes into the cache IN PLACE and returns the same dict, so a step costs
no copy of the cache.

Attention ops: ``forward``, ``encode`` and ``greedy_generate`` take the
full-sequence op ``attn_impl(q, k, v, causal)`` (the flash kernel's
contract, unrepeated KV heads); the decode steps take their decode op.
``None`` keeps the reference paths, which mirror JAX's einsums step for
step.  ``chunk_extend`` and ``paged_chunk_extend`` attend a chunk to a
cache at an offset, which is not the flash kernel's function: they keep
their plain attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.paged_attention.ref import engine_ref_attn
from repro_torch.models import common as cm


# ---------------------------------------------------------------------------
# Configs (field-for-field copies of the JAX dataclasses)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    moe: MoEConfig | None = None
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0          # ChatGLM partial rotary: 0.5
    causal: bool = True               # False => bidirectional encoder
    attention: str = "full"           # "full" | "sliding_window"
    window: int = 4096
    ffn_type: str = "swiglu"          # "swiglu" | "relu2" (Nemotron/Minitron)
    attn_block_kv: int = 1024         # chunked-attention KV block
    chunked_attn_threshold: int = 2048  # use online-softmax path above this S
    norm_eps: float = 1e-6
    pad_vocab_to: int = 512           # Megatron-style vocab padding for TP

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab_size // m) * m

    def param_count(self) -> int:
        """Analytic parameter count (matches init below)."""
        d, h, kv, dh, f, v = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.d_ff, self.vocab_size)
        n_ffn_mats = 2 if self.ffn_type == "relu2" else 3
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.moe is not None:
            ffn = d * self.moe.n_experts + self.moe.n_experts * n_ffn_mats * d * f
        else:
            ffn = n_ffn_mats * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class TransformerParams(nn.Module):
    """One transformer's weights as buffers of an ``nn.Module``.

    ``params["embed"]``, ``params["head"]``, ``params["ln_f"]`` and
    ``params["layers"][name]`` (stacked on axis 0) read like the JAX
    pytree; an int8 leaf is a ``{"q", "scale"}`` dict.  Buffers (not
    ``nn.Parameter``) because serving never differentiates; ``.to(device)``
    moves them all.
    """

    def __init__(self, tree: dict):
        super().__init__()
        self._paths: list[tuple[str, ...]] = []
        for path, t in _flatten(tree):
            self.register_buffer("__".join(path), t)
            self._paths.append(path)

    def tree(self) -> dict:
        out: dict = {}
        for path in self._paths:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return out

    def __getitem__(self, key: str):
        return self.tree()[key]

    @property
    def device(self) -> torch.device:
        return getattr(self, "__".join(self._paths[0])).device


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s weights from the stacked layer dict (int8 leaves too)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in layers.items()}


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3] by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    hi = 1.0 - lo
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = lo + u * (hi - lo)
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> TransformerParams:
    """Random weights with ``tr.init_params``'s shapes and scales, drawn
    from ``generator`` (which must live on ``device``).  Norm weights stay
    float32 whatever ``dtype`` is."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP queue 1, moe_ffn)")
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)
    device = torch.device(device if device is not None else generator.device)

    def stack(shape_per_layer, fan_in):
        w = _trunc_normal((L,) + shape_per_layer, generator, device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    layers: dict[str, Any] = {
        "ln1": ones(L, d), "ln2": ones(L, d),
        "wq": stack((d, h * dh), d),
        "wk": stack((d, kv * dh), d),
        "wv": stack((d, kv * dh), d),
        "wo": stack((h * dh, d), h * dh),
    }
    if cfg.ffn_type != "relu2":
        layers["w_gate"] = stack((d, f), d)
    layers["w_up"] = stack((d, f), d)
    layers["w_down"] = stack((f, d), f)
    vp = cfg.padded_vocab
    embed = torch.randn((vp, d), generator=generator, device=device) * 0.02
    head = _trunc_normal((d, vp), generator, device) * (1.0 / math.sqrt(d))
    return TransformerParams({"embed": embed.to(dtype), "head": head.to(dtype),
                              "ln_f": ones(d), "layers": layers})


# ---------------------------------------------------------------------------
# FFN and attention layer bodies
# ---------------------------------------------------------------------------

def moe_ffn(x, lp, cfg, compute_dtype=torch.bfloat16):
    raise NotImplementedError(
        "moe_ffn is not ported yet (ROADMAP queue 1: MoE after the engine)")


def dense_ffn(x: torch.Tensor, lp: dict, compute_dtype=torch.bfloat16,
              ffn_type: str = "swiglu") -> torch.Tensor:
    wu = cm.maybe_dequant(lp["w_up"], compute_dtype)
    wd = cm.maybe_dequant(lp["w_down"], compute_dtype)
    xc = x.to(compute_dtype)
    if ffn_type == "relu2":
        h = torch.square(torch.relu(xc @ wu))
    else:
        wg = cm.maybe_dequant(lp["w_gate"], compute_dtype)
        h = cm.swiglu(xc @ wg, xc @ wu)
    return (h @ wd).to(x.dtype)


def _ffn(xn, lp, cfg, compute_dtype):
    if cfg.moe is not None:
        return moe_ffn(xn, lp, cfg, compute_dtype)
    return dense_ffn(xn, lp, compute_dtype, cfg.ffn_type)


def _qkv(x, lp, cfg, positions, compute_dtype):
    B, S, _ = x.shape
    wq = cm.maybe_dequant(lp["wq"], compute_dtype)
    wk = cm.maybe_dequant(lp["wk"], compute_dtype)
    wv = cm.maybe_dequant(lp["wv"], compute_dtype)
    xc = x.to(compute_dtype)
    q = (xc @ wq).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (xc @ wk).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (xc @ wv).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    q = cm.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_frac)
    k = cm.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_frac)
    return q, k, v


def _attn_full_seq(x, lp, cfg, positions, compute_dtype, attn_impl=None):
    """Self-attention over a full sequence.  Returns (out, k, v).

    ``attn_impl(q, k, v, causal) -> (B, S, H, D)`` gets the unrepeated KV
    heads; ``None`` runs the reference paths below."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, lp, cfg, positions, compute_dtype)
    window = cfg.window if cfg.attention == "sliding_window" else None
    if attn_impl is not None:
        if window is not None:
            raise NotImplementedError(
                "the flash attention kernel has no sliding window; use "
                "attn_impl='ref' for a sliding_window config")
        out = attn_impl(q, k, v, cfg.causal)
        wo = cm.maybe_dequant(lp["wo"], compute_dtype)
        out = out.reshape(B, S, cfg.n_heads * cfg.d_head) @ wo
        return out.to(x.dtype), k, v
    kr = cm.repeat_kv(k, cfg.q_per_kv)
    vr = cm.repeat_kv(v, cfg.q_per_kv)
    if not cfg.causal:
        scale = 1.0 / math.sqrt(cfg.d_head)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    elif S > cfg.chunked_attn_threshold:
        out = cm.chunked_causal_attention(q, kr, vr, cfg.attn_block_kv, window)
    else:
        out = cm.naive_causal_attention(q, kr, vr, window)
    wo = cm.maybe_dequant(lp["wo"], compute_dtype)
    out = out.reshape(B, S, cfg.n_heads * cfg.d_head) @ wo
    return out.to(x.dtype), k, v


def _head(params, x, compute_dtype):
    head = cm.maybe_dequant(params["head"], compute_dtype)
    return x.to(compute_dtype) @ head


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(params: TransformerParams, tokens: torch.Tensor,
            cfg: TransformerConfig, compute_dtype=torch.bfloat16,
            collect_cache: bool = False, return_hidden: bool = False,
            attn_impl=None):
    """Full-sequence forward.  tokens: (B, S) int.

    Returns (logits, aux_loss), or (logits, aux_loss, cache) with
    ``collect_cache`` -- cache {"k","v"}: (L, B, S, H_kv, D) -- or the
    final normed hidden states with ``return_hidden``.  ``attn_impl`` is
    the full-sequence attention op (module docstring)."""
    B, S = tokens.shape
    embed = cm.maybe_dequant(params["embed"], compute_dtype)
    x = embed[tokens]
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    layers = params["layers"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(layers, i)
        h, k, v = _attn_full_seq(cm.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                 lp, cfg, positions, compute_dtype, attn_impl)
        x = x + h
        x = x + _ffn(cm.rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg,
                     compute_dtype)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = cm.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if return_hidden:
        return x
    logits = _head(params, x, compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        return logits, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, aux


def encode(params: TransformerParams, tokens: torch.Tensor,
           cfg: TransformerConfig, compute_dtype=torch.float32,
           attn_impl=None) -> torch.Tensor:
    """Mean-pooled, L2-normalized final hidden states (the embedding path)."""
    h = forward(params, tokens, cfg, compute_dtype, return_hidden=True,
                attn_impl=attn_impl)
    pooled = torch.mean(h.float(), dim=1)
    return pooled / (torch.linalg.norm(pooled, dim=-1, keepdim=True) + 1e-6)


def check_ids(tokens, cfg: TransformerConfig) -> None:
    """Refuse host token ids the embedding table has no row for.

    Ids in ``[vocab_size, padded_vocab)`` read the pad rows, as in JAX.  An
    id ``>= padded_vocab`` raises ``ValueError``: JAX's ``jnp.take`` gives
    a row of NaN for it, and ``embed[tokens]`` would raise on the CPU and
    hit a device-side assert on the card, which ends the CUDA context.
    Generated ids of a model with a larger vocabulary reach an encoder
    this way (rewrite, multi-query fan-out, iterative retrieval)."""
    tokens = np.asarray(tokens)
    bad = tokens[tokens >= cfg.padded_vocab]
    if bad.size:
        raise ValueError(
            f"token id {int(bad[0])} is outside {cfg.name}'s embedding table "
            f"of {cfg.padded_vocab} rows (padded_vocab)")


# ---------------------------------------------------------------------------
# Dense KV cache entry points
# ---------------------------------------------------------------------------
#
# Layout: {"k","v"}: (L, B, S_max, H_kv, D), one S_max-wide row per
# sequence.  JAX drops out-of-bounds scatter rows (mode="drop"); PyTorch has
# no drop mode and an out-of-bounds index on CUDA is a device-side assert,
# so the port computes the valid rows first and writes only those.

def make_cache(cfg: TransformerConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> dict:
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params: TransformerParams, cache: dict, token: torch.Tensor,
                pos: torch.Tensor, cfg: TransformerConfig,
                compute_dtype=torch.bfloat16, attn_impl=None,
                write_mask: torch.Tensor | None = None):
    """One autoregressive step against a dense KV cache.

    cache: {"k","v"}: (L, B, S_max, H_kv, D).  token: (B,) int32.  pos:
    (B,) int32, the next position per sequence (== its cache length).  Row
    b's K/V is written at position ``pos[b]``; a row at ``pos == S_max``
    (JAX drops it out of bounds) or with ``write_mask`` False is not
    written.  JAX's engine writes every row and then merges the old cache
    back into the rows that are not stepping; the mask gives that merged
    cache without the merge.  The cache is updated in place.

    ``attn_impl(q, k_cache, v_cache, cache_len) -> (B, 1, H, D)`` gets the
    layer's post-write (B, S_max, H_kv, D) caches; the default repeats KV
    heads and runs the reference masked softmax.  Returns (logits (B, V),
    cache).
    """
    B = token.shape[0]
    s_max = cache["k"].shape[2]
    h_kv, d = cfg.n_kv_heads, cfg.d_head
    embed = cm.maybe_dequant(params["embed"], compute_dtype)
    x = embed[token][:, None, :]                                  # (B, 1, d)
    pos_l = pos.long()
    valid = pos_l < s_max
    if write_mask is not None:
        valid = valid & write_mask.to(valid.device)
    rows = torch.nonzero(valid)[:, 0]          # one host sync, for all layers
    flat = rows * s_max + pos_l[rows]
    attn = attn_impl
    if attn is None:
        def attn(q, kc, vc, cache_len):
            return cm.decode_attention_ref(q, cm.repeat_kv(kc, cfg.q_per_kv),
                                           cm.repeat_kv(vc, cfg.q_per_kv),
                                           cache_len)
    cache_len = (pos + 1).to(torch.int32)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layer_params(layers, i)
        kc, vc = cache["k"][i], cache["v"][i]          # (B, S_max, H_kv, D)
        xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = _qkv(xn, lp, cfg, pos[:, None], compute_dtype)
        kc.view(B * s_max, h_kv, d).index_copy_(
            0, flat, k_new[rows, 0].to(kc.dtype))
        vc.view(B * s_max, h_kv, d).index_copy_(
            0, flat, v_new[rows, 0].to(vc.dtype))
        # JAX attends over the cache cast to the compute dtype
        out = attn(q, kc.to(compute_dtype), vc.to(compute_dtype), cache_len)
        wo = cm.maybe_dequant(lp["wo"], compute_dtype)
        x = x + (out.reshape(B, 1, cfg.n_heads * d) @ wo).to(x.dtype)
        x = x + _ffn(cm.rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg,
                     compute_dtype)
    x = cm.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params, x, compute_dtype)[:, 0]               # (B, V)
    return logits, cache


def greedy_generate(params: TransformerParams, tokens: torch.Tensor,
                    lengths: torch.Tensor, cfg: TransformerConfig, n_new: int,
                    compute_dtype=torch.bfloat16, attn_impl=None,
                    decode_attn_impl=None) -> torch.Tensor:
    """Batched greedy continuation.  tokens: (B, T) int32 prompts,
    right-padded; lengths: (B,) valid prompt lengths.  Returns (B, n_new)
    int32 generated tokens.

    One full prefill forward, a per-row first-token argmax, then decode
    steps against a dense cache of T + n_new positions.  ``attn_impl`` is
    the prefill's full-sequence attention op and ``decode_attn_impl`` the
    decode steps' (``decode_step``'s ``attn_impl``); ``None`` runs the
    reference attention, as JAX does.  Padding is inert: row
    b's pad positions >= lengths[b] hold garbage K/V from the prefill, but
    step i writes position lengths[b]+i before attending up to it.  JAX's
    scan also runs a last decode step whose token it drops; the port skips
    that step.
    """
    B, T = tokens.shape
    logits, _aux, prefix = forward(params, tokens, cfg, compute_dtype,
                                   collect_cache=True, attn_impl=attn_impl)
    cache = make_cache(cfg, B, T + n_new, prefix["k"].dtype,
                       device=tokens.device)
    for k, v in prefix.items():
        cache[k][:, :, :T] = v
    lengths = lengths.to(device=tokens.device, dtype=torch.int32)
    rows = torch.arange(B, device=tokens.device)
    tok = torch.argmax(logits[rows, lengths.long() - 1, :cfg.vocab_size],
                       dim=-1).to(torch.int32)
    out, pos = [tok], lengths
    for _ in range(n_new - 1):
        lg, cache = decode_step(params, cache, tok, pos, cfg, compute_dtype,
                                attn_impl=decode_attn_impl)
        tok = torch.argmax(lg[:, :cfg.vocab_size], dim=-1).to(torch.int32)
        pos = pos + 1
        out.append(tok)
    return torch.stack(out, dim=1)[:, :n_new]


def chunk_extend(params: TransformerParams, cache: dict, slot: int,
                 tokens: torch.Tensor, start_pos: int, n_valid: int,
                 cfg: TransformerConfig, compute_dtype=torch.bfloat16) -> dict:
    """Extend ONE dense slot's cache with a chunk of tokens in a single
    forward (iteration prefill for iterative retrieval).

    tokens: (T,) padded; only the first ``n_valid`` are real.  Chunk token
    i is written at position ``start_pos + i`` and attends to the slot's
    positions <= start_pos + i, so the result matches feeding the tokens
    one decode step at a time.  Pad rows and positions past S_max are not
    written (JAX drops them).  Returns the cache, updated in place.
    """
    s_max = cache["k"].shape[2]
    T = tokens.shape[0]
    slot, start_pos, n_valid = int(slot), int(start_pos), int(n_valid)
    dev = tokens.device
    embed = cm.maybe_dequant(params["embed"], compute_dtype)
    x = embed[tokens][None]                                       # (1, T, d)
    offs = torch.arange(T, device=dev)
    positions = (start_pos + offs)[None]                          # (1, T)
    # rows that JAX would not drop: real tokens at positions below S_max
    n_rows = max(0, min(n_valid, s_max - start_pos, T))
    scale = 1.0 / math.sqrt(cfg.d_head)
    mask = (torch.arange(s_max, device=dev)[None, None, None, :]
            <= positions[0][None, None, :, None])
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layer_params(layers, i)
        kc, vc = cache["k"][i], cache["v"][i]          # (B, S_max, H_kv, D)
        xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = _qkv(xn, lp, cfg, positions, compute_dtype)
        kc[slot, start_pos:start_pos + n_rows] = k_new[0, :n_rows].to(kc.dtype)
        vc[slot, start_pos:start_pos + n_rows] = v_new[0, :n_rows].to(vc.dtype)
        kr = cm.repeat_kv(kc[slot][None].to(compute_dtype), cfg.q_per_kv)
        vr = cm.repeat_kv(vc[slot][None].to(compute_dtype), cfg.q_per_kv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
        scores = torch.where(mask, scores, -math.inf)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
        wo = cm.maybe_dequant(lp["wo"], compute_dtype)
        x = x + (out.reshape(1, T, cfg.n_heads * cfg.d_head) @ wo).to(x.dtype)
        x = x + _ffn(cm.rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg,
                     compute_dtype)
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache entry points
# ---------------------------------------------------------------------------
#
# Physical layout: {"k","v"}: (L, n_pages, page, H_kv, D).  Position p of
# sequence b lives at physical row block_tables[b, p // page] * page +
# p % page.  JAX drops out-of-bounds scatter rows (mode="drop"); PyTorch has
# no drop mode and an out-of-bounds index on CUDA is a device-side assert,
# so the port computes the valid rows first and writes only those.

def make_paged_cache(cfg: TransformerConfig, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_step(params: TransformerParams, cache: dict,
                      token: torch.Tensor, pos: torch.Tensor,
                      block_tables: torch.Tensor, cfg: TransformerConfig,
                      compute_dtype=torch.bfloat16, attn_impl=None,
                      write_mask: torch.Tensor | None = None):
    """One autoregressive step against a PAGED KV cache.

    cache: {"k","v"}: (L, P, page, H_kv, D).  token/pos: (B,) int32.
    block_tables: (B, M) int32.  The new token's K/V goes to physical row
    ``block_tables[b, pos//page]*page + pos%page``; rows with
    ``write_mask`` False, or whose position lies past the table, are not
    written (JAX drops them out of bounds).  The pool is updated in place.

    ``attn_impl(q, k_pages, v_pages, block_tables, cache_len)`` is
    block-table-native: it gets the post-scatter pool (P, page, H_kv, D)
    of the layer and the tables.  Returns (logits (B, V), cache).
    """
    B = token.shape[0]
    _, P, page = cache["k"].shape[:3]
    M = block_tables.shape[1]
    embed = cm.maybe_dequant(params["embed"], compute_dtype)
    x = embed[token][:, None, :]                                  # (B, 1, d)
    pos_l = pos.long()
    page_log = pos_l // page
    phys = torch.gather(block_tables.long(), 1,
                        torch.clamp(page_log, max=M - 1)[:, None])[:, 0]
    flat = phys * page + pos_l % page
    valid = page_log < M
    if write_mask is not None:
        valid = valid & write_mask.to(valid.device)
    rows = torch.nonzero(valid)[:, 0]          # one host sync, for all layers
    flat = flat[rows]
    attn = attn_impl
    if attn is None:
        def attn(q, kp, vp, tables, cache_len):
            return engine_ref_attn(q, kp, vp, tables, cache_len,
                                   cfg.q_per_kv)
    cache_len = (pos + 1).to(torch.int32)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layer_params(layers, i)
        kc, vc = cache["k"][i], cache["v"][i]          # (P, page, H_kv, D)
        xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = _qkv(xn, lp, cfg, pos[:, None], compute_dtype)
        kf = kc.view(P * page, cfg.n_kv_heads, cfg.d_head)
        vf = vc.view(P * page, cfg.n_kv_heads, cfg.d_head)
        kf.index_copy_(0, flat, k_new[rows, 0].to(kf.dtype))
        vf.index_copy_(0, flat, v_new[rows, 0].to(vf.dtype))
        # JAX attends over the pool cast to the compute dtype
        out = attn(q, kc.to(compute_dtype), vc.to(compute_dtype),
                   block_tables, cache_len)
        wo = cm.maybe_dequant(lp["wo"], compute_dtype)
        x = x + (out.reshape(B, 1, cfg.n_heads * cfg.d_head) @ wo).to(x.dtype)
        x = x + _ffn(cm.rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg,
                     compute_dtype)
    x = cm.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params, x, compute_dtype)[:, 0]               # (B, V)
    return logits, cache


def paged_chunk_extend(params: TransformerParams, cache: dict,
                       block_row: torch.Tensor, tokens: torch.Tensor,
                       start_pos: int, n_valid: int, cfg: TransformerConfig,
                       compute_dtype=torch.bfloat16):
    """Extend ONE sequence's paged cache with a chunk of tokens.

    block_row: (M,) int32, the sequence's page table row.  tokens: (T,)
    padded; only the first ``n_valid`` are real.  Chunk token i is written
    at position ``start_pos + i`` (pad rows and positions past the table
    are not written) and attends over the gathered logical view, so the
    result matches feeding the tokens one decode step at a time.  Returns
    (cache, logits of the last valid row (V,)); the pool is updated in
    place.
    """
    _, P, page = cache["k"].shape[:3]
    M = block_row.shape[0]
    S = M * page
    T = tokens.shape[0]
    start_pos, n_valid = int(start_pos), int(n_valid)
    dev = tokens.device
    embed = cm.maybe_dequant(params["embed"], compute_dtype)
    x = embed[tokens][None]                                       # (1, T, d)
    offs = torch.arange(T, device=dev)
    positions = (start_pos + offs)[None]                          # (1, T)
    # rows that JAX would not drop: real tokens whose position is in the table
    n_rows = max(0, min(n_valid, M * page - start_pos, T))
    wpos = start_pos + offs[:n_rows]
    flat = block_row.long()[wpos // page] * page + wpos % page
    scale = 1.0 / math.sqrt(cfg.d_head)
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            <= positions[0][None, None, :, None])
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layer_params(layers, i)
        kc, vc = cache["k"][i], cache["v"][i]
        xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = _qkv(xn, lp, cfg, positions, compute_dtype)
        kf = kc.view(P * page, cfg.n_kv_heads, cfg.d_head)
        vf = vc.view(P * page, cfg.n_kv_heads, cfg.d_head)
        kf.index_copy_(0, flat, k_new[0, :n_rows].to(kf.dtype))
        vf.index_copy_(0, flat, v_new[0, :n_rows].to(vf.dtype))
        kg = kc[block_row].reshape(1, S, cfg.n_kv_heads, cfg.d_head)
        vg = vc[block_row].reshape(1, S, cfg.n_kv_heads, cfg.d_head)
        kr = cm.repeat_kv(kg.to(compute_dtype), cfg.q_per_kv)
        vr = cm.repeat_kv(vg.to(compute_dtype), cfg.q_per_kv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
        scores = torch.where(mask, scores, -math.inf)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
        wo = cm.maybe_dequant(lp["wo"], compute_dtype)
        x = x + (out.reshape(1, T, cfg.n_heads * cfg.d_head) @ wo).to(x.dtype)
        x = x + _ffn(cm.rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg,
                     compute_dtype)
    xf = cm.rms_norm(x, params["ln_f"], cfg.norm_eps)
    last = xf[0, max(n_valid - 1, 0)]
    return cache, _head(params, last, compute_dtype)             # (V,)
