"""Decoder-only transformer in PyTorch (mirror of ``repro.models.transformer``).

The weights live in a :class:`TransformerParams` module with every layer
weight stacked on axis 0, as ``repro.models.transformer.init_params``
lays them out; the entry points are plain functions over tensors with the
JAX package's names and signatures.  A Python loop over layers takes the
place of ``jax.lax.scan``.  The FFN is dense or a mixture of experts
(``moe_ffn``: JAX's capacity dispatch, step for step).  A
``LatentMoEConfig`` (DeepSeek-V3: Moonlight-16B-A3B), which the JAX
package does not have, takes latent attention (``models/mla.py``) and,
past its leading dense layers, the sigmoid-routed experts with shared
experts (``routed_moe_ffn``: no token dropped), its FFN weights in layer
groups of their own (``layer_weights``).

Serving subset: ``forward`` (full sequence, optional KV collection),
``prefill``, ``encode``, the dense-cache entry points ``make_cache``,
``decode_step``, ``chunk_extend`` and ``greedy_generate``, the paged ones
``make_paged_cache``, ``paged_decode_step``, ``paged_chunk_extend_batch``
(chunks of several sequences in one forward: the serving engine appends a
retrieval batch's documents with one call) and its one-row call
``paged_chunk_extend``, and ``quantize_for_serving`` (int8 weights).
Training: ``loss_fn`` and ``forward(..., remat=True)`` over a plain nested
dict of parameters that require grad
(``repro_torch.training.train_loop.init_state``).
``abstract_params`` and ``abstract_cache`` build the same trees on the
meta device (shapes and dtypes, no storage) for the cell programs and the
dry-run.  ``forward``'s ``sp_spec``, ``moe_ffn``'s ``"moe_dispatch"`` hint
and the ``"q_proj"`` / ``"kv_proj"`` hints of the attention projections
redistribute DTensor activations (``repro_torch.distributed.hints``); on
plain tensors they do nothing.
JAX returns a new cache from the decode and extend entry points; the port
writes into the cache IN PLACE and returns the same dict, so a step costs
no copy of the cache.

One layer body, ``_layer``, serves every entry point: ``ln1``, the
projections and RoPE, attention, ``wo`` and its residual, ``ln2``, the
FFN and its residual.  An entry point is where the new K/V go and what
they attend over: its ``attend(q, k, v)``.  ``forward`` attends within
the sequence (``_attn_full_seq``); the cache entry points run the layers
through ``_layers``, their ``attend`` writing the layer's K/V into the
cache and attending over it.

Attention ops: ``forward``, ``prefill``, ``encode`` and
``greedy_generate`` take the full-sequence op ``attn_impl(q, k, v,
causal)`` (the flash kernel's contract, unrepeated KV heads); the decode
steps take their decode op.  ``None`` keeps the reference paths, which
mirror JAX's einsums step for step.  The paged chunk extends take the
block-table-native chunk op ``attn_impl(q, k_pages, v_pages, block_rows,
starts)`` (the paged chunk-extend kernel's contract); without it they
run that kernel's plain version, which like the dense ``chunk_extend``
attends a chunk to its cache at an offset through the one plain chunk
attention, ``common.chunk_attention``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import hints
from repro_torch.kernels.paged_attention.ref import engine_ref_attn
from repro_torch.kernels.paged_chunk_attention.ref import (
    paged_chunk_attention_ref, tables_upto)
from repro_torch.models import common as cm
from repro_torch.models import mla as latent


# ---------------------------------------------------------------------------
# Configs (field-for-field copies of the JAX dataclasses)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention's widths (``models/mla.py``)."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of one latent row: the compressed KV and the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.qk_head_dim)


@dataclass(frozen=True)
class RoutedMoEConfig:
    """DeepSeek-V3's sparse FFN (``routed_moe_ffn``): sigmoid scores, the
    top ``top_k`` of scores plus a correction bias chosen, gate weights
    the chosen scores normalised to sum 1, times ``routed_scale``;
    ``n_shared`` shared experts always on (one SwiGLU of ``n_shared *
    d_expert``); no token dropped.  The first ``first_dense`` layers have
    a dense SwiGLU FFN of ``d_ff`` instead."""
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int
    first_dense: int
    routed_scale: float


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
    # set by ``LatentMoEConfig`` only; class attributes, not fields, so the
    # fields stay the JAX dataclass's
    mla = None
    routed = None

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

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d, h, kv, dh, f = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.d_head, self.d_ff)
        n_ffn_mats = 2 if self.ffn_type == "relu2" else 3
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        ffn = d * self.moe.n_experts + self.moe.top_k * n_ffn_mats * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d + d


@dataclass(frozen=True)
class LatentMoEConfig(TransformerConfig):
    """A DeepSeek-V3 decoder (Moonlight-16B-A3B): latent attention
    (``mla``; ``n_kv_heads`` is ``n_heads`` and ``d_head`` the query-key
    head, ``mla.qk_head_dim``) and, after ``routed.first_dense`` dense
    layers, the routed experts (``routed``).  The JAX package has no such
    model, so this subclass carries what its dataclass lacks.

    Weights: ``layers`` stacks every layer's ``ln1``,
    ``ln2``, ``wq`` (d, H * qk), ``wkv_a`` (d, latent_dim), ``ln_kv``
    (kv_lora_rank), ``wkv_b`` (kv_lora_rank, H * (qk_nope + v)), ``wo``
    (H * v, d); ``dense_layers`` the first layers' ``w_gate``, ``w_up``,
    ``w_down``; ``moe_layers`` the rest's ``router`` (d, E),
    ``router_bias`` (E,) float32, experts ``w_gate``, ``w_up`` (E, d,
    d_expert), ``w_down`` (E, d_expert, d) and shared ``s_gate``,
    ``s_up`` (d, n_shared * d_expert), ``s_down``."""
    mla: MLAConfig | None = None
    routed: RoutedMoEConfig | None = None

    def param_count(self) -> int:
        d, h, v, L = self.d_model, self.n_heads, self.vocab_size, self.n_layers
        m, r = self.mla, self.routed
        attn = (d * h * m.qk_head_dim + d * m.latent_dim + m.kv_lora_rank
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                + h * m.v_head_dim * d + 2 * d)
        dense = 3 * d * self.d_ff
        moe = (d * r.n_experts + r.n_experts
               + r.n_experts * 3 * d * r.d_expert
               + 3 * d * r.n_shared * r.d_expert)
        return (L * attn + r.first_dense * dense
                + (L - r.first_dense) * moe + 2 * v * d + d)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class TransformerParams(nn.Module):
    """One transformer's weights as buffers of an ``nn.Module``.

    ``params["embed"]``, ``params["head"]``, ``params["ln_f"]`` and
    ``params["layers"][name]`` (stacked on axis 0) read like the JAX
    pytree; an int8 leaf is a ``{"q", "scale"}`` dict.  Buffers (not
    ``nn.Parameter``) because serving never differentiates; ``.to(device)``
    moves them all.  Training differentiates a nested dict of the same
    leaves (``tree()``), made to require grad by ``init_state``.
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


def layer_weights(params, cfg: TransformerConfig, i: int) -> dict:
    """Layer ``i``'s weights: the stacked ``layers`` and, for a routed-MoE
    config, its FFN's group (``dense_layers`` or ``moe_layers``)."""
    lp = layer_params(params["layers"], i)
    r = cfg.routed
    if r is not None:
        group, j = (("dense_layers", i) if i < r.first_dense
                    else ("moe_layers", i - r.first_dense))
        lp.update(layer_params(params[group], j))
    return lp


def unstack_layers(layers: dict, n_layers: int) -> list[dict]:
    """Every layer's weights (``layer_params`` of each i) as views made by
    one ``torch.unbind`` a stacked leaf.  Under autograd a stack's
    gradient is then one stack of its layers' gradients; indexing the
    stack layer by layer would give each layer's gradient as a zero-filled
    tensor the size of the whole stack, summed L times."""
    cols = {k: ({kk: torch.unbind(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.unbind(v))
            for k, v in layers.items()}
    return [layer_params(cols, i) for i in range(n_layers)]


def _unstacked(params, cfg: TransformerConfig) -> list[dict]:
    """``unstack_layers`` of every layer, a routed-MoE config's FFN groups
    merged into their layers (``layer_weights`` of each i)."""
    lps = unstack_layers(params["layers"], cfg.n_layers)
    r = cfg.routed
    if r is not None:
        nd = r.first_dense
        for group, lo, n in (("dense_layers", 0, nd),
                             ("moe_layers", nd, cfg.n_layers - nd)):
            for lp, own in zip(lps[lo:lo + n],
                               unstack_layers(params[group], n)):
                lp.update(own)
    return lps


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> TransformerParams:
    """Random weights with ``tr.init_params``'s shapes and scales, drawn
    from ``generator`` (which must live on ``device``).  Norm weights stay
    float32 whatever ``dtype`` is.  An MoE config's expert stacks are
    drawn a layer at a time into a stack of ``dtype``: Moonlight's
    ``w_up`` whole in float32 would take 35 GB beside its 56 GB of bf16
    weights."""
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)
    device = torch.device(device if device is not None else generator.device)

    def stack(shape_per_layer, fan_in):
        w = cm.trunc_normal((L,) + shape_per_layer, generator, device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    def expert_stack(shape_per_layer, fan_in):
        w = torch.empty((L,) + shape_per_layer, dtype=dtype, device=device)
        for i in range(L):
            w[i] = (cm.trunc_normal(shape_per_layer, generator, device)
                    * (1.0 / math.sqrt(fan_in)))
        return w

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    layers: dict[str, Any] = {
        "ln1": ones(L, d), "ln2": ones(L, d),
        "wq": stack((d, h * dh), d),
        "wk": stack((d, kv * dh), d),
        "wv": stack((d, kv * dh), d),
        "wo": stack((h * dh, d), h * dh),
    }
    gated = cfg.ffn_type != "relu2"
    if cfg.moe is None:
        if gated:
            layers["w_gate"] = stack((d, f), d)
        layers["w_up"] = stack((d, f), d)
        layers["w_down"] = stack((f, d), f)
    else:
        E = cfg.moe.n_experts
        layers["router"] = stack((d, E), d)
        if gated:
            layers["w_gate"] = expert_stack((E, d, f), d)
        layers["w_up"] = expert_stack((E, d, f), d)
        layers["w_down"] = expert_stack((E, f, d), f)
    vp = cfg.padded_vocab
    embed = torch.randn((vp, d), generator=generator, device=device) * 0.02
    head = cm.trunc_normal((d, vp), generator, device) * (1.0 / math.sqrt(d))
    return TransformerParams({"embed": embed.to(dtype), "head": head.to(dtype),
                              "ln_f": ones(d), "layers": layers})


def abstract_params(cfg: TransformerConfig,
                    dtype=torch.float32) -> TransformerParams:
    """``init_params``'s weights on the meta device: shapes and dtypes, no
    storage (the reference's ``jax.eval_shape`` of its init)."""
    return init_params(cfg, torch.Generator(), dtype, device="meta")


def _quantize_int8_sliced(w: torch.Tensor, max_elems: int = 1 << 27) -> dict:
    """``cm.quantize_int8(w)`` computed over slices of axis 0 of at most
    ``max_elems`` elements (a layer of an expert stack at full width): the
    scale runs along the last axis, so the numbers are the same and no
    float32 copy of the whole weight is made."""
    step = max(1, max_elems // w[0].numel())
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-1] + (1,), dtype=torch.float32,
                        device=w.device)
    for i in range(0, w.shape[0], step):
        part = cm.quantize_int8(w[i:i + step])
        q[i:i + step] = part["q"]
        scale[i:i + step] = part["scale"]
    return {"q": q, "scale": scale}


def quantize_for_serving(params: TransformerParams) -> TransformerParams:
    """Per-channel int8 quantization of all matmul weights (paper §4):
    every weight but the norms becomes ``{"q": int8, "scale": float32}``
    along its last axis, as in JAX.  A routed-MoE config's layer groups
    (``dense_layers``, ``moe_layers``) go the same way, the router's
    correction bias kept as it is."""
    tree = params.tree()
    out = {"ln_f": tree["ln_f"],
           "embed": _quantize_int8_sliced(tree["embed"]),
           "head": _quantize_int8_sliced(tree["head"])}
    for group, leaves in tree.items():
        if isinstance(leaves, dict):
            out[group] = {name: (w if name.startswith("ln")
                                 or name == "router_bias"
                                 else _quantize_int8_sliced(w))
                          for name, w in leaves.items()}
    return TransformerParams(out)


# ---------------------------------------------------------------------------
# FFN and attention layer bodies
# ---------------------------------------------------------------------------

def moe_route(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
              compute_dtype=torch.bfloat16):
    """Router of ``moe_ffn``: (gates (B, S, E) f32, normalized top-k gate
    values (B, S, k), top-k experts (B, S, k), scalar aux loss)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    # router matmul in the compute dtype, softmax statistics in f32
    router = cm.maybe_dequant(lp["router"], compute_dtype)
    logits = x.to(compute_dtype) @ router                        # (B, S, E)
    gates = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k breaks ties by the lower index and torch.topk does
    # not; a stable descending sort does, in JAX's order within the k
    gval, eidx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gval, eidx = gval[..., :k], eidx[..., :k]                    # (B, S, k)
    gval = gval / (torch.sum(gval, dim=-1, keepdim=True) + 1e-9)
    # aux loss (Switch): E * sum_e frac_tokens_e * mean_prob_e
    frac = torch.mean(F.one_hot(eidx[..., 0], E).float(), dim=(0, 1))
    prob = torch.mean(gates, dim=(0, 1))
    return gates, gval, eidx, E * torch.sum(frac * prob)


def capacity_slots(eidx: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, choice)'s slot in the (E, C) buffer of its batch row,
    filled in slot order ``(s0: c0..ck-1, s1, ...)``: (slot (B, S*k),
    keep (B, S*k)); a slot past its expert's capacity is ``E*C``
    (dropped) and not kept."""
    B = eidx.shape[0]
    E, C = n_experts, capacity
    eflat = eidx.reshape(B, -1)                                  # (B, T)
    onehot = F.one_hot(eflat, E)                                 # (B, T, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos, 2, eflat[..., None])[..., 0]         # (B, T)
    keep = pos < C
    return torch.where(keep, eflat * C + pos, E * C), keep


def moe_ffn(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
            compute_dtype=torch.bfloat16):
    """x: (B, S, d) -> ((B, S, d), scalar aux load-balancing loss).

    JAX's capacity dispatch per batch row, step for step: each token's
    top-k experts fill slots of an (E, C) buffer in slot order
    (``capacity_slots``), ``C = ceil(S * k / E * capacity_factor)`` from
    the (padded) S, and a slot past an expert's C is dropped.  Every
    expert runs on its C slots, filled or not.
    """
    B, S, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = max(1, int(math.ceil(S * k / E * cfg.moe.capacity_factor)))
    _gates, gval, eidx, aux = moe_route(x, lp, cfg, compute_dtype)
    T = S * k
    slot, keep = capacity_slots(eidx, E, C)

    # which token fills each (expert, capacity) slot: JAX scatters with
    # mode="drop"; here the dropped slots land in row E*C, sliced off
    tok_ids = torch.arange(T, device=x.device).expand(B, T)
    inv = torch.full((B, E * C + 1), T, dtype=torch.long,
                     device=x.device).scatter(1, slot, tok_ids)
    inv = inv[:, :E * C]                                         # (B, E*C)
    # jnp.repeat(x, k, axis=1), by a broadcast: no host sync on the card
    x_slots = x[:, :, None].expand(B, S, k, d).reshape(B, T, d).to(
        compute_dtype)
    x_pad = F.pad(x_slots, (0, 0, 0, 1))                         # row T = 0
    hb = torch.gather(x_pad, 1, inv[..., None].expand(B, E * C, d))
    hb = hints.constrain(hb.reshape(B, E, C, d), "moe_dispatch")

    wu = cm.maybe_dequant(lp["w_up"], compute_dtype)
    wd = cm.maybe_dequant(lp["w_down"], compute_dtype)
    up = torch.einsum("becd,edf->becf", hb, wu)
    if cfg.ffn_type == "relu2":
        act = torch.square(torch.relu(up))
    else:
        wg = cm.maybe_dequant(lp["w_gate"], compute_dtype)
        act = cm.swiglu(torch.einsum("becd,edf->becf", hb, wg), up)
    out = torch.einsum("becf,efd->becd", act, wd)
    out = hints.constrain(out, "moe_dispatch").reshape(B, E * C, d)

    slot_safe = torch.clamp(slot, max=E * C - 1)
    y = torch.gather(out, 1, slot_safe[..., None].expand(B, T, d))  # (B, T, d)
    y = torch.where(keep[..., None], y, 0.0)
    y = (y.reshape(B, S, k, d) * gval[..., None].to(compute_dtype)).sum(dim=2)
    return y.to(x.dtype), aux


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


def route_sigmoid(x: torch.Tensor, lp: dict, cfg: TransformerConfig):
    """DeepSeek-V3's ``noaux_tc`` router with one group, in float32 as the
    published gate computes it: x (T, d) -> (experts (T, k), gate weights
    (T, k) float32).  Scores are sigmoid(x W_router); the top k of scores
    plus ``router_bias`` are chosen; the weights are the chosen scores
    without the bias, normalised to sum 1, times ``routed_scale``."""
    r = cfg.routed
    scores = torch.sigmoid(x.float()
                           @ cm.maybe_dequant(lp["router"], torch.float32))
    eidx = torch.topk(scores + lp["router_bias"].float(), r.top_k,
                      dim=-1).indices
    gates = torch.gather(scores, -1, eidx)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
    return eidx, gates * r.routed_scale


@dataclass
class RouteStats:
    """What a decode step's routed layers record on the device, with no
    host read: ``live`` (B,) the rows that step; ``stats`` (2,) float32,
    summed over the layers: distinct experts the live rows chose and the
    most live rows one expert took."""
    live: torch.Tensor
    stats: torch.Tensor


def routed_moe_ffn(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
                   compute_dtype=torch.bfloat16,
                   route: RouteStats | None = None,
                   gate_x: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the routed experts' weighted sum plus
    the shared experts, dropping no token at any batch.  The router reads
    ``gate_x`` (default x), the same rows before any rounding to x's
    dtype.

    The dispatch sorts the T x k (token, choice) pairs by expert (a stable
    sort on the device), gathers their rows, and runs each expert's rows
    as one group of ``torch._grouped_mm`` whose group ends are the
    experts' counts summed on the device; the outputs go back to their
    pairs by one ``index_copy_`` and are weighted and summed in float32.
    Nothing is read on the host, so a CUDA graph can replay it; every
    pair is computed once, with no padding to a capacity (the extra work
    is the sort, the gather of T x k rows and the copy back)."""
    B, S, d = x.shape
    r = cfg.routed
    xf = x.reshape(B * S, d)
    eidx, gates = route_sigmoid(
        xf if gate_x is None else gate_x.reshape(B * S, d), lp, cfg)  # (T, k)
    T, k = eidx.shape
    flat = eidx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(r.n_experts, dtype=torch.int32,
                         device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    xs = xf.to(compute_dtype)[order // k]                        # (T*k, d)
    wg = cm.maybe_dequant(lp["w_gate"], compute_dtype)
    wu = cm.maybe_dequant(lp["w_up"], compute_dtype)
    wd = cm.maybe_dequant(lp["w_down"], compute_dtype)
    h = cm.swiglu(torch._grouped_mm(xs, wg, offs=ends),
                  torch._grouped_mm(xs, wu, offs=ends))
    ys = torch._grouped_mm(h, wd, offs=ends)
    y = torch.empty_like(ys).index_copy_(0, order, ys)          # pair order
    y = (y.reshape(T, k, d).float() * gates[..., None]).sum(dim=1)
    shared = dense_ffn(xf, {"w_gate": lp["s_gate"], "w_up": lp["s_up"],
                            "w_down": lp["s_down"]}, compute_dtype)
    if route is not None:
        live = route.live.to(torch.float32)[:, None].expand(
            B, S * k).reshape(-1)
        took = torch.zeros(r.n_experts, dtype=torch.float32,
                           device=x.device).scatter_add_(0, flat, live)
        route.stats.add_(torch.stack([(took > 0).sum().float(),
                                      took.max()]))
    return (y.to(compute_dtype) + shared.to(compute_dtype)).to(
        x.dtype).reshape(B, S, d)


def _ffn(x, lp, cfg, compute_dtype, route=None):
    """``ln2``, then the FFN: (its output, the MoE aux loss or None for a
    dense FFN).  A routed layer's router reads the normed rows in float32,
    before their rounding to x's dtype."""
    xn = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.routed is not None and "router" in lp:
        gate_x = cm.rms_norm(x.float(), lp["ln2"], cfg.norm_eps)
        return routed_moe_ffn(xn, lp, cfg, compute_dtype, route,
                              gate_x), None
    if cfg.moe is not None:
        return moe_ffn(xn, lp, cfg, compute_dtype)
    return dense_ffn(xn, lp, compute_dtype, cfg.ffn_type), None


def _qkv(x, lp, cfg, positions, compute_dtype):
    B, S, _ = x.shape
    wq = cm.maybe_dequant(lp["wq"], compute_dtype)
    wk = cm.maybe_dequant(lp["wk"], compute_dtype)
    wv = cm.maybe_dequant(lp["wv"], compute_dtype)
    xc = x.to(compute_dtype)
    # the "q_proj" / "kv_proj" hints reshard a DTensor projection whose
    # heads do not divide the mesh's "model" axis before its view as heads
    q_spec, kv_spec = hints.hint("q_proj"), hints.hint("kv_proj")
    q = hints.constrain_to(xc @ wq, q_spec).reshape(
        B, S, cfg.n_heads, cfg.d_head)
    k = hints.constrain_to(xc @ wk, kv_spec).reshape(
        B, S, cfg.n_kv_heads, cfg.d_head)
    v = hints.constrain_to(xc @ wv, kv_spec).reshape(
        B, S, cfg.n_kv_heads, cfg.d_head)
    q = cm.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_frac)
    k = cm.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_frac)
    return q, k, v


def _attn_full_seq(q, k, v, cfg, attn_impl=None):
    """Self-attention over a full sequence: ``forward``'s ``attend``.

    ``attn_impl(q, k, v, causal) -> (B, S, H, D)`` gets the unrepeated KV
    heads; ``None`` runs the reference paths below."""
    B, S = q.shape[:2]
    window = cfg.window if cfg.attention == "sliding_window" else None
    if attn_impl is not None:
        if window is not None:
            raise NotImplementedError(
                "the flash attention kernel has no sliding window; use "
                "attn_impl='ref' for a sliding_window config")
        return attn_impl(q, k, v, cfg.causal)
    # the backward of repeat_kv views the repeated heads' gradient as
    # (H_kv, q_per_kv): "kv_proj" reshards it first, as it does forward
    kr = hints.constrain(cm.repeat_kv(k, cfg.q_per_kv), "kv_proj")
    vr = hints.constrain(cm.repeat_kv(v, cfg.q_per_kv), "kv_proj")
    if not cfg.causal:
        scale = 1.0 / math.sqrt(cfg.d_head)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    elif S > cfg.chunked_attn_threshold:
        out = cm.chunked_causal_attention(q, kr, vr, cfg.attn_block_kv, window)
    else:
        out = cm.naive_causal_attention(q, kr, vr, window)
    # the backward of this reshape views the gradient as heads; the hint
    # stays here, as the decode cells' "q_proj" would reshard their output
    return hints.constrain(out.reshape(B, S, cfg.n_heads * cfg.d_head),
                           "q_proj")


def _layer(x, lp, cfg, positions, compute_dtype, attend, route=None):
    """One decoder layer: (x, the MoE aux loss or None, k, v).

    ``attend(q, k, v)`` is all an entry point adds: it writes the new K/V
    (B, S, H_kv, D) where its cache keeps them and attends over what that
    cache holds, returning (B, S, H, D) or (B, S, H * D).  With latent
    attention (``cfg.mla``) ``k`` is the layer's latent rows (B, S, 1,
    latent_dim) and the third argument ``wkv_b`` (``models/mla.py``),
    which the entry point decompresses with or absorbs into its queries;
    ``v`` comes back None.  ``route`` records a routed-MoE decode step's
    routing (``routed_moe_ffn``)."""
    xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is None:
        q, k, v = _qkv(xn, lp, cfg, positions, compute_dtype)
        out = attend(q, k, v)
    else:
        q, k = latent.project(xn, lp, cfg, positions, compute_dtype)
        v = None
        out = attend(q, k, cm.maybe_dequant(lp["wkv_b"], compute_dtype))
    out = out.flatten(2)
    wo = cm.maybe_dequant(lp["wo"], compute_dtype)
    x = x + (out @ wo).to(x.dtype)
    h, aux = _ffn(x, lp, cfg, compute_dtype, route)
    return x + h, aux, k, v


def _layers(x, params, cfg, positions, compute_dtype, attend, route=None):
    """x through every layer of a cache entry point, layer i attending
    with ``attend(i, q, k, v)``."""
    tree = params.tree() if isinstance(params, TransformerParams) else params
    for i in range(cfg.n_layers):
        x = _layer(x, layer_weights(tree, cfg, i), cfg, positions,
                   compute_dtype, partial(attend, i), route)[0]
    return x


def _cache_of(cfg: TransformerConfig, ks: list, vs: list) -> dict:
    """A forward's collected cache: {"k","v"} (L, B, S, H_kv, D), or a
    latent-attention config's {"kv"} (L, B, S, 1, latent_dim)."""
    if cfg.mla is not None:
        return {"kv": torch.stack(ks)}
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _embed(params, tokens, compute_dtype):
    return cm.maybe_dequant(params["embed"], compute_dtype)[tokens]


def _head(params, x, compute_dtype):
    head = cm.maybe_dequant(params["head"], compute_dtype)
    return x.to(compute_dtype) @ head


def _logits(params, x, cfg, compute_dtype):
    """``ln_f``, then the head."""
    return _head(params, cm.rms_norm(x, params["ln_f"], cfg.norm_eps),
                 compute_dtype)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(params: TransformerParams, tokens: torch.Tensor,
            cfg: TransformerConfig, compute_dtype=torch.bfloat16,
            collect_cache: bool = False, return_hidden: bool = False,
            attn_impl=None, remat: bool = False, sp_spec=None):
    """Full-sequence forward.  tokens: (B, S) int.

    Returns (logits, aux_loss), or (logits, aux_loss, cache) with
    ``collect_cache`` -- cache {"k","v"}: (L, B, S, H_kv, D) -- or the
    final normed hidden states with ``return_hidden``.  ``attn_impl`` is
    the full-sequence attention op (module docstring).  ``remat``
    checkpoints each layer (training): its activations are recomputed in
    the backward pass, as ``jax.checkpoint`` of the layer does in JAX.
    ``sp_spec`` (a ``sharding.P``) sequence-shards the residual stream at
    each layer's entry (Megatron-SP style activation sharding) when it is
    a DTensor.  ``params`` may be a plain nested dict (the train
    state's)."""
    B, S = tokens.shape
    x = _embed(params, tokens, compute_dtype)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    attend = partial(_attn_full_seq, cfg=cfg, attn_impl=attn_impl)
    if cfg.mla is not None:
        if attn_impl is not None:
            raise NotImplementedError(
                "no full-sequence attention op computes latent attention "
                "(query-key heads of qk_head_dim, values of v_head_dim); "
                "pass attn_impl=None")
        attend = partial(latent.attend_full_seq, cfg=cfg)

    def layer_fn(x, aux, lp):
        x, a, k, v = _layer(hints.constrain_to(x, sp_spec), lp, cfg,
                            positions, compute_dtype, attend)
        return x, (aux if a is None else aux + a), k, v

    for lp in _unstacked(params, cfg):
        if remat:
            x, aux, k, v = checkpoint(layer_fn, x, aux, lp,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, aux, k, v = layer_fn(x, aux, lp)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    if return_hidden:
        return cm.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _logits(params, x, cfg, compute_dtype)
    aux = aux / cfg.n_layers
    if collect_cache:
        return logits, aux, _cache_of(cfg, ks, vs)
    return logits, aux


def prefill(params: TransformerParams, tokens: torch.Tensor,
            cfg: TransformerConfig, cache_len: int | None = None,
            compute_dtype=torch.bfloat16, attn_impl=None):
    """Prefix stage: (last-token logits (B, V), KV cache {"k","v"}:
    (L, B, max(S, cache_len), H_kv, D), zero past S)."""
    S = tokens.shape[1]
    logits, _aux, cache = forward(params, tokens, cfg, compute_dtype,
                                  collect_cache=True, attn_impl=attn_impl)
    if cache_len is not None and cache_len > S:
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, cache_len - S))
                 for k, v in cache.items()}
    return logits[:, -1], cache


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig, aux_weight: float = 0.01,
            compute_dtype=torch.bfloat16, remat: bool = False,
            sp_spec=None) -> torch.Tensor:
    """Mean next-token cross entropy plus ``aux_weight`` times the MoE
    aux loss.  The padded vocabulary's logits are masked to -1e30 in
    float32.  Attention is the plain path, as in JAX: the flash kernel
    has no backward.  ``sp_spec`` goes to ``forward``."""
    logits, aux = forward(params, tokens, cfg, compute_dtype, remat=remat,
                          sp_spec=sp_spec)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, -1e30, logits.float())
    return cm.cross_entropy_loss(logits, labels) + aux_weight * aux


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
# no drop mode and an out-of-bounds index on CUDA is a device-side assert.
# ``decode_step`` keeps its indices in bounds on the device (no host read,
# so a step can be captured in a CUDA graph); ``chunk_extend`` takes host
# ints and writes only the rows JAX keeps.

def make_cache(cfg: TransformerConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed dense cache on ``device`` (the GPU unless ``"cpu"`` is
    asked for; raises without one)."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name} keeps a latent row a token, which only the paged "
            f"pool holds (make_paged_cache; the engine's paged=True)")
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def abstract_cache(cfg: TransformerConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16) -> dict:
    """``make_cache``'s tree on the meta device."""
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


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
    cache without the merge.  The cache is updated in place, with no host
    read: row b owns its own S_max positions, so it writes at position
    ``min(pos, S_max - 1)`` its new K/V if kept and the bytes already there
    if dropped (a gather and a scatter along the sequence); no two rows
    share an index.

    ``attn_impl(q, k_cache, v_cache, cache_len) -> (B, 1, H, D)`` gets the
    layer's post-write (B, S_max, H_kv, D) caches; the default repeats KV
    heads and runs the reference masked softmax.  Returns (logits (B, V),
    cache).
    """
    B = token.shape[0]
    s_max = cache["k"].shape[2]
    h_kv, d = cfg.n_kv_heads, cfg.d_head
    x = _embed(params, token, compute_dtype)[:, None, :]          # (B, 1, d)
    pos_l = pos.long()
    keep = pos_l < s_max
    if write_mask is not None:
        keep = keep & write_mask.to(keep.device)
    at = torch.clamp(pos_l, max=s_max - 1)[:, None, None, None].expand(
        B, 1, h_kv, d)
    keep = keep[:, None, None, None]
    attn = attn_impl
    if attn is None:
        def attn(q, kc, vc, cache_len):
            return cm.decode_attention_ref(q, cm.repeat_kv(kc, cfg.q_per_kv),
                                           cm.repeat_kv(vc, cfg.q_per_kv),
                                           cache_len)
    cache_len = (pos + 1).to(torch.int32)

    def attend(i, q, k, v):
        kc, vc = cache["k"][i], cache["v"][i]          # (B, S_max, H_kv, D)
        for c, new in ((kc, k), (vc, v)):
            c.scatter_(1, at, torch.where(keep, new.to(c.dtype),
                                          c.gather(1, at)))
        # JAX attends over the cache cast to the compute dtype
        return attn(q, kc.to(compute_dtype), vc.to(compute_dtype), cache_len)

    x = _layers(x, params, cfg, pos[:, None], compute_dtype, attend)
    return _logits(params, x, cfg, compute_dtype)[:, 0], cache   # (B, V)


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
    x = _embed(params, tokens, compute_dtype)[None]               # (1, T, d)
    offs = torch.arange(T, device=dev)
    positions = (start_pos + offs)[None]                          # (1, T)
    # rows that JAX would not drop: real tokens at positions below S_max
    n_rows = max(0, min(n_valid, s_max - start_pos, T))
    mask = (torch.arange(s_max, device=dev)[None, None, None, :]
            <= positions[0][None, None, :, None])

    def attend(i, q, k, v):
        kc, vc = cache["k"][i], cache["v"][i]          # (B, S_max, H_kv, D)
        kc[slot, start_pos:start_pos + n_rows] = k[0, :n_rows].to(kc.dtype)
        vc[slot, start_pos:start_pos + n_rows] = v[0, :n_rows].to(vc.dtype)
        return cm.chunk_attention(q, kc[slot][None], vc[slot][None], mask,
                                  compute_dtype)

    _layers(x, params, cfg, positions, compute_dtype, attend)
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache entry points
# ---------------------------------------------------------------------------
#
# Physical layout: {"k","v"}: (L, n_pages, page, H_kv, D), or with latent
# attention one latent row a token, {"kv"}: (L, n_pages, page, 1,
# latent_dim).  Position p of sequence b lives at physical row
# block_tables[b, p // page] * page + p % page.  JAX drops out-of-bounds
# scatter rows (mode="drop"); PyTorch has
# no drop mode and an out-of-bounds index on CUDA is a device-side assert.
# ``paged_decode_step`` keeps its indices in bounds on the device (no host
# read); the paged chunk extends take host ints and write only the rows JAX
# keeps.

def make_paged_cache(cfg: TransformerConfig, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed page pool on ``device`` (the GPU unless ``"cpu"`` is asked
    for; raises without one): K and V, or a latent-attention config's
    latent rows."""
    device = resolve_device(device)
    if cfg.mla is not None:
        shape = (cfg.n_layers, n_pages, page_size, 1, cfg.mla.latent_dim)
        return {"kv": torch.zeros(shape, dtype=dtype, device=device)}
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pool_layer(cache: dict, i: int, k, v) -> tuple:
    """Layer ``i``'s (pool tensor, new rows) pairs: K and V, or the
    latent rows alone."""
    if "kv" in cache:
        return ((cache["kv"][i], k),)
    return ((cache["k"][i], k), (cache["v"][i], v))


def paged_decode_step(params: TransformerParams, cache: dict,
                      token: torch.Tensor, pos: torch.Tensor,
                      block_tables: torch.Tensor, cfg: TransformerConfig,
                      compute_dtype=torch.bfloat16, attn_impl=None,
                      write_mask: torch.Tensor | None = None,
                      stats: torch.Tensor | None = None):
    """One autoregressive step against a PAGED KV cache.

    cache: {"k","v"}: (L, P, page, H_kv, D).  token/pos: (B,) int32.
    block_tables: (B, M) int32.  The new token's K/V goes to physical row
    ``block_tables[b, pos//page]*page + pos%page``; rows with
    ``write_mask`` False, or whose position lies past the table, are not
    written (JAX drops them out of bounds).  The pool is updated in place,
    with no host read and no spare row: a dropped row repeats the write of
    the first kept row (same index, same bytes, so the duplicate index is
    deterministic), and when no row is kept every row writes back the
    bytes at row 0's target.  A dropped row's own clamped target may lie
    in a live sequence's page (an idle slot's table is zeros), which is
    why it is not used.

    ``attn_impl(q, k_pages, v_pages, block_tables, cache_len)`` is
    block-table-native: it gets the post-scatter pool (P, page, H_kv, D)
    of the layer and the tables.  Returns (logits (B, V), cache).

    With latent attention (``cfg.mla``) the pool holds one latent row a
    token ({"kv"}), and the step runs the absorbed form: ``W_UK`` folded
    into the queries, ``attn_impl(q, kv_pages, block_tables, cache_len,
    scale, d_latent)`` (default ``mla.paged_latent_attention``) over the
    layer's latent pages (P, page, 1, latent_dim), ``W_UV`` after; the
    cache is never decompressed.  ``stats`` (2,) float32, for a
    routed-MoE config, is zeroed and then summed into by every routed
    layer over the rows kept (``RouteStats``), on the device.
    """
    B = token.shape[0]
    _, P, page = next(iter(cache.values())).shape[:3]
    M = block_tables.shape[1]
    x = _embed(params, token, compute_dtype)[:, None, :]          # (B, 1, d)
    pos_l = pos.long()
    page_log = pos_l // page
    phys = torch.gather(block_tables.long(), 1,
                        torch.clamp(page_log, max=M - 1)[:, None])[:, 0]
    flat = phys * page + pos_l % page
    keep = page_log < M
    if write_mask is not None:
        keep = keep & write_mask.to(keep.device)
    # each row's source row: itself if kept, else the first kept row (row
    # 0 when none is); ``keep`` becomes "some row is kept", for every row
    route = None
    if stats is not None:
        route = RouteStats(keep, stats.zero_())
    src = torch.where(keep, torch.arange(B, device=keep.device),
                      torch.argmax(keep.to(torch.uint8)))
    flat, keep = flat[src], keep[src][:, None, None]
    attn = attn_impl
    mla = cfg.mla
    if attn is None and mla is not None:
        attn = latent.paged_latent_attention
    elif attn is None:
        def attn(q, kp, vp, tables, cache_len):
            return engine_ref_attn(q, kp, vp, tables, cache_len,
                                   cfg.q_per_kv)
    cache_len = (pos + 1).to(torch.int32)

    def attend(i, q, k, v):
        pairs = _pool_layer(cache, i, k, v)  # (P, page, H_kv, D) each
        for c, new in pairs:
            f = c.view(P * page, *c.shape[2:])
            f.index_copy_(0, flat, torch.where(keep, new[src, 0].to(f.dtype),
                                               f[flat]))
        # JAX attends over the pool cast to the compute dtype
        if mla is not None:
            o = attn(latent.absorb(q, v, cfg),
                     pairs[0][0].to(compute_dtype), block_tables, cache_len,
                     mla.scale, mla.kv_lora_rank)
            return latent.unabsorb(o, v, cfg)
        (kc, _), (vc, _) = pairs
        return attn(q, kc.to(compute_dtype), vc.to(compute_dtype),
                    block_tables, cache_len)

    x = _layers(x, params, cfg, pos[:, None], compute_dtype, attend, route)
    return _logits(params, x, cfg, compute_dtype)[:, 0], cache   # (B, V)


def paged_chunk_extend(params: TransformerParams, cache: dict,
                       block_row: torch.Tensor, tokens: torch.Tensor,
                       start_pos: int, n_valid: int, cfg: TransformerConfig,
                       compute_dtype=torch.bfloat16, attn_impl=None):
    """Extend ONE sequence's paged cache with a chunk of tokens: the
    one-row call of :func:`paged_chunk_extend_batch` (``attn_impl`` is
    its chunk op).

    block_row: (M,) int32, the sequence's page table row.  tokens: (T,)
    padded; only the first ``n_valid`` are real.  Returns (cache, logits
    of the last valid row (V,)); the pool is updated in place.
    """
    cache, logits = paged_chunk_extend_batch(
        params, cache, block_row[None], tokens[None], [start_pos],
        [n_valid], cfg, compute_dtype, attn_impl=attn_impl)
    return cache, logits[0]


#: f32 attention scores one group of a paged chunk extend's rows may hold
#: on the plain path (2 GiB: 8 rows of 512 tokens over 4,096 positions at
#: 32 heads); larger batches attend a group of rows at a time, so the
#: scores, their masked copy and the softmax stay a few GiB whatever the
#: batch.  A chunk op (``attn_impl``) makes no scores and no groups.
_ATTN_SCORES_BYTES = 1 << 31


def paged_chunk_extend_batch(params: TransformerParams, cache: dict,
                             block_rows: torch.Tensor, tokens: torch.Tensor,
                             start_pos, n_valid, cfg: TransformerConfig,
                             compute_dtype=torch.bfloat16, attn_impl=None):
    """Extend B sequences' paged caches with a chunk each, in one forward.

    block_rows: (B, M) int32, each sequence's page table row.  tokens:
    (B, T) padded; ``start_pos`` and ``n_valid`` are B host ints, and only
    row b's first ``n_valid[b]`` tokens are real.  Row b's token i is
    written at position ``start_pos[b] + i`` (pad rows and positions past
    the table are not written) and attends over row b's gathered logical
    view under its own causal mask, so row b's result is the one-row
    call's, and matches feeding its tokens one decode step at a time.
    The embedding, norms, RoPE, projections and FFN run once over the
    B x T tokens (an MoE FFN dispatches each row's tokens to its own
    capacity, as B one-row calls do), and the writes are one
    ``index_copy_`` per K and V a layer over the rows' kept tokens; the
    positions and write targets are built on the device, with no copy
    from the host.  ``attn_impl(q, k_pages, v_pages, block_rows, starts)``
    is block-table-native: it gets the layer's post-write pool
    (P, page, H_kv, D) in the compute dtype, the block rows and each row's
    start position (B,) int32, made on the device.  Without it the
    kernel's plain version runs over groups of rows whose f32 scores fit
    ``_ATTN_SCORES_BYTES``, each group gathering its rows' tables only up
    to the page of its last position.  The rows' write ranges must lie in
    pages no other row reads (the paged pool's ``prepare_append`` makes
    them so).
    Returns (cache, logits of each row's last valid token (B, V)); the
    pool is updated in place.

    With latent attention (``cfg.mla``) the rows' latent rows are written
    and the chunk attends in the absorbed form, as ``paged_decode_step``
    does: ``attn_impl(q, kv_pages, block_rows, starts, scale, d_latent)``,
    without it ``mla.chunk_latent_attention`` over the same groups.
    """
    _, P, page = next(iter(cache.values())).shape[:3]
    B, M = block_rows.shape
    S = M * page
    T = tokens.shape[1]
    mla = cfg.mla
    starts = [int(s) for s in start_pos]
    valid = [int(n) for n in n_valid]
    dev = tokens.device
    x = _embed(params, tokens, compute_dtype)                     # (B, T, d)
    offs = torch.arange(T, device=dev)
    positions = torch.stack([s + offs for s in starts])           # (B, T)
    # rows that JAX would not drop: real tokens whose position is in the
    # table, as indices into the B x T tokens
    kept = [max(0, min(n, S - s, T)) for s, n in zip(starts, valid)]
    sel = torch.cat([b * T + offs[:n] for b, n in enumerate(kept)])
    wpos = positions.reshape(-1)[sel]
    flat = block_rows.long()[sel // T, wpos // page] * page + wpos % page
    first = positions[:, 0].to(torch.int32)                       # (B,)
    # the plain path: groups of rows, each reading its tables only up to
    # the page of the group's last position
    step = max(1, _ATTN_SCORES_BYTES // (cfg.n_heads * T * S * 4))
    groups = [(a, min(a + step, B)) for a in range(0, B, step)]

    def attend(i, q, k, v):
        pairs = _pool_layer(cache, i, k, v)
        for c, new in pairs:
            f = c.view(P * page, *c.shape[2:])
            f.index_copy_(0, flat, new.reshape(B * T, *c.shape[2:])
                          .index_select(0, sel).to(f.dtype))
        if mla is not None:
            return latent.unabsorb(
                latent_chunk(latent.absorb(q, v, cfg), pairs[0][0]), v, cfg)
        (kc, _), (vc, _) = pairs
        if attn_impl is not None:
            return attn_impl(q, kc.to(compute_dtype), vc.to(compute_dtype),
                             block_rows, first)
        outs = [paged_chunk_attention_ref(
            q[a:b], kc, vc,
            tables_upto(block_rows[a:b], max(starts[a:b]) + T, page),
            first[a:b]) for a, b in groups]
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def latent_chunk(qa, kvp):
        kvp = kvp.to(compute_dtype)
        if attn_impl is not None:
            return attn_impl(qa, kvp, block_rows, first, mla.scale,
                             mla.kv_lora_rank)
        outs = [latent.chunk_latent_attention(
            qa[a:b], kvp,
            tables_upto(block_rows[a:b], max(starts[a:b]) + T, page),
            first[a:b], mla.scale, mla.kv_lora_rank) for a, b in groups]
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    x = _layers(x, params, cfg, positions, compute_dtype, attend)
    xf = cm.rms_norm(x, params["ln_f"], cfg.norm_eps)
    last = torch.stack([xf[b, max(n - 1, 0)] for b, n in enumerate(valid)])
    return cache, _head(params, last, compute_dtype)             # (B, V)
