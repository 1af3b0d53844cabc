"""Operations and bytes of the work a cell asks for, and the chip's peaks.

Counts come from a configuration's sizes and each request's own lengths
(real prompt tokens, not the padded bucket), so they read the same work
whatever implements it: padding and waste lower the shares built on them.

* Model FLOPs (``mfu.*``): 2 x the matmul weights a token passes through,
  plus attention's 4 x ctx x H x D a token and layer (causal: ctx is the
  token's position + 1).  A decode token passes through the output head;
  of a prefill only the last token's logits are needed, so the head is
  counted once a prefill.  The embedding gather is no matmul.
* A kernel's bound: the larger of its bytes over the HBM bandwidth and its
  operations over the bf16 tensor peak, each input byte read once and each
  output byte written once.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Dims:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    elem_bytes: int = 2            # bf16 activations and KV

    @classmethod
    def from_model(cls, m: dict) -> "Dims":
        """From a configuration's ``model`` group (published key names)."""
        return cls(m["num_hidden_layers"], m["hidden_size"],
                   m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"], m["intermediate_size"], m["vocab_size"])

    @property
    def layer_weights(self) -> int:
        """Matmul weights of one layer: Q, K, V, O and a SwiGLU FFN."""
        d, h, kv, hd, f = (self.d_model, self.heads, self.kv_heads,
                           self.head_dim, self.d_ff)
        return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f

    @property
    def head_weights(self) -> int:
        return self.d_model * self.vocab

    @property
    def kv_bytes_per_token_layer(self) -> int:
        return 2 * self.kv_heads * self.head_dim * self.elem_bytes


def prefill_flops(dm: Dims, n: int) -> float:
    """One prefill of ``n`` real prompt tokens."""
    attn = 4 * dm.heads * dm.head_dim * dm.layers * n * (n + 1) / 2
    return 2.0 * dm.layers * dm.layer_weights * n + 2.0 * dm.head_weights \
        + attn


def decode_flops(dm: Dims, ctxs) -> float:
    """One decode step of the rows whose contexts (cache lengths after
    the step's write) are ``ctxs``."""
    rows = len(ctxs)
    attn = 4.0 * dm.heads * dm.head_dim * dm.layers * float(sum(ctxs))
    return 2.0 * (dm.layers * dm.layer_weights + dm.head_weights) * rows \
        + attn


def _bound(bytes_, flops) -> float:
    return max(bytes_ / HBM_BYTES_S, flops / BF16_FLOPS)


def paged_decode_bound_s(dm: Dims, ctxs) -> float:
    """Least time of the paged decode attention over every layer of one
    step: each stepping row's live K/V read once, q read and out written."""
    rows, ctx = len(ctxs), float(sum(ctxs))
    per_layer = _bound(
        ctx * dm.kv_bytes_per_token_layer
        + 2 * rows * dm.heads * dm.head_dim * dm.elem_bytes,
        4 * dm.heads * dm.head_dim * ctx)
    return dm.layers * per_layer


def flash_prefill_bound_s(dm: Dims, n: int) -> float:
    """Least time of causal flash attention over every layer of one
    prefill of ``n`` real tokens: q, k, v read once, out written once."""
    per_layer = _bound(
        (2 * n * dm.heads + 2 * n * dm.kv_heads) * dm.head_dim
        * dm.elem_bytes,
        4 * dm.heads * dm.head_dim * n * (n + 1) / 2)
    return dm.layers * per_layer
