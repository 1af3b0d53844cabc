"""Distributed split-K decode attention over the ``model`` axis
(counterpart of ``repro.distributed.decode_attn``).

The KV cache is sequence-sharded across ``model`` (flash-decoding across
devices): each rank computes attention of the full query head set against
its local KV chunk, then the partial (out, logsumexp) pairs are combined
with a numerically stable renormalisation -- one max- and one
sum-reduction of the (B, H) statistics plus one sum of the (B, H, D)
partial outputs, collective bytes independent of S.

Where JAX's ``shard_map`` hands each device its block and reduces with
``pmax``/``psum``, here each rank calls the returned function on its own
local shards and the combine is ``all_reduce`` (MAX, then SUM) over the
mesh's ``model`` process group.  A size-1 axis (the 1 x 1 host mesh)
skips the collectives.  The local partial is the dense decode kernel's
partial entry on a CUDA tensor and its plain version on a CPU tensor
(``kernels/decode_attention/ops.decode_attention_partial``); nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention_partial
from repro_torch.kernels.decode_attention.ref import local_decode_attn_ref
from repro_torch.launch.mesh import axes_group

#: the plain partial, ``_local_decode_attn`` step for step
_local_decode_attn = local_decode_attn_ref


def make_distributed_decode_attn(mesh, q_per_kv: int,
                                 seq_axis: str = "model",
                                 quantized: bool = False):
    """Returns attn_impl(q, k_cache, v_cache, [k_scale, v_scale,]
    cache_len) -> (B, 1, H, D), called by every rank on its shards.

    Cache layout: (B, S, H_kv, D) with S sharded over ``seq_axis`` (a
    rank's shard holds positions [rank * S_loc, (rank + 1) * S_loc)) and B
    over the data axes; q and cache_len are the rank's batch rows, whole
    over ``seq_axis``.  With ``quantized`` the caches are int8 with
    per-(B, S, H_kv) scales, dequantized inside the shard."""
    # q_per_kv is kept for the reference's signature: the partial reads
    # it from the heads of q and of the cache
    rank, group = axes_group(mesh, seq_axis)

    def combine(q, kc, vc, cache_len):
        s_loc = kc.shape[1]
        out, m, l = decode_attention_partial(q, kc, vc, cache_len,
                                             rank * s_loc)
        m_g = m
        if group is not None:
            m_g = m.clone()
            torch.distributed.all_reduce(m_g, torch.distributed.ReduceOp.MAX,
                                         group=group)
        m_g_safe = torch.where(torch.isfinite(m_g), m_g, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_g_safe), 0.0)
        l_g = l * corr
        out_g = out * corr[..., None]
        if group is not None:
            torch.distributed.all_reduce(l_g, group=group)
            torch.distributed.all_reduce(out_g, group=group)
        out_g = out_g / torch.clamp(l_g, min=1e-30)[..., None]
        return out_g[:, None]                                # (B, 1, H, D)

    if not quantized:
        def body(q, kc, vc, cache_len):
            return combine(q, kc, vc, cache_len).to(vc.dtype)
        return body

    def body_q(q, kc, vc, ks, vs, cache_len):
        k = kc.to(q.dtype) * ks[..., None].to(q.dtype)
        v = vc.to(q.dtype) * vs[..., None].to(q.dtype)
        return combine(q, k, v, cache_len).to(q.dtype)
    return body_q


def reference_decode_attn(q, kc, vc, cache_len, q_per_kv: int):
    """Single-device oracle with identical semantics."""
    out, m, l = _local_decode_attn(q, kc, vc, cache_len, 0, q_per_kv)
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out[:, None].to(vc.dtype)
