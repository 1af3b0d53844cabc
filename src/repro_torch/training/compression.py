"""Gradient compression for cross-pod all-reduce.

The counterpart of ``repro.training.compression``: int8 per-tensor-scaled
compression cuts gradient bytes 4x (paper-adjacent distributed-optimization
trick; cf. 1-bit Adam / PowerSGD literature), and ``compress/decompress``
round-trips are tested for bounded error.  The compressed all-reduce runs
on ``torch.distributed`` collectives over a process group, where the JAX
package reduces over a named mesh axis (``pmax``/``psum``).

Error feedback (residual carrying) keeps the quantization bias from
accumulating across steps.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.pytree import leaves, tree_map, unflatten


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale)."""
    amax = torch.max(torch.abs(g))
    scale = (amax / 127.0 + 1e-12).float()
    # JAX promotes a bf16 g over the f32 scale; torch would not
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of ``group`` with an int8 payload: quantize ->
    all-reduce the int32 sum -> rescale.

    Uses a shared max-scale (all-reduce MAX of per-rank amax) so the int8
    payloads are commensurable; the wire cost is 1 byte/grad + one scalar
    (the sum travels as int32 here: ``torch.distributed`` sums in the
    tensor's own type).
    """
    amax = torch.max(torch.abs(g))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.ones((), dtype=torch.float32, device=g.device)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale / n


def with_error_feedback(grads, residual):
    """Add carried residual, compress, and return (decompressed, residual').

    residual' = (g + r) - decompress(compress(g + r)).
    """
    def one(g, r):
        gr = g.float() + r
        q, s = compress_int8(gr)
        deq = decompress_int8(q, s)
        return deq, gr - deq

    out = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
