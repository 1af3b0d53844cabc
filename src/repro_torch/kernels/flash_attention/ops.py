"""Model-facing wrapper of the flash attention kernel.

Same function as ``repro.kernels.flash_attention.ops.flash_attention``:
full-sequence attention, causal or not, in the model's (B, S, H, D)
layout with grouped KV heads.  Unlike the JAX wrapper it neither repeats
the KV heads nor pads S to a tile multiple: the kernel maps each query
head to its KV head and masks the ragged last tile itself.  ``kv_len``
masks keys at and past it, as the Pallas kernel's ``kv_len`` does.

A CUDA tensor launches ``csrc/flash_attention.cu`` (or the wrapper raises
on a dtype, shape, layout or alignment the kernel does not take); a CPU
tensor goes to the plain version, ``ref.flash_attention_ref``.
``flash_attention.launches`` counts kernel launches.

The kernel is forward only: it writes its output through a raw pointer,
so autograd would see a constant.  The wrapper therefore raises when grad
mode is on and q, k or v requires grad; training runs the plain attention
(``attn_impl=None``), as the JAX package trains through its einsums.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128)      # head widths the kernel is built for
MAX_GRID_Y = 65535                 # B * H blocks on the grid's y axis


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel.  q: (B, S, H, D); k, v: (B, S, H_kv, D) ->
    (B, S, H, D)."""
    b, s, h, d = q.shape
    tensors = (q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention has no backward: its output would carry no "
            "gradient to q, k or v.  Differentiate through the plain "
            "attention (attn_impl=None), or call the kernel under "
            "torch.no_grad()")
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: all inputs must be on one CUDA "
                         "device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (b, s)
            or k.shape[3] != d or k.shape[2] == 0 or h % k.shape[2]):
        raise ValueError(f"flash_attention: shapes do not match: q "
                         f"{tuple(q.shape)}, k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * H = {b * h} blocks exceed "
                         f"the grid's {MAX_GRID_Y}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention needs contiguous inputs")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention moves rows by TMA and in "
                             f"16-byte loads and stores: {name} must be "
                             f"16-byte aligned")
    fn = _build.function(_ENTRY[q.dtype], 4, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, k.shape[2], d, int(causal),
             s if kv_len is None else int(kv_len),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_ENTRY[q.dtype], err)
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    kv_len: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, H_kv, D) -> (B, S, H, D) in q's
    dtype: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, kv_len)
    return flash_attention_ref(q, k, v, causal, kv_len)


flash_attention.launches = 0
