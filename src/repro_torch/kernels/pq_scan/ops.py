"""Wrapper of the PQ ADC scan kernel.

A CUDA tensor launches ``csrc/pq_scan.cu`` (or the wrapper raises on a
dtype, shape or layout the kernel does not take); a CPU tensor goes to
the plain version, ``ref.pq_scan_ref``.  ``pq_scan.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_scan.ref import pq_scan_ref

MAX_ROWS = 65535                   # gridDim.y limit: one grid row per b


def pq_scan_cuda(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  lut: (B, S, 256) float32; codes: (B, N, S)
    uint8 -> (B, N) float32."""
    if lut.dim() != 3 or codes.dim() != 3 or lut.shape[2] != 256 \
            or codes.shape[0] != lut.shape[0] \
            or codes.shape[2] != lut.shape[1]:
        raise ValueError(f"pq_scan: lut (B, S, 256) and codes (B, N, S) "
                         f"expected, got {tuple(lut.shape)} and "
                         f"{tuple(codes.shape)}")
    if lut.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"pq_scan takes a float32 lut and uint8 codes, got "
                        f"{lut.dtype} and {codes.dtype}")
    if not lut.is_cuda or codes.device != lut.device:
        raise ValueError("pq_scan: lut and codes must be on one CUDA device")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("pq_scan needs contiguous inputs")
    b, n, s = codes.shape
    if b > MAX_ROWS:
        raise ValueError(f"pq_scan: {b} rows exceed the grid limit {MAX_ROWS}")
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    fn = _build.function("pq_scan_f32", 3, 3)
    err = fn(lut.data_ptr(), codes.data_ptr(), out.data_ptr(), b, n, s,
             torch.cuda.current_stream(lut.device).cuda_stream)
    _build.check("pq_scan_f32", err)
    pq_scan.launches += 1
    return out


def pq_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut: (B, S, 256); codes: (B, N, S) uint8 -> distances (B, N) f32."""
    if lut.is_cuda:
        return pq_scan_cuda(lut, codes)
    return pq_scan_ref(lut, codes)


pq_scan.launches = 0
