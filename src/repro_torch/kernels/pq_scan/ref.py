"""Plain PyTorch versions of the PQ ADC scan (mirror of
``repro.kernels.pq_scan.ref`` and ``repro.retrieval.ivf_pq.pq_scan_ref``).

The sum over sub-quantizers runs in order, s = 0..S-1 from zero, as the
TPU kernel's loop and the CUDA kernel do, so kernel and plain version
agree to the bit in float32."""

from __future__ import annotations

import torch


def pq_scan_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut: (..., S, 256); codes: (..., N, S) uint8 -> (..., N) float32."""
    lut = lut.float()
    codes = codes.long()
    acc = torch.zeros(codes.shape[:-1], dtype=torch.float32,
                      device=lut.device)
    for s in range(lut.shape[-2]):
        acc = acc + torch.gather(lut[..., s, :], -1, codes[..., s])
    return acc


def pq_scan_lists_ref(lut: torch.Tensor, list_codes: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """lut: (B, S, 256); list_codes: (L, LL, S) uint8; rows: (B,) ->
    (B, LL) float32: row b scans list rows[b] (``pq_scan_ref`` of the
    gathered lists)."""
    return pq_scan_ref(lut, list_codes[rows.long()])
