"""Wrappers of the PQ ADC scan kernel (``csrc/pq_scan.cu``).

One kernel, two entry points:

* ``pq_scan(lut, codes)`` -- the TPU kernel's signature: row b scans
  ``codes[b]``;
* ``pq_scan_lists(lut, list_codes, rows)`` -- row b scans
  ``list_codes[rows[b]]`` where it lies, so an IVF search never copies its
  probed lists.

A CUDA tensor launches the kernel, or the wrapper raises on a dtype,
shape, layout or device the kernel does not take; a CPU tensor goes to the
plain version (``ref.py``).  The wrappers never read device memory, so
they never make the host wait: a row index outside [0, L) is the kernel's
to catch, and gives that row NaN distances.  ``pq_scan.launches`` counts
the kernel's launches through either entry point.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_scan.ref import pq_scan_lists_ref, pq_scan_ref

TILE = 256               # code rows a tile, one a thread (kTile)
MAX_SUBQ = 128           # sub-quantizers a staged table holds (kMaxSubq)
FILL_BLOCKS = 132        # the H100's SMs


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_plan(b: int, n: int, s: int) -> tuple[int, int, int]:
    """(n_split, chunk, s_chunk) for B rows of N codes of S bytes.

    Split i of a row scans codes [i*chunk, min((i+1)*chunk, N)); a chunk
    is a whole number of tiles.  The rows are split until B * n_split
    reaches FILL_BLOCKS or a split is one tile, so a few rows of long
    lists (one query) still spread over the SMs, while many rows (a
    batch) keep whole rows a block, each staging its row's (S, 256) table
    once for all its tiles (``pq_scan_bench.py`` times other splits).  No split starts at or past N, so the splits cover
    [0, N) once, in order.  A block stages the table of s_chunk
    sub-quantizers at a time and walks S in chunks of s_chunk, in order.
    From the shapes alone, like the decode kernels' plans."""
    n_tiles = max(1, cdiv(n, TILE))
    want = max(1, min(n_tiles, cdiv(FILL_BLOCKS, max(b, 1))))
    tiles = cdiv(n_tiles, want)
    return cdiv(n_tiles, tiles), tiles * TILE, min(s, MAX_SUBQ)


def _launch(lut: torch.Tensor, codes: torch.Tensor,
            rows: torch.Tensor | None) -> torch.Tensor:
    """lut (B, S, 256) f32; codes (L, LL, S) u8; rows (B,) i32, or None
    for row b = list b -> (B, LL) f32."""
    if lut.dim() != 3 or lut.shape[2] != 256 or codes.dim() != 3 \
            or codes.shape[2] != lut.shape[1] or lut.shape[1] == 0:
        raise ValueError(f"pq_scan: lut (B, S, 256) and codes (L, N, S) with "
                         f"S >= 1 expected, got {tuple(lut.shape)} and "
                         f"{tuple(codes.shape)}")
    if lut.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"pq_scan takes a float32 lut and uint8 codes, got "
                        f"{lut.dtype} and {codes.dtype}")
    if not lut.is_cuda or codes.device != lut.device:
        raise ValueError("pq_scan: lut and codes must be on one CUDA device")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("pq_scan needs contiguous inputs")
    if lut.data_ptr() % 16:
        raise ValueError("pq_scan: the lut must start on 16 bytes")
    b, s = lut.shape[:2]
    n_lists, n, _ = codes.shape
    if rows is not None:
        if rows.shape != (b,):
            raise ValueError(f"pq_scan_lists: rows of shape ({b},) expected, "
                             f"got {tuple(rows.shape)}")
        if rows.dtype != torch.int32:
            raise TypeError(f"pq_scan_lists takes int32 rows, got "
                            f"{rows.dtype}")
        if rows.device != lut.device:
            raise ValueError("pq_scan_lists: rows must be on the lut's "
                             "device")
        rows = rows.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    n_split, chunk, _ = scan_plan(b, n, s)
    if b * n_split >= 2 ** 31:
        raise ValueError(f"pq_scan: {b} rows x {n_split} splits exceed the "
                         f"grid")
    fn = _build.function("pq_scan_lists_f32", 4, 6)
    err = fn(lut.data_ptr(), codes.data_ptr(),
             None if rows is None else rows.data_ptr(),
             out.data_ptr(), b, n_lists, n, s, n_split, chunk,
             torch.cuda.current_stream(lut.device).cuda_stream)
    _build.check("pq_scan_lists_f32", err)
    pq_scan.launches += 1
    return out


def pq_scan_cuda(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  lut: (B, S, 256) float32; codes: (B, N, S)
    uint8 -> (B, N) float32."""
    if codes.dim() == 3 and codes.shape[0] != lut.shape[0]:
        raise ValueError(f"pq_scan: codes (B, N, S) for lut (B, S, 256) "
                         f"expected, got {tuple(codes.shape)} and "
                         f"{tuple(lut.shape)}")
    return _launch(lut, codes, None)


def pq_scan_lists_cuda(lut: torch.Tensor, list_codes: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  lut: (B, S, 256) float32; list_codes: (L, LL,
    S) uint8; rows: (B,) int32 -> (B, LL) float32."""
    return _launch(lut, list_codes, rows)


def pq_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut: (B, S, 256); codes: (B, N, S) uint8 -> distances (B, N) f32."""
    if lut.is_cuda:
        return pq_scan_cuda(lut, codes)
    return pq_scan_ref(lut, codes)


def pq_scan_lists(lut: torch.Tensor, list_codes: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """lut: (B, S, 256); list_codes: (L, LL, S) uint8; rows: (B,) int32
    -> distances (B, LL) f32, row b over list rows[b]."""
    if lut.is_cuda:
        return pq_scan_lists_cuda(lut, list_codes, rows)
    return pq_scan_lists_ref(lut, list_codes, rows)


pq_scan.launches = 0
