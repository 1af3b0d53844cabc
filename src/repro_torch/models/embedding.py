"""EmbeddingBag and stacked embedding-table substrate (mirror of
``repro.models.embedding``).

Multi-field recsys tables are stacked into one flat (sum_of_vocabs, dim)
tensor, so a batch of lookups across all fields is a single gather.  Bags
are a gather and a segment reduction (``index_add`` / ``scatter_reduce``),
as the reference builds them from ``jnp.take`` and ``jax.ops.segment_*``
-- not ``nn.EmbeddingBag``, whose layout and out-of-range rules differ.

The reference's index rules are kept, without a read back to the host:

* ``take`` (``jnp.take(x, ids, axis=0)``): an id ``>= V`` (or ``< -V``)
  gives a row of NaN; a negative id wraps (-1 is row V-1).  A bare
  ``index_select`` would raise on the CPU and trip a device assert on the
  GPU, so ids are wrapped, clamped, gathered, and the out-of-range rows
  replaced by NaN with ``torch.where``.
* ``segment_sum`` / ``segment_max`` / ``segment_min``: an out-of-range
  segment id (negative or ``>= num_segments``) is dropped; an empty
  segment is 0 under the sum, ``-inf`` under the max and ``+inf`` under
  the min.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.common import trunc_normal


# ---------------------------------------------------------------------------
# jnp.take and jax.ops.segment_* with the reference's index rules
# ---------------------------------------------------------------------------

def take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (V, ...) at integer ``ids`` (any shape) ->
    ids.shape + x.shape[1:], as ``jnp.take(x, ids, axis=0)``: a negative
    id wraps once, an id out of [-V, V) gives a NaN row."""
    v = x.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    rows = x.index_select(0, ids.clamp(0, max(v - 1, 0)).reshape(-1))
    rows = rows.reshape(ids.shape + x.shape[1:])
    mask = valid.reshape(valid.shape + (1,) * (x.dim() - 1))
    return torch.where(mask, rows, torch.full((), math.nan, dtype=x.dtype,
                                              device=x.device))


def _segments(data: torch.Tensor, segment_ids: torch.Tensor,
              num_segments: int, fill: float):
    """(clamped long ids, ``data`` with the rows of out-of-range ids set
    to ``fill``, which leaves their clamped segment as it is)."""
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    keep = keep.reshape(keep.shape + (1,) * (data.dim() - 1))
    clamped = seg.clamp(0, max(num_segments - 1, 0))
    filled = torch.where(keep, data, torch.full((), fill, dtype=data.dtype,
                                                device=data.device))
    return clamped, filled


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (N, ...) -> (num_segments, ...)."""
    seg, data = _segments(data, segment_ids, num_segments, 0.0)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, seg, data)


def _segment_extreme(data, segment_ids, num_segments, reduce: str,
                     fill: float) -> torch.Tensor:
    seg, data = _segments(data, segment_ids, num_segments, fill)
    out = torch.full((num_segments,) + data.shape[1:], fill,
                     dtype=data.dtype, device=data.device)
    index = seg.reshape(seg.shape + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, reduce=reduce,
                              include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment is ``-inf``."""
    return _segment_extreme(data, segment_ids, num_segments, "amax",
                            -math.inf)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min``: an empty segment is ``+inf``."""
    return _segment_extreme(data, segment_ids, num_segments, "amin",
                            math.inf)


# ---------------------------------------------------------------------------
# tables and bags
# ---------------------------------------------------------------------------

def init_device(generator: torch.Generator, device) -> torch.device:
    """``device``, or the generator's when it is None."""
    return torch.device(device if device is not None else generator.device)


def init_table(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """(vocab, dim) standard normal over sqrt(dim), drawn from
    ``generator`` on ``device`` (default: the generator's)."""
    device = init_device(generator, device)
    t = torch.randn((vocab, dim), generator=generator, device=device,
                    dtype=torch.float32)
    return (t / math.sqrt(dim)).to(dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int,
                  mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """table: (V, D); ids/segment_ids: (N,).  Returns (num_segments, D).
    An empty bag is 0 under "sum" and "mean" and ``-inf`` under "max"."""
    rows = take(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, segment_ids, num_segments)
    if mode == "mean":
        s = segment_sum(rows, segment_ids, num_segments)
        cnt = segment_sum(torch.ones(segment_ids.shape, dtype=torch.float32,
                                     device=segment_ids.device),
                          segment_ids, num_segments)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        return segment_max(rows, segment_ids, num_segments)
    raise ValueError(mode)


class StackedTables:
    """Layout helper: n_fields tables flattened into one (sum_V, D) tensor."""

    def __init__(self, vocab_sizes: tuple[int, ...], dim: int,
                 pad_rows_to: int = 512):
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.dim = dim
        self.offsets = np.concatenate([[0], np.cumsum(self.vocab_sizes)])
        # pad total rows so tables row-shard over any power-of-two mesh
        raw = int(self.offsets[-1])
        self.total_rows = -(-raw // pad_rows_to) * pad_rows_to

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> torch.Tensor:
        return init_table(generator, self.total_rows, self.dim, dtype,
                          device)

    def lookup(self, table: torch.Tensor,
               field_ids: torch.Tensor) -> torch.Tensor:
        """field_ids: (B, n_fields) per-field local ids -> (B, n_fields, D).
        A local id past its field's vocabulary reads the next field's rows,
        one past the table gives NaN (``take``), as in the reference."""
        off = torch.as_tensor(self.offsets[:-1], dtype=field_ids.dtype,
                              device=field_ids.device)
        return take(table, field_ids + off[None, :])


def mlp_init(generator: torch.Generator, dims: tuple[int, ...],
             dtype=torch.float32, device=None) -> list:
    """A list of ``{"w": (a, b), "b": (b,)}`` layers: ``w`` a normal
    truncated to [-3, 3] over sqrt(a), ``b`` zeros."""
    device = torch.device(device if device is not None else generator.device)
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = trunc_normal((a, b), generator, device) / math.sqrt(a)
        layers.append({"w": w.to(dtype),
                       "b": torch.zeros((b,), dtype=dtype, device=device)})
    return layers


def mlp_apply(layers: list, x: torch.Tensor,
              final_act: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x
