"""Pluggable retrieval backends for the serving engine (mirror of
``repro.retrieval.backend``).

A backend takes encoded query vectors and returns (scores, ids) as host
numpy arrays, HIGHER score better for every backend (exact kNN returns
similarities, IVF-PQ negated ADC distances).

``IVFPQBackend`` builds an :class:`~repro_torch.retrieval.ivf_pq.IVFPQIndex`
at construction -- or takes a pre-built one through
:meth:`IVFPQBackend.from_index` -- and routes the ADC scan through the CUDA
``pq_scan`` kernel on a CUDA device (``use_kernel=None``).
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.retrieval.exact import knn
from repro_torch.retrieval.ivf_pq import IVFPQIndex, build_index, search


@runtime_checkable
class RetrievalBackend(Protocol):
    """Search interface the engine consumes."""
    name: str

    def search(self, queries: torch.Tensor, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """queries: (Q, D) vectors -> (scores (Q, k), ids (Q, k)); higher
        score is better."""
        ...

    @property
    def bytes_per_query(self) -> float:
        """Database bytes scanned per query vector (cost-model units)."""
        ...


class ExactBackend:
    """Brute-force scan (paper Case II: no ANN index)."""
    name = "exact"

    def __init__(self, db_vectors, metric: str = "cosine", device="cuda"):
        self.device = resolve_device(device)
        self.db = torch.as_tensor(db_vectors).to(self.device)
        self.metric = metric

    def search(self, queries: torch.Tensor, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        scores, idx = knn(torch.as_tensor(queries).to(self.device), self.db,
                          k=k, metric=self.metric)
        return scores.cpu().numpy(), idx.cpu().numpy()

    @property
    def bytes_per_query(self) -> float:
        n, d = self.db.shape
        return float(n * d * self.db.element_size())


def _default_n_lists(n_vectors: int) -> int:
    """sqrt(N) coarse lists (balanced 2-level scan), clamped to [1, N]."""
    return max(1, min(n_vectors, int(round(n_vectors ** 0.5))))


def _default_n_subq(dim: int, target: int = 8) -> int:
    """Largest divisor of the vector dim that is <= target."""
    for s in range(min(target, dim), 0, -1):
        if dim % s == 0:
            return s
    return 1


class IVFPQBackend:
    """IVF-PQ approximate search over an index built at construction.

    ``use_kernel=None`` means the CUDA pq_scan kernel on a CUDA device and
    the plain scan on the CPU."""
    name = "ivfpq"

    def __init__(self, db_vectors, nprobe: int = 8,
                 n_lists: int | None = None, n_subq: int | None = None,
                 use_kernel: bool | None = None, seed: int = 0,
                 device="cuda", index: IVFPQIndex | None = None):
        self.device = resolve_device(device)
        if index is None:
            vecs = torch.as_tensor(db_vectors).to(self.device, torch.float32)
            n, d = vecs.shape
            if n_lists is None:
                n_lists = _default_n_lists(n)
            if n_subq is None:
                n_subq = _default_n_subq(d)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            index = build_index(gen, vecs, n_lists=n_lists, n_subq=n_subq)
        self.index = index
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        self.use_kernel = bool(use_kernel)
        self.nprobe = max(1, min(nprobe, index.n_lists))

    @classmethod
    def from_index(cls, index: IVFPQIndex, nprobe: int = 8,
                   use_kernel: bool | None = None,
                   device="cuda") -> "IVFPQBackend":
        """A backend over a pre-built index (e.g. one carried across from
        the JAX package with ``repro_torch.bridge.index_from_jax``)."""
        return cls(None, nprobe=nprobe, use_kernel=use_kernel,
                   device=device, index=index)

    def search(self, queries: torch.Tensor, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """When the probed lists hold fewer than k real vectors the id tail
        is -1 (IVF padding) with score -inf; consumers must drop negative
        ids rather than index a corpus with them."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        dists, ids = search(self.index, q, nprobe=self.nprobe, k=k,
                            use_kernel=self.use_kernel)
        return -dists.cpu().numpy(), ids.cpu().numpy()

    @property
    def bytes_per_query(self) -> float:
        """Coarse f32 centroid scan + PQ codes of the probed lists."""
        idx = self.index
        coarse = idx.n_lists * idx.centroids.shape[1] * 4
        list_len = idx.list_ids.shape[1]
        return float(coarse + self.nprobe * list_len * idx.n_subq)


class RetrievalError(RuntimeError):
    """A retrieval backend failed to serve a query batch."""


class RetrievalTimeout(RetrievalError):
    """A retrieval backend exceeded its (logical) deadline."""


class FallbackBackend:
    """Graceful-degradation chain over retrieval backends.

    ``search`` tries each backend in order and returns the first success;
    a :class:`RetrievalError` (or injected fault) falls through to the
    next one -- the degradation ladder is *primary (e.g. IVF-PQ) -> exact
    scan -> no-context* (every level failed: an all ``-1`` id batch with
    ``-inf`` scores, which the engine serves as a retrieval-free answer
    flagged ``degraded``).  With no faults the primary never raises and
    the chain is bit-transparent.

    ``metrics``: ``fallbacks`` (queries served by a non-primary level),
    ``no_context`` (queries served with no retrieval at all).  After each
    ``search``, ``last_level`` is the chain index that served it (``-1``
    = no-context) -- the engine reads it to flag degraded requests.

    ``injector`` (optional, settable post-construction) is a fault
    injector with ``fire(point)``; the chain consults the
    ``retrieval_timeout`` / ``retrieval_error`` points before the primary
    and ``retrieval_blackout`` before every level, so CI can exercise the
    whole ladder deterministically with real backends underneath."""

    def __init__(self, chain: list[RetrievalBackend], injector=None):
        if not chain:
            raise ValueError("fallback chain needs at least one backend")
        self.chain = list(chain)
        self.injector = injector
        self.metrics = {"fallbacks": 0, "no_context": 0}
        self.last_level: int = 0

    @property
    def name(self) -> str:
        """The primary's name: the chain is a robustness wrapper (bit
        transparent without faults), not a different backend -- callers
        asking which backend was deployed should see the primary."""
        return self.chain[0].name

    def _injected(self) -> str | None:
        """One deterministic fault decision per search call: blackout
        fails every level, timeout/error fail only the primary."""
        inj = self.injector
        if inj is None:
            return None
        if inj.fire("retrieval_blackout") is not None:
            return "blackout"
        if inj.fire("retrieval_timeout") is not None:
            return "timeout"
        if inj.fire("retrieval_error") is not None:
            return "error"
        return None

    def search(self, queries: torch.Tensor, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        fault = self._injected()
        if fault != "blackout":
            for level, backend in enumerate(self.chain):
                if level == 0 and fault in ("timeout", "error"):
                    continue                   # primary down this call
                try:
                    scores, ids = backend.search(queries, k)
                except RetrievalError:
                    continue
                if level > 0:
                    self.metrics["fallbacks"] += 1
                self.last_level = level
                return scores, ids
        # every level failed: the last-resort no-context answer
        self.metrics["no_context"] += 1
        self.last_level = -1
        n = int(queries.shape[0])
        return (np.full((n, k), -np.inf, np.float32),
                np.full((n, k), -1, np.int64))

    @property
    def bytes_per_query(self) -> float:
        return self.chain[0].bytes_per_query


BACKENDS = {"exact": ExactBackend, "ivfpq": IVFPQBackend}


def make_backend(name: str, db_vectors, *, nprobe: int = 8,
                 use_pq_kernel: bool | None = None, seed: int = 0,
                 device="cuda") -> RetrievalBackend:
    """EngineConfig-level factory: name + knobs -> backend instance."""
    if name == "exact":
        return ExactBackend(db_vectors, device=device)
    if name == "ivfpq":
        return IVFPQBackend(db_vectors, nprobe=nprobe,
                            use_kernel=use_pq_kernel, seed=seed,
                            device=device)
    raise ValueError(f"unknown retrieval backend {name!r}; "
                     f"known: {sorted(BACKENDS)}")


def measure_scan_bw(backend: RetrievalBackend, queries: torch.Tensor,
                    k: int = 10, iters: int = 3) -> float:
    """Measured scan throughput (bytes/s) of one backend.  ``search``
    returns host arrays, so each timed call includes the device's work."""
    k = max(1, k)
    backend.search(queries, k)                       # warm up
    t0 = time.perf_counter()
    for _ in range(iters):
        backend.search(queries, k)
    dt = (time.perf_counter() - t0) / iters
    total_bytes = backend.bytes_per_query * queries.shape[0]
    return total_bytes / max(dt, 1e-9)
