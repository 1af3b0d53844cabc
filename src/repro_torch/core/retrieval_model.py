"""ScaNN-style retrieval performance model (paper §4b).

Multi-level tree scan: the search is a sequence of vector-scan operators;
each operator's time is ``max(bytes / P_comp(Q), bytes / B_mem)`` where
P_comp depends on how many threads (one per query) are active.  Distributed
search shards the database across servers with independent indexes: every
query is routed to all shards and results aggregate with negligible
broadcast/gather cost (§4b).

Calibration constants: 18 GB/s PQ-scan per EPYC core, 80% memory-bandwidth
utilization (paper-measured with open-source ScaNN at 4K-vector tree nodes).

Copied from ``src/repro/core/retrieval_model.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import lru_cache

from repro_torch.core.hardware import CPUHostSpec
from repro_torch.core.ragschema import RAGSchema


@dataclass(frozen=True)
class RetrievalPerf:
    latency: float            # s for one batch of requests
    throughput: float         # requests / s


def tree_levels(db_vectors: float, fanout: int = 4000) -> list[float]:
    """Balanced 3-level ScaNN tree: (64e9)^(1/3) ~= 4e3 fanout (§4)."""
    if db_vectors <= fanout:
        return [db_vectors]
    n_leaves = db_vectors
    l2 = db_vectors / fanout
    l1 = max(l2 / fanout, 1.0)
    return [l1, l2, n_leaves]


def query_bytes(schema: RAGSchema) -> float:
    """Bytes scanned per query vector across tree levels."""
    levels = tree_levels(schema.db_vectors)
    total = 0.0
    for i, n in enumerate(levels):
        if i == len(levels) - 1:
            total += n * schema.scan_fraction * schema.bytes_per_vec
        elif i == 0:
            # top level scanned in full, f32 centroids
            total += n * schema.vector_dim * 4
        else:
            # middle level: scan the probed fraction, PQ codes
            total += n * schema.scan_fraction * schema.bytes_per_vec
    return total


@lru_cache(maxsize=100000)
def _retrieval(db_vectors: float, bytes_per_query: float, n_servers: int,
               batch_queries: int, host: CPUHostSpec) -> RetrievalPerf:
    shard_bytes = bytes_per_query / max(n_servers, 1)
    q = max(batch_queries, 1)
    concurrent = min(q, host.cores)
    rate = min(concurrent * host.pq_scan_bw_per_core,
               host.mem_bw * host.mem_bw_util)
    latency = q * shard_bytes / rate
    return RetrievalPerf(latency, q / latency)


def retrieval_perf(schema: RAGSchema, host: CPUHostSpec, n_servers: int,
                   batch_requests: int) -> RetrievalPerf:
    """Perf for a batch of *requests* (each issues queries_per_retrieval
    query vectors)."""
    if schema.db_vectors <= 0:
        return RetrievalPerf(0.0, float("inf"))
    qb = query_bytes(schema)
    q = batch_requests * schema.queries_per_retrieval
    perf = _retrieval(schema.db_vectors, qb, n_servers, q, host)
    return RetrievalPerf(perf.latency, perf.throughput /
                         schema.queries_per_retrieval)


def calibrate_host(host: CPUHostSpec, measured_bytes_per_s: float,
                   cores_used: int = 1) -> CPUHostSpec:
    """Host spec with the PQ-scan bandwidth replaced by a measurement.

    ``measured_bytes_per_s`` comes from timing a real retrieval backend
    (:func:`repro_torch.retrieval.backend.measure_scan_bw`); ``cores_used``
    is how many cores that measurement saturated (a single-query scan uses
    one).
    Every plan the optimizer prices through ``retrieval_perf`` then reflects
    the measured system instead of the paper's 18 GB/s/core constant.
    """
    if measured_bytes_per_s <= 0:
        raise ValueError("measured_bytes_per_s must be positive")
    per_core = measured_bytes_per_s / max(cores_used, 1)
    return replace(host, pq_scan_bw_per_core=per_core)


def db_memory_bytes(schema: RAGSchema) -> float:
    return schema.db_vectors * schema.bytes_per_vec


def min_servers_for_db(schema: RAGSchema, host: CPUHostSpec) -> int:
    need = db_memory_bytes(schema) / (host.mem_gb * 1e9 * 0.9)
    return max(1, math.ceil(need))
