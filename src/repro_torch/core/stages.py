"""Per-stage performance profiling (Algorithm 1, Step 1).

Maps RAGSchema stage names to (latency, throughput) under a given XPU count
and batch size.  All per-stage knowledge (load, weights, analytical
operating points) lives in the stage registry
(``repro_torch.core.stage_registry``); this module is the thin frontier
layer on top: ``stage_frontier`` returns the per-stage Pareto over batch
sizes -- the exact pruning that lets the exhaustive schedule search stay
tractable.

Copied from ``src/repro/core/stages.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

from repro_torch.core import cost_model as cmod
from repro_torch.core.hardware import SystemConfig
from repro_torch.core.pareto import pareto
from repro_torch.core.ragschema import RAGSchema
from repro_torch.core.stage_registry import REGISTRY

BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
DECODE_BATCHES = BATCHES + (1024,)


def stage_load(schema: RAGSchema, stage: str) -> float:
    """Passes through this stage per served request."""
    return REGISTRY.get(stage).load(schema)


def stage_points(schema: RAGSchema, sys: SystemConfig, stage: str, n: int,
                 batch: int, tp_only: bool = False) -> list[cmod.StagePerf]:
    """All (latency, throughput) operating points of one stage on ``n``
    chips (or ``n`` servers for retrieval) at one batch size -- one point
    per (tp, pp) factorization (tp==n only for collocated stages)."""
    spec = REGISTRY.get(stage)
    if spec.points is None:
        raise ValueError(f"stage {stage!r} has no analytical points model")
    return spec.points(schema, sys, n, batch, tp_only=tp_only)


def stage_perf(schema: RAGSchema, sys: SystemConfig, stage: str, n: int,
               batch: int) -> cmod.StagePerf:
    """Throughput-optimal single point (characterization plots)."""
    pts = stage_points(schema, sys, stage, n, batch)
    return max(pts, key=lambda p: p.throughput)


def stage_weights_bytes(schema: RAGSchema, stage: str) -> float:
    """Accelerator memory pinned by the stage's model weights."""
    return REGISTRY.get(stage).weights_bytes(schema)


def stage_frontier(schema: RAGSchema, sys: SystemConfig, stage: str,
                   n: int, tp_only: bool = False) -> list[tuple]:
    """Pareto (latency, throughput/load, {stage meta}) over batch sizes AND
    (tp, pp) factorizations."""
    load = stage_load(schema, stage)
    pts = []
    for b in BATCHES:
        for p in stage_points(schema, sys, stage, n, b, tp_only=tp_only):
            pts.append((p.latency, p.throughput / load,
                        {"stage": stage, "batch": b, "chips": n}))
    return pareto(pts)


def decode_frontier(schema: RAGSchema, sys: SystemConfig, n: int,
                    iterative_overhead=None) -> list[tuple]:
    """(TPOT latency, request throughput, meta) over decode batch sizes.

    ``iterative_overhead(b_d) -> extra seconds per sequence`` models §5.3
    decode stalls (retrieval + iteration prefill + batching wait).
    """
    xpu = sys.xpu
    g = schema.generative
    pts = []
    for b in DECODE_BATCHES:
        if not cmod.decode_memory_ok(g, xpu, n, b,
                                     schema.prefix_len + schema.decode_len):
            continue
        tpot = cmod.decode_tpot(g, xpu, n, b,
                                schema.prefix_len + schema.decode_len // 2)
        seq_time = schema.decode_len * tpot
        if iterative_overhead is not None:
            seq_time = seq_time + iterative_overhead(b)
        tput = b / seq_time
        worst_tpot = seq_time / schema.decode_len
        pts.append((worst_tpot, tput, {"stage": "decode", "batch": b,
                                       "chips": n}))
    return pareto(pts)
