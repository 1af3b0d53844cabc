"""RAGO: exhaustive schedule search (paper §6, Algorithm 1).

Decisions: task placement (consecutive pre-prefill stages collocate or
disaggregate; main-LLM prefill/decode always disaggregated; retrieval always
on host CPUs), resource allocation (powers-of-two XPU counts per group),
batching (powers-of-two per stage, plus distinct iterative-retrieval batch).

The search is exhaustive over that space; per-stage Pareto pruning before
composition is exact for the (TTFT = sum of latencies, QPS = bottleneck
throughput) objectives, so the returned frontier equals the brute-force one.

The optimizer is stage-agnostic: the pipeline shape, per-stage load,
weights and cost models all come from the stage registry via
``RAGSchema.stages()`` / ``repro_torch.core.stages``, so registering a new
StageSpec makes it searchable here with no optimizer changes.

Copied from ``src/repro/core/optimizer.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core import cost_model as cmod
from repro_torch.core import stages as st
from repro_torch.core.hardware import SystemConfig
from repro_torch.core.pareto import combine_collocated, combine_serial, pareto
from repro_torch.core.pipeline_sim import schema_decode_stall
from repro_torch.core.ragschema import RAGSchema
from repro_torch.core.retrieval_model import min_servers_for_db, retrieval_perf

CHIP_OPTIONS = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclass
class PlanPoint:
    ttft: float
    qps: float
    qps_per_chip: float            # normalized by ALLOCATED chips (Table 4)
    total_chips: int
    placement: tuple
    qps_per_platform_chip: float = 0.0  # normalized by the full slice (S5)
    detail: dict[str, Any] = field(default_factory=dict)


def consecutive_partitions(items: list) -> list[list[list]]:
    """All ways to split ``items`` into consecutive groups."""
    n = len(items)
    if n == 0:
        return [[]]
    out = []
    for cuts in itertools.product([0, 1], repeat=n - 1):
        groups, cur = [], [items[0]]
        for i, c in enumerate(cuts):
            if c:
                groups.append(cur)
                cur = []
            cur.append(items[i + 1])
        groups.append(cur)
        out.append(groups)
    return out


def _frontier_union(points: list[PlanPoint],
                    include_placement: bool = True) -> list[PlanPoint]:
    """Union of the (TTFT, QPS) and (TTFT, QPS/chip) Pareto frontiers,
    deduplicated and sorted by TTFT.

    Plan comparison (Table 4) needs cost-efficiency while serving capacity
    (offered load) needs absolute QPS, so both frontiers are kept.
    """
    f1 = pareto([(p.ttft, p.qps_per_chip, p) for p in points])
    f2 = pareto([(p.ttft, p.qps, p) for p in points])
    seen, out = set(), []
    for _, _, p in f1 + f2:
        key = (p.ttft, p.qps, p.total_chips) \
            + ((p.placement,) if include_placement else ())
        if key not in seen:
            seen.add(key)
            out.append(p)
    return sorted(out, key=lambda p: p.ttft)


def _flatten_meta(meta) -> list[dict]:
    if isinstance(meta, dict):
        return [meta]
    out = []
    for m in meta:
        out.extend(_flatten_meta(m))
    return out


def _iterative_overhead_fn(schema: RAGSchema, sys: SystemConfig,
                           n_servers: int, prefill_chips: int):
    """Extra seconds per generated sequence from §5.3 decode stalls:
    (freq-1) x [batching wait + per-event stall], with the iterative batch
    size b_it chosen by RAGO (distinct from the initial batch, §6.1[III]).

    The per-event stall is the sum of every enabled StageSpec's
    ``decode_stall`` contribution (retrieval + iteration prefill in the
    paper pipeline; any registered decode-anchored screen rides along), so
    the search and ``pipeline_sim.simulate_schema_decode`` price the same
    events."""
    freq = schema.retrieval_frequency
    if freq <= 1:
        return None
    g = schema.generative

    def overhead(b_d: int) -> float:
        tpot = cmod.decode_tpot(g, sys.xpu, prefill_chips, b_d,
                                schema.prefix_len + schema.decode_len // 2)
        event_rate = b_d * freq / (schema.decode_len * tpot)  # events/s
        best, best_bit = float("inf"), None
        for b_it in st.BATCHES:
            wait = (b_it - 1) / 2.0 / event_rate
            stall = schema_decode_stall(
                schema, sys, n_servers, prefill_chips, b_it, base=wait)
            if stall < best:
                best, best_bit = stall, b_it
        overhead.chosen[b_d] = best_bit
        return (freq - 1) * best

    # the b_it RAGO picked per decode batch, so plans can record it and a
    # ServingPlan can deploy it as the engine's iterative retrieval_batch
    overhead.chosen = {}
    return overhead


def _eval_allocation(schema: RAGSchema, sys: SystemConfig, placement,
                     group_chips, decode_chips, retr_frontier, n_servers,
                     total_budget) -> list[PlanPoint]:
    """All schedule points for one (placement, allocation)."""
    hbm = sys.xpu.hbm_gb * 1e9 * 0.9
    total = sum(group_chips) + decode_chips
    if total > total_budget:
        return []
    for grp, n in zip(placement, group_chips):
        w = sum(st.stage_weights_bytes(schema, s) for s in grp)
        if w > n * hbm:
            return []
    if st.stage_weights_bytes(schema, "decode") > decode_chips * hbm:
        return []

    pre = None
    for grp, n in zip(placement, group_chips):
        gf = None
        tp_only = len(grp) > 1      # collocated stages occupy all chips
        for s in grp:
            sf = st.stage_frontier(schema, sys, s, n, tp_only=tp_only)
            gf = sf if gf is None else combine_collocated(gf, sf)
        pre = gf if pre is None else combine_serial(pre, gf)
    if retr_frontier is not None:
        pre = (combine_serial(pre, retr_frontier)
               if pre is not None else retr_frontier)

    over = _iterative_overhead_fn(
        schema, sys, n_servers,
        group_chips[-1] if group_chips else decode_chips)
    dec = st.decode_frontier(schema, sys, decode_chips, over)
    if not dec:
        return []
    out = []
    for lat_pre, tput_pre, meta_pre in pre:
        for _tpot, tput_dec, meta_dec in dec:
            qps = min(tput_pre, tput_dec)
            detail = {"stages": _flatten_meta(meta_pre)
                      + _flatten_meta(meta_dec),
                      "group_chips": group_chips,
                      "decode_chips": decode_chips,
                      "n_servers": n_servers}
            if over is not None:
                detail["iter_batch"] = over.chosen.get(meta_dec["batch"])
            out.append(PlanPoint(
                ttft=lat_pre, qps=qps,
                qps_per_chip=qps / total, total_chips=total,
                qps_per_platform_chip=qps / total_budget,
                placement=tuple(tuple(g) for g in placement),
                detail=detail))
    return out


def enumerate_plans(schema: RAGSchema, sys: SystemConfig,
                    placements=None, collocate_only=False) -> list[PlanPoint]:
    """Full RAGO search.  Returns the global TTFT/QPS-per-chip Pareto."""
    total_budget = sys.n_xpus
    n_servers = max(sys.n_servers, min_servers_for_db(schema, sys.host))
    pre_stages = schema.xpu_stages_before_decode()

    if placements is None:
        placements = consecutive_partitions(pre_stages)
        if collocate_only:
            placements = [[pre_stages]]

    retr_frontier = (stage_frontier_retrieval(schema, sys, n_servers)
                     if schema.db_vectors > 0 else None)

    all_points = []
    for placement in placements:
        g_count = len(placement)
        for chips in itertools.product(CHIP_OPTIONS, repeat=g_count + 1):
            all_points.extend(_eval_allocation(
                schema, sys, placement, chips[:-1], chips[-1],
                retr_frontier, n_servers, total_budget))
    return _frontier_union(all_points)


def allocation_sweep(schema: RAGSchema, sys: SystemConfig,
                     placement) -> dict:
    """Best QPS/chip per allocation vector (Fig. 18 sensitivity)."""
    total_budget = sys.n_xpus
    n_servers = max(sys.n_servers, min_servers_for_db(schema, sys.host))
    retr_frontier = (stage_frontier_retrieval(schema, sys, n_servers)
                     if schema.db_vectors > 0 else None)
    out = {}
    g_count = len(placement)
    for chips in itertools.product(CHIP_OPTIONS, repeat=g_count + 1):
        pts = _eval_allocation(schema, sys, placement, chips[:-1],
                               chips[-1], retr_frontier, n_servers,
                               total_budget)
        if pts:
            out[chips] = max(p.qps_per_chip for p in pts)
    return out


def stage_frontier_retrieval(schema: RAGSchema, sys: SystemConfig,
                             n_servers: int) -> list[tuple]:
    load = st.stage_load(schema, "retrieval")
    pts = []
    for b in st.BATCHES:
        perf = retrieval_perf(schema, sys.host, n_servers, b)
        pts.append((perf.latency, perf.throughput / load,
                    {"stage": "retrieval", "batch": b,
                     "servers": n_servers}))
    return pareto(pts)


def baseline_plans(schema: RAGSchema, sys: SystemConfig) -> list[PlanPoint]:
    """LLM-system-extension baseline (§7.1): all extra components collocated
    with the main prefill; prefill:decode chips tuned 1:1."""
    pre_stages = schema.xpu_stages_before_decode()
    placement = [pre_stages]
    total_budget = sys.n_xpus
    n_servers = max(sys.n_servers, min_servers_for_db(schema, sys.host))
    retr_frontier = (stage_frontier_retrieval(schema, sys, n_servers)
                     if schema.db_vectors > 0 else None)
    pts = []
    for n in CHIP_OPTIONS:
        if 2 * n > total_budget:
            continue
        pts.extend(_eval_allocation(schema, sys, placement, (n,), n,
                                    retr_frontier, n_servers, total_budget))
    return _frontier_union(pts, include_placement=False)


def best_qps_per_chip(plans: list[PlanPoint],
                      min_qps_frac: float = 0.5) -> PlanPoint:
    """Most cost-efficient plan among those that can actually serve the
    offered load (QPS within ``min_qps_frac`` of the platform's best).
    Without the capacity filter a 2-chip micro-deployment can win QPS/chip
    trivially while serving ~no traffic."""
    qmax = max(p.qps for p in plans)
    ok = [p for p in plans if p.qps >= min_qps_frac * qmax]
    return max(ok, key=lambda p: p.qps_per_chip)


def best_ttft(plans: list[PlanPoint]) -> PlanPoint:
    return min(plans, key=lambda p: p.ttft)
