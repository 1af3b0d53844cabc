"""Analytical XPU inference cost model (paper §4a, Fig. 4).

Operator-level roofline: every operator contributes
``T = max(FLOPs / P_comp, Bytes / B_mem)``; tensor-parallel sharding divides
FLOPs/weight-bytes across chips and adds two all-reduces of the activation
per layer; pipeline parallelism splits layers into stages (throughput scales
with stage count, latency pays inter-stage transfers).  Weights are 8-bit
(paper §4), activations bf16, KV cache int8.

Each public entry point returns ``StagePerf(latency, throughput)`` for one
batch on ``n`` chips, already optimized over (tp, pp) factorizations.

Copied from ``src/repro/core/cost_model.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

from repro_torch.core.hardware import XPUSpec
from repro_torch.core.ragschema import ModelShape

BYTES_ACT = 2      # bf16 activations
BYTES_W = 1        # int8 weights
BYTES_KV = 1       # int8 KV cache


@dataclass(frozen=True)
class StagePerf:
    latency: float          # seconds per batch (or per token for decode)
    throughput: float       # requests/s (or tokens/s for decode)

    def scaled(self, k: float) -> "StagePerf":
        return StagePerf(self.latency * k, self.throughput / k)


def _op(flops: float, bytes_: float, xpu: XPUSpec) -> float:
    """Roofline with a dispatch floor: models the paper's size-dependent
    P_comp(F_i)/B_mem(D_i) -- small operators achieve a smaller fraction of
    peak, which is what makes batching matter."""
    return max(flops / xpu.peak_flops, bytes_ / xpu.eff_mem_bw) \
        + xpu.op_overhead


def _tp_factors(n: int) -> list[tuple[int, int]]:
    out = []
    t = 1
    while t <= n:
        if n % t == 0:
            out.append((t, n // t))
        t *= 2
    return out


def _layer_weights(shape: ModelShape) -> tuple[float, float, float]:
    """(attn weight params, ffn weight params, total per layer)."""
    d, dh = shape.d_model, shape.d_head
    attn = d * shape.n_heads * dh * 2 + d * shape.n_kv_heads * dh * 2
    ffn = shape.n_ffn_mats * d * shape.d_ff
    return attn, ffn, attn + ffn


def _forward_pass_time(shape: ModelShape, xpu: XPUSpec, tp: int,
                       batch: int, new_tokens: int, ctx_len: int,
                       causal: bool, logits_tokens: int,
                       attn_span_frac: float = 1.0) -> float:
    """Time for one forward pass over all layers on a tp-group.

    new_tokens: tokens processed per sequence this pass (L prefill / 1
    decode); ctx_len: attention span; logits_tokens: tokens unembedded.
    """
    d, dh = shape.d_model, shape.d_head
    attn_w, ffn_w, layer_w = _layer_weights(shape)
    B, T = batch, new_tokens

    # Projections + FFN (per layer)
    proj_flops = 2.0 * B * T * layer_w / tp
    proj_bytes = layer_w * BYTES_W / tp + 6 * B * T * d * BYTES_ACT
    t_proj = _op(proj_flops, proj_bytes, xpu)

    # Attention: scores + AV.  Causal prefill touches ~ctx/2 on average.
    span = ctx_len / 2.0 if (causal and T > 1) else ctx_len
    span = span * attn_span_frac
    attn_flops = 2.0 * 2.0 * B * shape.n_heads * T * span * dh / tp
    kv_layer = shape.kv_bytes_per_token / shape.n_layers   # per-layer bytes
    kv_bytes = B * ctx_len * kv_layer * BYTES_KV / tp
    t_attn = _op(attn_flops, kv_bytes + 2 * B * T * d * BYTES_ACT, xpu)

    # TP collectives: 2 all-reduces of (B, T, d) activations per layer.
    t_comm = 0.0
    if tp > 1:
        ar_bytes = 2.0 * 2.0 * B * T * d * BYTES_ACT * (tp - 1) / tp
        t_comm = ar_bytes / xpu.ici_bw + 2 * xpu.coll_overhead

    per_layer = t_proj + t_attn + t_comm
    # Unembedding for logits_tokens
    t_head = _op(2.0 * B * logits_tokens * d * shape.vocab / tp,
                 d * shape.vocab * BYTES_W / tp, xpu)
    return shape.n_layers * per_layer + t_head


def _parallelism_points(shape: ModelShape, xpu: XPUSpec, n: int,
                        batch: int, new_tokens: int, ctx_len: int,
                        causal: bool, logits_tokens: int,
                        attn_span_frac: float = 1.0,
                        tp_only: bool = False) -> list[StagePerf]:
    """All (tp, pp) factorizations of n chips for one pass.

    Latency and throughput trade off across factorizations (high TP cuts
    latency, PP pipelines batches for throughput), so the caller keeps the
    whole set and lets the Pareto machinery prune.  ``tp_only`` restricts
    to tp == n: a time-multiplexed (collocated) stage occupies every chip
    of its group simultaneously (Fig. 14b), so pipeline splits are not
    available to it.
    """
    out = []
    for tp, pp in _tp_factors(n):
        if tp_only and tp != n:
            continue
        t_pass = _forward_pass_time(shape, xpu, tp, batch, new_tokens,
                                    ctx_len, causal, logits_tokens,
                                    attn_span_frac)
        # PP inter-stage transfer of activations (latency only)
        pp_comm = (pp - 1) * batch * new_tokens * shape.d_model * BYTES_ACT \
            / xpu.ici_bw
        latency = t_pass + pp_comm
        stage_time = t_pass / pp + pp_comm / max(pp - 1, 1) if pp > 1 \
            else t_pass
        out.append(StagePerf(latency, batch / stage_time))
    return out


def _best_over_parallelism(shape: ModelShape, xpu: XPUSpec, n: int,
                           batch: int, new_tokens: int, ctx_len: int,
                           causal: bool, logits_tokens: int,
                           objective: str = "throughput"):
    pts = _parallelism_points(shape, xpu, n, batch, new_tokens, ctx_len,
                              causal, logits_tokens)
    if objective == "latency":
        return min(pts, key=lambda p: p.latency)
    return max(pts, key=lambda p: p.throughput)


# ---------------------------------------------------------------------------
# Public stage models
# ---------------------------------------------------------------------------

@lru_cache(maxsize=200000)
def prefill_perf(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                 prefix_len: int) -> StagePerf:
    """Prefix stage: batch sequences of prefix_len; logits for last token."""
    return _best_over_parallelism(shape, xpu, n, batch, prefix_len,
                                  prefix_len, True, 1)


@lru_cache(maxsize=200000)
def prefill_points(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                   prefix_len: int,
                   tp_only: bool = False) -> tuple[StagePerf, ...]:
    """(latency, throughput) per (tp, pp) factorization -- the stage-level
    Pareto input."""
    return tuple(_parallelism_points(shape, xpu, n, batch, prefix_len,
                                     prefix_len, True, 1, tp_only=tp_only))


@lru_cache(maxsize=200000)
def encoder_points(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                   tokens: int, chunk: int = 512,
                   tp_only: bool = False) -> tuple[StagePerf, ...]:
    n_chunks = max(1, tokens // chunk)
    pts = _parallelism_points(shape, xpu, n, batch * n_chunks,
                              min(tokens, chunk), min(tokens, chunk),
                              False, 0, tp_only=tp_only)
    return tuple(StagePerf(p.latency, batch / (batch * n_chunks
                                               / p.throughput))
                 for p in pts)


@lru_cache(maxsize=200000)
def prefill_perf_hybrid_attn(shape: ModelShape, xpu: XPUSpec, n: int,
                             batch: int, prefix_len: int,
                             global_frac: float = 0.25) -> StagePerf:
    """Long-context LLM baseline: global attention in 1 of 4 layers, local
    (128-token) elsewhere (paper Fig. 8 comparison)."""
    pts = _parallelism_points(shape, xpu, n, batch, prefix_len, prefix_len,
                              True, 1, attn_span_frac=global_frac)
    return min(pts, key=lambda p: p.latency)


@lru_cache(maxsize=200000)
def decode_tpot(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                ctx_len: int) -> float:
    """Per-token decode latency (s) for a continuous batch at ctx_len."""
    perf = _best_over_parallelism(shape, xpu, n, batch, 1, ctx_len, False, 1,
                                  objective="latency")
    return perf.latency


@lru_cache(maxsize=200000)
def decode_perf(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                ctx_len: int, decode_len: int) -> StagePerf:
    """Full generation of decode_len tokens (avg ctx at midpoint)."""
    tpot = decode_tpot(shape, xpu, n, batch, ctx_len + decode_len // 2)
    latency = decode_len * tpot
    return StagePerf(latency, batch / latency)


@lru_cache(maxsize=200000)
def encoder_perf(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                 tokens: int, chunk: int = 512) -> StagePerf:
    """Bidirectional encoder over ``tokens`` per request (chunked)."""
    n_chunks = max(1, tokens // chunk)
    per = _best_over_parallelism(shape, xpu, n, batch * n_chunks,
                                 min(tokens, chunk), min(tokens, chunk),
                                 False, 0)
    return StagePerf(per.latency, batch / per.latency)


def decode_memory_ok(shape: ModelShape, xpu: XPUSpec, n: int, batch: int,
                     ctx_len: int) -> bool:
    weights = shape.params * BYTES_W
    kv = batch * ctx_len * shape.kv_bytes_per_token * BYTES_KV
    return (weights + kv) / n <= xpu.hbm_gb * 1e9 * 0.9


def min_chips_for_weights(shape: ModelShape, xpu: XPUSpec) -> int:
    need = shape.params * BYTES_W / (xpu.hbm_gb * 1e9 * 0.9)
    n = 1
    while n < need:
        n *= 2
    return n


# ---------------------------------------------------------------------------
# Measured-time calibration (the XPU-side sibling of
# core/retrieval_model.calibrate_host)
# ---------------------------------------------------------------------------

def calibrate_xpu(xpu: XPUSpec, schema, stage_time_s: dict,
                  n_prefills: int, *, n_chips: int = 1, batch: int = 1,
                  max_iters: int = 8) -> XPUSpec:
    """XPU spec with its efficiency factors fit to a measured per-stage
    wall time.

    ``stage_time_s`` is the engine's accounting
    (``RAGEngine.metrics["stage_time_s"]``) and ``n_prefills`` the number
    of prefills it accumulated over (``metrics["prefills"]``), so the
    anchor observation is seconds per generative-model prefill of the
    schema's ``prefix_len`` -- the stage the analytical model and the
    engine both price directly.  ``flops_eff`` and ``mem_eff`` are scaled
    by a common factor, fixed-point iterated until the analytical
    :func:`prefill_perf` prediction matches the measurement (the roofline's
    per-operator dispatch floor makes one closed-form step inexact), and
    clamped to (0, 1].  Every plan subsequently priced with the returned
    spec reflects the deployed system instead of the paper's MFU
    constants -- the same contract as
    :func:`repro_torch.core.retrieval_model.calibrate_host` on the host side.
    """
    from dataclasses import replace as _replace
    if n_prefills <= 0:
        raise ValueError("n_prefills must be positive")
    measured = stage_time_s.get("prefill", 0.0) / n_prefills
    if measured <= 0:
        raise ValueError("stage_time_s['prefill'] must be positive")
    spec = xpu
    for _ in range(max_iters):
        pred = prefill_perf(schema.generative, spec, n_chips, batch,
                            schema.prefix_len).latency
        k = pred / measured
        if 0.999 < k < 1.001:
            break
        spec = _replace(
            spec,
            flops_eff=min(max(spec.flops_eff * k, 1e-9), 1.0),
            mem_eff=min(max(spec.mem_eff * k, 1e-9), 1.0))
    return spec


def calibrate_xpu_decode(xpu: XPUSpec, decode_bytes_per_s: float) -> XPUSpec:
    """XPU spec with ``mem_eff`` pinned to a MEASURED decode-attention
    streaming bandwidth.

    Decode is memory-bound (the paper's premise): its roofline term is
    ``kv_bytes / eff_mem_bw``, so the achieved fraction of HBM bandwidth
    while streaming the KV cache IS the decode efficiency.
    ``decode_bytes_per_s`` comes from a kernel sweep
    (``benchmarks/kernel_bench.py``: KV bytes actually touched / wall
    time, best configuration); plans priced with the returned spec
    predict decode TPOT from the deployed kernel's measured bandwidth
    instead of the paper's 0.8 constant.  The compute-side ``flops_eff``
    is left untouched -- pair with :func:`calibrate_xpu` (prefill-anchored)
    when both sides have measurements.
    """
    from dataclasses import replace as _replace
    if decode_bytes_per_s <= 0:
        raise ValueError("decode_bytes_per_s must be positive")
    return _replace(xpu, mem_eff=min(max(decode_bytes_per_s / xpu.mem_bw,
                                         1e-9), 1.0))


def calibration_delta(nominal: XPUSpec, calibrated: XPUSpec) -> dict:
    """Audit record of how far a calibrated XPU spec moved from nominal:
    the efficiency knobs the calibrators fit (``flops_eff`` /
    ``mem_eff``) plus their ratios.  Stored by
    ``ServingPlan.optimize(..., xpu=...)`` in
    ``plan.detail["calibration"]`` so every live re-plan says what it
    measured, not just what it chose."""
    return {
        "name": calibrated.name,
        "flops_eff": calibrated.flops_eff,
        "mem_eff": calibrated.mem_eff,
        "nominal_flops_eff": nominal.flops_eff,
        "nominal_mem_eff": nominal.mem_eff,
        "flops_eff_ratio": (calibrated.flops_eff / nominal.flops_eff
                            if nominal.flops_eff > 0 else None),
        "mem_eff_ratio": (calibrated.mem_eff / nominal.mem_eff
                          if nominal.mem_eff > 0 else None),
    }
