"""Iterative-retrieval decode simulation (paper §5.3, Figs. 9-10).

Monte-Carlo lockstep simulation of a continuous decode batch where each
sequence issues ``retrieval_frequency`` retrievals at uniformly random token
positions (paper setup).  When a sequence hits a retrieval point it idles
until (a) ``retrieval_batch`` pending retrieval requests have accumulated
across the batch, then (b) the batched retrieval + iteration prefill
completes.  Completed sequences are immediately replaced (continuous
batching), so idleness is purely retrieval-induced.

``normalized_decode_latency`` reproduces Fig. 10b's heat map: retrieval and
prefill latencies set to zero isolates the batching-induced waiting.

``simulate_schema_decode`` is the registry hook: it derives the per-event
stall latency from the StageSpecs a schema enables (every spec with a
``decode_stall`` contribution, e.g. retrieval + iteration prefill + any
registered screen over retrieved content) so new stages extend the
simulation without edits here.

Copied from ``src/repro/core/pipeline_sim.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

import numpy as np


def simulate_iterative_decode(decode_batch: int, retrieval_batch: int,
                              retrieval_frequency: int,
                              decode_len: int = 256,
                              tpot: float = 1.0,
                              retrieval_latency: float = 0.0,
                              prefill_latency: float = 0.0,
                              n_steps: int = 8192,
                              seed: int = 0) -> dict:
    """Lockstep simulation.  Time unit = one decode step (tpot).

    Returns worst-case-TPOT multiplier and throughput statistics.
    """
    rng = np.random.default_rng(seed)
    B, R = decode_batch, retrieval_batch
    freq = retrieval_frequency

    def draw_triggers():
        # 'freq' distinct retrieval positions, uniform over token indices
        return np.sort(rng.choice(decode_len, size=freq, replace=False))

    pos = np.zeros(B, dtype=np.int64)            # tokens generated
    triggers = np.stack([draw_triggers() for _ in range(B)])
    next_trig = np.zeros(B, dtype=np.int64)      # index into triggers
    waiting = np.zeros(B, dtype=bool)            # waiting for retrieval batch
    blocked_until = np.zeros(B)                  # absolute time, post-batch
    completed_tokens = 0
    completed_seqs = 0
    seq_tokens_done = []

    t = 0.0
    pending = []                                 # sequence idx waiting
    for _ in range(n_steps):
        t += tpot
        active = ~waiting & (blocked_until <= t)
        # decode one token for active sequences
        pos[active] += 1
        completed_tokens += int(active.sum())
        # retrieval triggers
        for i in np.nonzero(active)[0]:
            if next_trig[i] < freq and pos[i] >= triggers[i, next_trig[i]]:
                waiting[i] = True
                pending.append(i)
                next_trig[i] += 1
        # dispatch retrieval batch when R pending accumulated
        while len(pending) >= R:
            batch, pending = pending[:R], pending[R:]
            done_at = t + retrieval_latency + prefill_latency
            for i in batch:
                waiting[i] = False
                blocked_until[i] = done_at
        # sequence completion -> replace (continuous batching)
        done = pos >= decode_len
        for i in np.nonzero(done)[0]:
            completed_seqs += 1
            seq_tokens_done.append(pos[i])
            pos[i] = 0
            triggers[i] = draw_triggers()
            next_trig[i] = 0
            waiting[i] = False
            blocked_until[i] = 0.0

    total_slot_steps = n_steps * B
    utilization = completed_tokens / total_slot_steps
    # worst-case TPOT: a sequence's wall time per token ~ 1/utilization
    norm_latency = 1.0 / max(utilization, 1e-9)
    seq_rate = completed_seqs / (t if t > 0 else 1.0)
    return {"normalized_decode_latency": norm_latency,
            "utilization": utilization,
            "throughput_seqs_per_step": seq_rate,
            "worst_tpot": tpot * norm_latency}


def schema_decode_stall(schema, sys, n_servers: int, chips: int,
                        batch: int, base: float = 0.0) -> float:
    """Per-event stall seconds for one iterative-retrieval batch: the sum of
    every enabled StageSpec's ``decode_stall`` contribution (host stages get
    ``n_servers`` as their resource count, XPU stages get ``chips``).

    ``base`` is accumulated onto left-to-right in registry order so callers
    composing the stall with another term (the optimizer's batching wait)
    keep bit-exact float results regardless of where the sum starts."""
    from repro_torch.core.stage_registry import HOST, REGISTRY
    total = base
    for spec in REGISTRY.ordered():
        if spec.decode_stall is None or not spec.enabled(schema):
            continue
        n = n_servers if spec.placement == HOST else chips
        total += spec.decode_stall(schema, sys, n, batch)
    return total


def simulate_schema_decode(schema, sys, decode_batch: int,
                           retrieval_batch: int, n_servers: int,
                           chips: int, n_steps: int = 4096,
                           seed: int = 0) -> dict:
    """Registry-driven wrapper: TPOT from the analytical cost model, the
    per-event stall from ``schema_decode_stall``, then the Monte-Carlo
    lockstep simulation above."""
    from repro_torch.core import cost_model as cmod
    tpot = cmod.decode_tpot(schema.generative, sys.xpu, chips, decode_batch,
                            schema.prefix_len + schema.decode_len // 2)
    stall = schema_decode_stall(schema, sys, n_servers, chips,
                                retrieval_batch)
    return simulate_iterative_decode(
        decode_batch, retrieval_batch, schema.retrieval_frequency,
        decode_len=schema.decode_len, tpot=tpot, retrieval_latency=stall,
        n_steps=n_steps, seed=seed)
