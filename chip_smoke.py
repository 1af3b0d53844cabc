#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's serving paths -- ``RAGServer`` over ``RAGEngine`` and
over the disaggregated ``RAGCluster``, with IBM Granite-3.0-2B at full
width (random weights from a seed), an encoder of ENCODER_120M's widths
with Granite's vocabulary, and IVF-PQ retrieval; then Minitron-8B and
ChatGLM3-6B in bf16 and int8 and the mixture-of-experts Moonlight-16B-A3B,
each at full width; the LM trainer, Granite-3.0-2B trained at full
width; the recsys and GNN families, DLRM-RM2 trained and scored at
full width; and the distributed layer's split-K decode, Granite served
through ``attn_impl="splitk"`` and split across two ranks on the card --
and holds every CUDA kernel of those paths against its plain PyTorch
version.  Full-sequence
attention (prefill, the encoder, greedy generation's prompt pass) runs the
flash attention kernel on every path.  The paged path decodes through the
paged-decode kernel; the dense path decodes through the dense decode
kernel, behind every pre-prefill stage of ``full_pipeline`` (rewrite,
multi-query fan-out, rerank, safety filter); the plan path is RAGO's own
workflow -- ``ServingPlan.optimize`` on the ``iterative`` schema with
Granite as its generator, then ``RAGServer.from_plan`` and
``replay_trace`` -- with iterative retrieval during decode, deployed
collocated and then as the plan's placement (2 prefill engines + 1 decode
engine, KV handed off through host memory).  Phases, each printed as JSON
lines (and its seconds as a ``phase_seconds`` line), in order:

  device       card name, ``nvidia-smi`` name and power limit, TF32 flags
  build        nvcc build of ``src/repro_torch/csrc/*.cu`` (seconds)
  setup        model weights, corpus encode, IVF-PQ index, two engines
  kernels      each kernel vs its plain version at its path's shapes
               (the dense kernel's partial entry at the splitk engine's),
               timed warm and cold in L2; paged decode at serve's and
               serve_plan's shapes and at the KV heads of Moonlight,
               Minitron and ChatGLM3 (D=128, G=1/4/16), dense decode also
               at greedy generation's B=1 shape, each with its split;
               flash also at those models' prefills and a few edges
               (ragged S, kv_len < S, D=128); the PQ scan at one serve
               search, through both entry points; the paged chunk-extend
               attention at the iterative benchmark cell's append batch
               and at serve_plan's append, beside the plain path as the
               extend runs it
  decode_sync  the decode steps with no host read: one paged_decode_step
               through the paged kernel and one dense decode_step through
               the dense kernel, Granite-3.0-2B at serve's shape (8 slots,
               s_max 1,024; a masked row whose table of zeros aliases a
               live row's target, a row at its table's end), each run
               under ``torch.cuda.set_sync_debug_mode("error")``, then
               captured in a CUDA graph and replayed from the same bytes:
               logits and caches bit-equal to the eager step, the dropped
               rows' bytes unchanged; eager and replayed step times
  retrieve_scale  IVF-PQ search over a Wikipedia-sized index made on the
               card (21,015,324 vectors in 4,096 lists, 96-byte codes): 32
               queries through ``IVFPQBackend.search`` (one scan launch
               each) against the plain search, the scan kernel against its
               plain version with its bytes bound and lookup ceiling, and
               where a search's time goes
  serve        16 Poisson-arriving questions through the paged engine;
               every kernel's launch count over this phase alone
  trace        span tracing's cost on serve's warm engine: the 16
               questions as one closed batch, 3 times untraced and 3
               times with a fresh ``SpanTracer``, alternating; the min
               wall of each arm and its range, the overhead, spans and
               drops, the span-derived latencies against the request
               fields, ``slo_summary``, and each run's launches and host
               syncs, which must be equal in both arms; a seventh,
               traced run sums the host time spent inside the tracer
  serve_dense  8 Poisson-arriving questions through the dense engine and
               its five stage executors; launch counts over this phase
  serve_plan   the plan for ``iterative`` on 1 x 4 H100s, deployed on
               this card (a fresh engine: corpus encode, index, paged
               pool of 128 slots), 8 questions replayed from a JSONL
               trace, 256 tokens each; launch counts over this phase
               (the chunk-extend kernel once a layer an append forward)
  serve_disagg the same plan deployed with ``topology="disagg"``: 2
               prefill engines + 1 decode engine (``plan.group_sizes()``)
               on this card, the same trace; TTFT/TPOT per group, the
               handoff's bytes and its export / checksum / verify / import
               times per request; launch counts over this phase; traced,
               its Perfetto trace and span log written to ``build/traces/``
               and read back (serve_plan's engine is collected first, so
               the peak memory is this phase's)
  check        teacher-forced decode step on each pool and teacher-forced
               prefill, kernel vs plain attention; IVF-PQ search with and
               without the scan kernel; disagg parity (4 questions one at
               a time through a 1+1 cluster and a collocated engine: equal
               tokens) and a handed-off slot read back bit-equal
  chaos        every ``CHAOS_SCHEDULES`` entry on a 2+2 cluster (8 decode
               slots, 16 tokens, 4 questions): every request terminal
               once, nothing leaked, retry parity with the unfaulted run;
               each run traced: a FAULT event a firing, a RETRY a retry
  control      a ``ClusterController`` on serve_disagg's cluster: the
               H100 spec calibrated from its measurements and the re-plan
               on it, then ``resize(2, 2)`` and ``resize(2, 1)`` during a
               fresh replay of the trace, no request dropped; traced: a
               CONTROL event a controller event, a MIGRATE a migration
  models       every engine, server and cluster above collected but
               serve's encoder, corpus embedding and index: Minitron-8B,
               then ChatGLM3-6B, at full width (random bf16 weights from a
               seed), each freed before the next: a teacher-forced decode
               step and prefill (kernel vs plain attention),
               ``quantize_for_serving``, the largest gap between the bf16
               and int8 next-token distributions (printed, not gated),
               and 4 questions through a paged engine on the int8 weights
  train        on the emptied card, the LM trainer (no serving kernel
               runs on it; launches are checked to stay 0): one step of a
               2-layer slice of Granite-3.0-2B at full width in float32
               on the card and on the CPU (loss, gradient norm, updated
               parameters); Granite-3.0-2B at full width through
               ``launch.train.main`` at its defaults (one step lowers the
               loss on its batch; 5 steps, every loss finite); the step at
               4 x 2,048 tokens with remat timed (forward+backward and
               AdamW on CUDA events, tokens/s, model FLOPs against the
               bf16 peak, AdamW against its bytes bound, peak memory) and
               the stacks' gradients through ``unstack_layers`` against
               per-layer indexing; ``with_error_feedback`` over the
               full-width gradients (the int8 bound per leaf, its time);
               a checkpoint restart on the reduced config under ``build/``
               (resumed at step 7, history equal to an uninterrupted run)
  recsys_gnn   on the emptied card, float32 with TF32 off (no serving
               kernel runs; launches are checked to stay 0), weights
               drawn on the card from a generator: DLRM-RM2 (1.66 B
               parameters), two-tower, xDeepFM and MIND at their
               published widths, each held against the CPU at batch 512
               (loss, the serving output, every gradient leaf, the table
               rows the batch reads; every other row's gradient exactly
               0), a 1,000,000-candidate top-100 (DLRM's against the CPU,
               differences only at near-ties), serve_p99 and serve_bulk
               forwards, and 5 AdamW steps at the train batch (65,536 for
               DLRM; each cut printed on a ``reduced`` line with its
               reason): forward+backward and AdamW on CUDA events, rows/s,
               the loss before and after one step, peak memory; then PNA
               at full_graph_sm (against the CPU), molecule and
               minibatch_lg (one 1,024-target subgraph sampled by
               ``graph_neighbor_sampler`` from a synthetic graph of
               Reddit's size, the sampler's host time printed), each
               trained 5 steps; ogb_products is listed as not run.
               DLRM-RM2 and every PNA shape train through their cell
               programs (``launch/steps.py``, a 1 x 1 mesh), and PNA
               full_graph_sm also runs the dst-partitioned forward on one
               shard against ``gnn.forward``
  distributed  on the emptied card, the split-K decode of the
               distributed layer: Granite-3.0-2B at full width through
               serve's engine config with ``attn_impl="splitk"`` (the dense
               kernel's partial entry, 40 launches a decode step) and with
               ``"cuda"``, 16 Poisson questions each, equal tokens up to a
               near tie, TTFT and TPOT, a teacher-forced decode step plain
               vs split-K; two ranks on this one card over gloo, each
               holding half of one Granite-width layer's cache (B 16, S
               32,768, bf16: 1.07 GB), the combine against the rank-free
               kernel and the plain version, its time; the int8-KV split-K
               decode variant cell (``build_lm_decode_variant``) at full
               width, B 8, S 4,096, against the baseline decode step
               (softmax within the reference's 0.1)
  serve_moe    last, on the emptied card: Moonlight-16B-A3B in the
               reference's config at full width (48 layers, 64 experts
               top-6, 56.1 GB of bf16 weights), an encoder of
               ENCODER_120M's widths with its vocabulary, serve's engine
               and traffic (16 Poisson questions); launches, TTFT, TPOT,
               the stage times, bytes and peak memory; a teacher-forced
               decode step and prefill (kernel vs plain attention, the
               routing pinned) and ``moe_ffn`` at the decode shape against
               a token-wise version, with its device time a layer

then the ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without that last line; every traced phase
fails on a span left open, a dropped span or any other
``validate_spans`` violation.  It needs a CUDA
device and the repository around it.

    python3 chip_smoke.py             # every phase above
    python3 chip_smoke.py --profile   # and a torch.profiler breakdown of
                                      # five decode ticks and of one
                                      # timed train step
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): device-memory rate and the
# operation rates by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

QPS = 8.0                 # Poisson arrival rate of the serve phase
N_QUESTIONS = 16
DENSE_QPS = 4.0           # ... and of the serve_dense phase
N_DENSE_QUESTIONS = 8
PLAN_QPS = 4.0            # ... and of the serve_plan trace
N_PLAN_QUESTIONS = 8
NEW_TOKENS = 32
TIMING_REPS = 50
#: the device of the encoders and of the models and serve_moe phases'
#: models (a rehearsal of those phases on the CPU sets "cpu")
DEVICE = "cuda"
# the stage executors of repro/configs/rag_pipelines.py::full_pipeline
DENSE_STAGES = ("rewrite", "multi_query", "retrieval", "rerank",
                "safety_filter")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_of(fn, reps: int = 1):
    """``fn()`` warmed up once on a side stream, then ``reps`` calls of it
    captured in one CUDA graph: (graph, the last captured call's
    output)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    return graph, out


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in one CUDA
    graph, replayed between two CUDA events (host launch cost excluded).
    Inputs stay resident in L2 across the replays."""
    import torch
    graph, _ = graph_of(fn, reps)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_cold(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` call with its inputs out of L2: each
    captured launch follows a write of a 128 MB buffer (2.5x the H100's 50
    MB L2), and the time of the writes alone, captured the same way, is
    subtracted."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        fn()
    return device_ms(flushed, reps) - device_ms(flush.zero_, reps)


def bound(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate of the input type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 matmuls
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
          "sources": [str(s.relative_to(ROOT)) for s in _build.sources()]})


def serve_engine_config():
    """The paged engine of serve, models and serve_moe: 8 slots of s_max
    1,024 in pages of 16, two documents a question from IVF-PQ, 32 new
    tokens."""
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(decode_slots=8, s_max=1024, page_size=16,
                        retrieval_k=2, max_new_tokens=NEW_TOKENS,
                        retrieval_backend="ivfpq")


def encoder_component(vocab_size: int):
    """ENCODER_120M's widths (repro.core.ragschema), bidirectional, f32,
    with the generator's vocabulary as repro/launch/serve.py sizes its
    encoder: rewrite and fan-out hand generated ids to it."""
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Component
    cfg = tr.TransformerConfig(
        name="st-120m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=3072, vocab_size=vocab_size, causal=False)
    return Component(cfg, tr.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(1),
        dtype=torch.float32, device=DEVICE))


def phase_setup():
    import torch
    from repro_torch.configs import granite_3_2b
    from repro_torch.data.synthetic import topical_corpus
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Component, EngineConfig, RAGEngine

    t0 = time.perf_counter()
    gen_cfg = granite_3_2b.CONFIG
    gen = Component(gen_cfg, tr.init_params(
        gen_cfg, torch.Generator(device="cuda").manual_seed(0),
        dtype=torch.bfloat16, device="cuda"))
    enc = encoder_component(gen_cfg.vocab_size)
    enc_cfg = enc.cfg
    corpus, _topics, make_q = topical_corpus(4096, 256, enc_cfg.vocab_size)
    engine = RAGEngine(gen, enc, corpus, serve_engine_config(),
                       device="cuda")
    # full_pipeline's schema values; its 8B rewriter has no config in the
    # port, so Granite rewrites too, and the encoder reranks and screens
    dense_cfg = EngineConfig(decode_slots=8, s_max=1024, paged=False,
                             retrieval_k=2, max_new_tokens=NEW_TOKENS,
                             retrieval_backend="ivfpq", rewrite_tokens=32,
                             fanout_queries=2, fanout_tokens=16, rerank=True,
                             rerank_candidates=16, safety_threshold=0.0)
    dense = RAGEngine(gen, enc, corpus, dense_cfg, rewriter=gen,
                      reranker=enc, safety=enc,
                      db_vectors=engine.db_vectors,
                      backend=engine.backend.chain[0], device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in gen.params.buffers())
    gen_bytes = sum(t.numel() * t.element_size()
                    for t in gen.params.buffers())
    pool_bytes = sum(v.numel() * v.element_size()
                     for v in engine.pool.cache.values())
    dense_bytes = sum(v.numel() * v.element_size()
                      for v in dense.pool.cache.values())
    index = engine.backend.chain[0].index
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "model": gen_cfg.name, "params": n_params,
          "param_bytes": gen_bytes, "kv_pages": engine.pool.n_pages,
          "kv_pool_bytes": pool_bytes, "dense_kv_bytes": dense_bytes,
          "dense_executors": [e.name for e in dense.executors],
          "encoder_vocab": enc_cfg.vocab_size, "corpus": list(corpus.shape),
          "ivf_lists": index.n_lists, "ivf_list_len": index.list_ids.shape[1],
          "pq_subq": index.n_subq, "nprobe": engine.backend.chain[0].nprobe,
          "attn_impl": engine.attn_impl})
    if [e.name for e in dense.executors] != list(DENSE_STAGES):
        raise AssertionError(f"dense engine executors: {dense.executors}")
    questions = [make_q(i % 8) for i in range(N_QUESTIONS)]
    return engine, dense, questions


#: the paged kernel's shapes on the main path, (B, H_kv, G, D, page, M,
#: lengths, two rows that share physical pages and their query): serve's
#: 8 slots of s_max 1,024 over lengths 0, 1, a non-multiple of the page
#: and M*page + 1 (clamps); serve_plan's 128 slots of s_max 768, 8 live
#: rows at 300-768 in the slots the pool hands out first (the highest)
#: beside 120 idle slots that attend over one row (the step writes every
#: slot at pos + 1); serve's slots and lengths at the heads of
#: Moonlight-16B-A3B (serve_moe: 16 KV heads, G=1, D=128), Minitron-8B
#: (8, G=4, D=128) and ChatGLM3-6B (2, G=16, D=128) for the models phase
SERVE_LENGTHS = [0, 1, 537, 1025, 300, 300, 1024, 16]
PAGED_SHAPES = {
    "serve": (8, 8, 4, 64, 16, 64, SERVE_LENGTHS, (4, 5)),
    "serve_plan": (128, 8, 4, 64, 16, 48,
                   [1] * 120 + [768, 300, 537, 640, 412, 412, 700, 555],
                   (124, 125)),
    "serve_moe": (8, 16, 1, 128, 16, 64, SERVE_LENGTHS, (4, 5)),
    "minitron": (8, 8, 4, 128, 16, 64, SERVE_LENGTHS, (4, 5)),
    "chatglm3": (8, 2, 16, 128, 16, 64, SERVE_LENGTHS, (4, 5)),
}


def paged_inputs(shape, dtype, rng):
    """q, k_pages, v_pages, tables, lengths on the card for one of
    PAGED_SHAPES, the pool one page larger than the tables hold."""
    import torch
    b, h_kv, g, d, page, m, lengths, (i, j) = shape
    tables = rng.permutation(b * m).reshape(b, m).astype(np.int32)
    tables[j] = tables[i]
    q = torch.tensor(rng.standard_normal((b, h_kv, g, d)), dtype=dtype,
                     device="cuda")
    q[j] = q[i]
    k, v = (torch.tensor(rng.standard_normal((b * m + 1, page, h_kv, d)),
                         dtype=dtype, device="cuda") for _ in range(2))
    return (q, k, v, torch.tensor(tables, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def paged_bound(shape, tables) -> tuple[float, str]:
    """The least time of one bf16 call: each distinct K/V row up to its
    clamped length once (shared pages count once), q, the used table
    entries, the lengths and the output; 4*G*D operations a position and
    kv head."""
    b, h_kv, g, d, page, m, lengths, _ = shape
    rows = set()
    n_ops = 0
    for bi, length in enumerate(lengths):
        length = min(length, m * page)
        rows.update((int(tables[bi, p // page]), p % page)
                    for p in range(length))
        n_ops += 4 * length * h_kv * g * d
    used_pages = sum(-(-min(x, m * page) // page) for x in lengths)
    n_bytes = (2 * len(rows) * h_kv * d * 2 + 2 * b * h_kv * g * d * 2
               + 4 * used_pages + 4 * b)
    return bound(n_bytes, n_ops, "bfloat16")


def check_paged_attention() -> dict:
    """Kernel vs plain version at the main path's two shapes
    (PAGED_SHAPES), bf16 and f32: within tolerance, exact zeros at length
    0, bit-equal rows on shared pages; each shape timed warm and cold in
    L2 in bf16, with the kernel's split plan."""
    import torch
    from repro_torch.kernels.decode_attention.ops import tile_positions
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_dense_ref)

    out = {"tol_reason": "kernel and plain version both keep f32 softmax "
                         "statistics and round the f32 result once; they "
                         "sum in other orders, so bf16 outputs of order "
                         "one differ by at most about one bf16 step"}
    for name, shape in PAGED_SHAPES.items():
        b, h_kv, g, d, page, m, lengths, (i, j) = shape
        rng = np.random.default_rng(0)
        res = {"shape": [b, h_kv, g, d, page, m], "lengths": lengths}
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            args = paged_inputs(shape, dtype, rng)
            got = pa.paged_decode_attention_cuda(*args)
            want = paged_decode_attention_dense_ref(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not err <= tol:
                raise AssertionError(f"paged attention {name} {dtype}: max "
                                     f"abs err {err} > {tol}")
            if got[args[4] == 0].any():
                raise AssertionError("paged attention: length-0 row not "
                                     "zero")
            if not torch.equal(got[i], got[j]):
                raise AssertionError("paged attention: shared pages "
                                     "disagree")
            res[str(dtype).removeprefix("torch.")] = {"max_abs_err": err,
                                                      "tol": tol}
            if dtype is not torch.bfloat16:
                continue
            res["ms"] = device_ms(lambda: pa.paged_decode_attention_cuda(
                *args))
            res["cold_ms"] = device_ms_cold(
                lambda: pa.paged_decode_attention_cuda(*args))
            res["plain_ms"] = device_ms(
                lambda: paged_decode_attention_dense_ref(*args))
            res["bound_ms"], res["bound_by"] = paged_bound(
                shape, args[3].cpu().numpy())
            res["max_abs_err"] = err
            res["n_split_chunk"] = pa.split_plan(m * page,
                                                 tile_positions(d, 2))
        out[name] = res
    # the kernels line reports serve's shape
    out.update({key: out["serve"][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by")},
               max_abs_err=max(out[n]["max_abs_err"] for n in PAGED_SHAPES))
    return out


#: the paged chunk extend's attention, (B, T, H_kv, G, D, page, M,
#: starts): the iterative benchmark cell's append batch (ChatGLM3-6B's 32
#: query heads over 2 KV heads of 128; 8 rows of 512 tokens appended at
#: 528-1,792 into tables of 256 pages of 16) and serve_plan's append
#: (Granite-3.0-2B's 32 over 8 heads of 64; one row, the 8-token bucket
#: of a 2-token append at 574 in a table of 48 pages: s_max 768); then the
#: cell's batch under the heads of Granite-3.0-2B, Minitron-8B (48 over
#: 8 of 128) and Moonlight-16B-A3B in the reference's config (16 over 16
#: of 128, G=1)
CHUNK_STARTS = [528, 576, 1104, 1152, 1680, 1728, 1764, 1792]
CHUNK_SHAPES = {"iterative_cell": (8, 512, 2, 16, 128, 16, 256, CHUNK_STARTS),
                "serve_plan": (1, 8, 8, 4, 64, 16, 48, [574]),
                "granite_heads": (8, 512, 8, 4, 64, 16, 256, CHUNK_STARTS),
                "minitron_heads": (8, 512, 8, 6, 128, 16, 256, CHUNK_STARTS),
                "moonlight_heads": (8, 512, 16, 1, 128, 16, 256,
                                    CHUNK_STARTS)}
#: kernel against plain version: one bf16 step of an output of order one
#: at most, and a share of the plain version's norm (the bounds of
#: tests/test_torch_chunk_attention.py)
CHUNK_TOL, CHUNK_REL_TOL = 2e-2, 2e-2


def chunk_bound(shape, tables) -> tuple[float, str]:
    """The least time of one bf16 call: 4*D operations a visible (query,
    key) pair and query head; q and the output once, each distinct K/V
    row a query sees once, the used table entries and the starts."""
    b, t, h_kv, g, d, page, m, starts = shape
    s = m * page
    rows = set()
    pairs = 0
    for bi, st in enumerate(starts):
        end = min(st + t, s)
        rows.update((int(tables[bi, p // page]), p % page)
                    for p in range(end))
        pairs += sum(min(st + i, s - 1) + 1 for i in range(t))
    used_pages = sum(-(-min(st + t, s) // page) for st in starts)
    n_bytes = (2 * b * t * h_kv * g * d * 2 + 2 * len(rows) * h_kv * d * 2
               + 4 * used_pages + 4 * b)
    return bound(n_bytes, 4 * d * h_kv * g * pairs, "bfloat16")


def check_paged_chunk_attention() -> dict:
    """Kernel vs plain version at CHUNK_SHAPES in bf16 (the kernel's one
    dtype), on random pools of B*M + 1 pages with each row's table a
    random draw of them: the largest, mean and relative errors within
    CHUNK_TOL / CHUNK_REL_TOL; each shape timed warm and cold in L2,
    beside the plain path as the extend runs it (the tables cut to the
    page of the last position) and the bound."""
    import torch
    from repro_torch.kernels.paged_chunk_attention import ops as pca
    from repro_torch.kernels.paged_chunk_attention.ref import (
        paged_chunk_attention_ref, tables_upto)

    out = {"tol_reason": "the kernel keeps f32 scores where the plain "
                         "version rounds them to bf16 before its f32 "
                         "softmax; outputs averaged over hundreds to "
                         "thousands of keys, so the error is bounded "
                         "against the plain version's norm as well"}
    for name, shape in CHUNK_SHAPES.items():
        b, t, h_kv, g, d, page, m, starts = shape
        gen = torch.Generator().manual_seed(0)
        n_pages = b * m + 1
        k, v = (torch.randn(n_pages, page, h_kv, d, generator=gen)
                .to(torch.bfloat16).to(DEVICE) for _ in range(2))
        tables = torch.randperm(n_pages - 1, generator=gen)[:b * m].reshape(
            b, m).to(torch.int32).to(DEVICE)
        q = torch.randn(b, t, h_kv * g, d, generator=gen).to(
            torch.bfloat16).to(DEVICE)
        first = torch.tensor(starts, dtype=torch.int32, device=DEVICE)
        cut = tables_upto(tables, max(starts) + t, page)

        def kernel():
            return pca.paged_chunk_attention_cuda(q, k, v, tables, first)

        def plain():
            return paged_chunk_attention_ref(q, k, v, cut, first)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        res = {"shape": [b, t, h_kv, g, d, page, m], "starts": starts,
               "max_abs_err": float(diff.max()),
               "mean_abs_err": float(diff.mean()),
               "rel_err": float(diff.norm() / want.float().norm())}
        if not (torch.isfinite(got).all() and res["max_abs_err"] <= CHUNK_TOL
                and res["rel_err"] <= CHUNK_REL_TOL):
            raise AssertionError(f"paged chunk attention {name}: {res}")
        res["ms"] = device_ms(kernel)
        res["cold_ms"] = device_ms_cold(kernel)
        res["plain_ms"] = device_ms(plain, 5)
        res["bound_ms"], res["bound_by"] = chunk_bound(
            shape, tables.cpu().numpy())
        out[name] = res
        del k, v, q, got, want, diff
        torch.cuda.empty_cache()
    # the kernels line reports the iterative cell's batch
    out.update({key: out["iterative_cell"][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by")},
               max_abs_err=max(out[n]["max_abs_err"] for n in CHUNK_SHAPES))
    return out


def check_decode_attention() -> dict:
    """Kernel vs plain version at the dense path's widths (B=8, S=1,024,
    H_kv=8, G=4, D=64), bf16 and f32, over lengths 1, a non-multiple of
    the tile, S, S + 1 (clamps to S), two equal rows, 16 and 1,000; and at
    greedy generation's shape (B=1, S=40: the rewrite's 8-token prompt
    bucket plus its 32 new tokens, at its last step's length 39).  One
    ``scaled_dot_product_attention`` call on the same inputs is timed as a
    yardstick (``library_ms``); the port never calls it."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da

    b, s, h_kv, g, d = 8, 1024, 8, 4, 64
    out = {"tol_reason": "kernel and plain version both keep f32 softmax "
                         "statistics and round the f32 result once; they "
                         "sum in other orders, so bf16 outputs of order "
                         "one differ by at most about one bf16 step"}
    out.update(_decode_at(b, s, h_kv, g, d, [1, 537, s, s + 1, 300, 300, 16,
                                             1000], seed=2))
    out["greedy"] = _decode_at(1, 40, h_kv, g, d, [39], seed=4)
    return out


def _decode_at(b, s, h_kv, g, d, lengths, seed) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    rng = np.random.default_rng(seed)
    out = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q = torch.tensor(rng.standard_normal((b, h_kv, g, d)),
                         dtype=dtype, device="cuda")
        k = torch.tensor(rng.standard_normal((b, s, h_kv, d)),
                         dtype=dtype, device="cuda")
        v = torch.tensor(rng.standard_normal((b, s, h_kv, d)),
                         dtype=dtype, device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = da.decode_attention_cuda(q, k, v, ln)
        want = decode_attention_ref(q, k, v, ln)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"decode attention {dtype}: max abs err "
                                 f"{err} > {tol}")
        out[str(dtype).removeprefix("torch.")] = {"max_abs_err": err,
                                                  "tol": tol}
        if dtype is not torch.bfloat16:
            continue
        ms = device_ms(lambda: da.decode_attention_cuda(q, k, v, ln))
        plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, ln))
        # the library call: (B, H, 1, D) queries over (B, H_kv, S, D) views
        # of the same caches, a (B, 1, 1, S) boolean mask of the lengths
        qs = q.reshape(b, h_kv * g, 1, d)
        ks, vs = k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None, :]
                < ln[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((library().reshape(b, h_kv, g, d).float()
                         - want.float()).abs().max())
        library_ms = device_ms(library)
        # bytes the work needs: each K/V row up to its clamped length once,
        # q, the lengths, the output
        n_pos = sum(min(x, s) for x in lengths)
        n_bytes = (2 * n_pos * h_kv * d * 2 + 2 * q.numel() * 2 + 4 * b)
        bound_ms, bound_by = bound(n_bytes, 4 * n_pos * h_kv * g * d,
                                   "bfloat16")
        out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_max_abs_err=lib_err, bound_ms=bound_ms,
                   bound_by=bound_by, max_abs_err=err,
                   shape=[b, s, h_kv, g, d], lengths=lengths,
                   n_split_chunk=da.split_plan(
                       b, h_kv, s, da.tile_positions(d, q.element_size())),
                   cold_ms=device_ms_cold(
                       lambda: da.decode_attention_cuda(q, k, v, ln)),
                   library_cold_ms=device_ms_cold(library))
    return out


#: the partial entry at the splitk engine's shape: serve's 8 slots over a
#: page-gathered view of M*page = 1,024 positions, Granite's heads (H_kv
#: 8, G 4, D 64), serve's lengths; whole (offset 0, one rank) and as the
#: second of two ranks' shards (512 positions from offset 512)
PARTIAL_SHAPE = (8, 1024, 8, 4, 64)


def partial_bound(lengths, offset, s, h_kv, g, d, itemsize) -> tuple:
    """Bytes: each K/V row the shard's visible lengths reach, once, q,
    the lengths and the f32 outputs (acc, m, l); operations: 4 a (row,
    head, column)."""
    n_pos = sum(max(0, min(x - offset, s)) for x in lengths)
    b = len(lengths)
    n_bytes = (2 * n_pos * h_kv * d * itemsize + b * h_kv * g * d * itemsize
               + 4 * b + 4 * b * h_kv * g * (d + 2))
    return bound(n_bytes, 4 * n_pos * h_kv * g * d, "bfloat16")


def check_decode_partial() -> dict:
    """The dense kernel's partial entry (one rank's split-K shard) against
    its plain version (``_local_decode_attn``) at PARTIAL_SHAPE, bf16 and
    f32, whole and as a second shard (rows past the first shard empty
    there: m = -inf, l = 0, acc = 0 exactly); the whole shape timed warm
    and cold in L2 in bf16.  The library yardstick is the efficient
    attention kernel's output and log-sum-exp (the same function, over K/V
    heads repeated to the query heads beforehand and a bias of the
    lengths); the port never calls it."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import local_decode_attn_ref

    b, s, h_kv, g, d = PARTIAL_SHAPE
    lengths = SERVE_LENGTHS
    rng = np.random.default_rng(5)
    out = {"shape": [b, s, h_kv, g, d], "lengths": lengths,
           "tol_reason": "m and l to the tolerance relative; acc / l as an "
                         "output of order one: the plain version, as JAX's, "
                         "scores in the input dtype and rounds p to it "
                         "before P V, the kernel keeps both in f32"}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q = torch.tensor(rng.standard_normal((b, 1, h_kv * g, d)),
                         dtype=dtype, device="cuda")
        k = torch.tensor(rng.standard_normal((b, s, h_kv, d)), dtype=dtype,
                         device="cuda")
        v = torch.tensor(rng.standard_normal((b, s, h_kv, d)), dtype=dtype,
                         device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        errs = {}
        for offset, lo in ((0, 0), (512, 512)):
            kk, vv = k[:, lo:].contiguous(), v[:, lo:].contiguous()
            acc, m, l = da.decode_attention_partial(q, kk, vv, ln, offset)
            racc, rm, rl = local_decode_attn_ref(q, kk, vv, ln, offset, g)
            torch.cuda.synchronize()
            empty = rl == 0
            if not (torch.equal(torch.isneginf(m), torch.isneginf(rm))
                    and torch.isneginf(m[empty]).all()
                    and (l[empty] == 0).all() and (acc[empty] == 0).all()):
                raise AssertionError(f"decode partial {dtype} offset "
                                     f"{offset}: empty rows not -inf/0/0")
            live = ~empty
            err = max(
                float(((m - rm)[live]).abs().max()
                      / max(1.0, float(rm[live].abs().max()))),
                float(((l - rl)[live] / rl[live]).abs().max()),
                float((acc[live] / l[live][..., None]
                       - racc[live] / rl[live][..., None]).abs().max()))
            if not err <= tol:
                raise AssertionError(f"decode partial {dtype} offset "
                                     f"{offset}: err {err} > {tol}")
            errs[f"offset_{offset}"] = err
        out[str(dtype).removeprefix("torch.")] = {**errs, "tol": tol}
        if dtype is not torch.bfloat16:
            continue
        out["max_abs_err"] = max(errs.values())
        out["ms"] = device_ms(lambda: da.decode_attention_partial(
            q, k, v, ln, 0))
        out["cold_ms"] = device_ms_cold(lambda: da.decode_attention_partial(
            q, k, v, ln, 0))
        out["plain_ms"] = device_ms(lambda: local_decode_attn_ref(
            q, k, v, ln, 0, g))
        out["bound_ms"], out["bound_by"] = partial_bound(
            lengths, 0, s, h_kv, g, d, 2)
        out["n_split_chunk"] = da.split_plan(
            b, h_kv, s, da.tile_positions(d, q.element_size()))
        out.update(library_yardstick(q, k, v, lengths, g))
    return out


def library_yardstick(q, k, v, lengths, g) -> dict:
    """``_scaled_dot_product_efficient_attention`` with its log-sum-exp
    over the same rows: its time and its output's error on the rows with
    a visible position."""
    import torch
    b, _, h, d = q.shape
    s = k.shape[1]
    qs = q.transpose(1, 2).contiguous()                     # (B, H, 1, D)
    ks = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    ln = torch.tensor(lengths, device="cuda")
    bias = torch.where(torch.arange(s, device="cuda")[None, :] < ln[:, None],
                       0.0, float("-inf")).to(q.dtype)
    bias = bias[:, None, None, :].expand(b, h, 1, s).contiguous()

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qs, ks, vs, bias, True)
    got = library()[0]
    ms = device_ms(library)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    want = decode_attention_ref(q[:, 0].reshape(b, h // g, g, d), k, v,
                                ln.to(torch.int32)).reshape(b, h, d)
    live = ln > 0
    err = float((got[:, :, 0].float() - want.float())[live].abs().max())
    return {"library_ms": ms, "library_max_abs_err": err,
            "library": "aten._scaled_dot_product_efficient_attention "
                       "(output and log-sum-exp), K/V heads repeated"}


def check_flash_attention() -> dict:
    """Kernel vs plain version at the shapes its paths run: the
    generator's prefill (B=1, S=1,024, H=32, H_kv=8, D=64, bf16, causal),
    the encoder's batch (B=32, S=256, H=12, D=64, f32, full), and the
    1,024-token prefills of Moonlight-16B-A3B (H=16, H_kv=16, D=128),
    Minitron-8B (32, 8, 128) and ChatGLM3-6B (32, 2, 128), and an
    8,192-token prefill at Minitron's heads, each timed warm and cold in
    L2; then a few edges (ragged S, kv_len < S, D=128, several sequences,
    a K/V ring that wraps) against the plain version.  At S = 8,192 the
    plain version runs one KV group at a time (the (S, S) f32 scores of
    all 32 heads would take 8.6 GB), and its time is that of the eight
    calls.  One ``scaled_dot_product_attention`` call on the same inputs is
    timed as a yardstick (``library_ms``); the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    shapes = {"prefill": (1, 1024, 32, 8, 64, torch.bfloat16, True, 2e-2),
              "encoder": (32, 256, 12, 12, 64, torch.float32, False, 1e-5),
              "serve_moe": (1, 1024, 16, 16, 128, torch.bfloat16, True,
                            2e-2),
              "minitron": (1, 1024, 32, 8, 128, torch.bfloat16, True, 2e-2),
              "chatglm3": (1, 1024, 32, 2, 128, torch.bfloat16, True, 2e-2),
              "minitron_8k": (1, 8192, 32, 8, 128, torch.bfloat16, True,
                              2e-2)}
    rng = np.random.default_rng(3)
    out = {"tol_reason": "kernel and plain version both keep f32 softmax "
                         "statistics and round the f32 result once; they "
                         "sum in other orders, so bf16 outputs of order "
                         "one differ by at most about one bf16 step"}
    for name, (b, s, h, h_kv, d, dtype, causal, tol) in shapes.items():
        q = torch.tensor(rng.standard_normal((b, s, h, d)), dtype=dtype,
                         device="cuda")
        k, v = (torch.tensor(rng.standard_normal((b, s, h_kv, d)),
                             dtype=dtype, device="cuda") for _ in range(2))
        # the plain version a KV group at a time where all heads' scores
        # would not fit
        g = h // h_kv
        heads = ([(slice(None), slice(None))] if s <= 4096 else
                 [(slice(j * g, (j + 1) * g), slice(j, j + 1))
                  for j in range(h_kv)])

        def plain():
            return [flash_attention_ref(q[:, :, qh], k[:, :, kh],
                                        v[:, :, kh], causal)
                    for qh, kh in heads]
        got = fa.flash_attention_cuda(q, k, v, causal)
        err = max(float((got[:, :, qh].float() - want.float()).abs().max())
                  for (qh, _), want in zip(heads, plain()))
        torch.cuda.synchronize()
        if not err <= tol:
            raise AssertionError(f"flash attention {name}: max abs err "
                                 f"{err} > {tol}")
        reps = TIMING_REPS if len(heads) == 1 else 3
        ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal),
                       reps)
        plain_ms = device_ms(plain, reps)
        # the library call on (B, H, S, D) views of the same tensors
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        # the library's output against the kernel's (both within a bf16
        # step of the plain version where it was compared above)
        lib_err = float((library().transpose(1, 2).float()
                         - got.float()).abs().max())
        library_ms = device_ms(library, reps)
        # bytes: q, k, v read once, the output written once; operations:
        # 4*D (QK^T and PV) per visible query-key pair and query head
        size = torch.finfo(dtype).bits // 8
        n_bytes = (2 * q.numel() + 2 * k.numel()) * size
        pairs = s * (s + 1) // 2 if causal else s * s
        bound_ms, bound_by = bound(n_bytes, 4 * d * pairs * b * h,
                                   str(dtype).removeprefix("torch."))
        out[name] = {"shape": [b, s, h, h_kv, d], "dtype": str(dtype),
                     "causal": causal, "max_abs_err": err, "tol": tol,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_vs_kernel_max_abs_err": lib_err,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "cold_ms": device_ms_cold(
                         lambda: fa.flash_attention_cuda(q, k, v, causal),
                         min(reps, 20)),
                     "library_cold_ms": device_ms_cold(library,
                                                       min(reps, 20))}
    # edges: (B, S, H, H_kv, D, dtype, causal, kv_len, tol)
    edges = [(2, 200, 8, 2, 64, torch.bfloat16, True, 131, 2e-2),
             (1, 77, 4, 4, 128, torch.bfloat16, False, 77, 2e-2),
             (1, 8, 4, 2, 128, torch.bfloat16, True, 8, 2e-2),
             (4, 300, 8, 2, 128, torch.bfloat16, True, 300, 2e-2),
             (2, 300, 8, 2, 128, torch.bfloat16, False, 171, 2e-2),
             (1, 2048, 4, 1, 64, torch.bfloat16, True, 2048, 2e-2),
             (3, 65, 12, 12, 64, torch.float32, False, 40, 1e-5),
             (1, 130, 8, 2, 128, torch.float32, True, 130, 1e-5)]
    out["edges"] = []
    for b, s, h, h_kv, d, dtype, causal, kv_len, tol in edges:
        q = torch.tensor(rng.standard_normal((b, s, h, d)), dtype=dtype,
                         device="cuda")
        k, v = (torch.tensor(rng.standard_normal((b, s, h_kv, d)),
                             dtype=dtype, device="cuda") for _ in range(2))
        got = fa.flash_attention_cuda(q, k, v, causal, kv_len)
        want = flash_attention_ref(q, k, v, causal, kv_len)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"flash attention at {(b, s, h, h_kv, d)} "
                                 f"{dtype} causal={causal} kv_len={kv_len}: "
                                 f"max abs err {err} > {tol}")
        out["edges"].append({"shape": [b, s, h, h_kv, d],
                             "dtype": str(dtype), "causal": causal,
                             "kv_len": kv_len, "max_abs_err": err,
                             "tol": tol})
    # the kernels line reports the generator's prefill shape
    out.update({key: out["prefill"][key] for key in
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
               max_abs_err=max(out["prefill"]["max_abs_err"],
                               out["encoder"]["max_abs_err"]))
    return out


def check_pq_scan(index, nprobe: int) -> dict:
    """Kernel vs plain version, bit-equal in f32, at the scan one search of
    the serve phase gives: ``pq_scan`` over (nprobe, list_len, S) codes
    (and a ragged tile edge), and ``pq_scan_lists`` over nprobe lists of
    the serve index read in place, as ``ivf_pq.search`` calls it; each
    timed warm and cold in L2."""
    import torch
    from repro_torch.kernels.pq_scan import ops as pq
    from repro_torch.kernels.pq_scan.ref import pq_scan_lists_ref, pq_scan_ref

    rows, list_len, n_subq = nprobe, index.list_ids.shape[1], index.n_subq
    rng = np.random.default_rng(1)
    out = {"shape": [rows, list_len, n_subq]}
    for n in (list_len, list_len + 131):        # and a ragged tile edge
        lut = torch.tensor(rng.standard_normal((rows, n_subq, 256)),
                           dtype=torch.float32, device="cuda")
        codes = torch.tensor(rng.integers(0, 256, (rows, n, n_subq)),
                             dtype=torch.uint8, device="cuda")
        got = pq.pq_scan_cuda(lut, codes)
        want = pq_scan_ref(lut, codes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            raise AssertionError(f"pq_scan at {tuple(codes.shape)} is not "
                                 f"bit-equal to its plain version ({err})")
        if n == list_len:
            out["ms"] = device_ms(lambda: pq.pq_scan_cuda(lut, codes))
            out["cold_ms"] = device_ms_cold(lambda: pq.pq_scan_cuda(lut,
                                                                    codes))
            out["plain_ms"] = device_ms(lambda: pq_scan_ref(lut, codes))
            n_bytes = lut.numel() * 4 + codes.numel() + rows * n * 4
            out["bound_ms"], out["bound_by"] = bound(
                n_bytes, rows * n * n_subq, "float32")
    probe = torch.tensor(rng.choice(index.n_lists, rows, replace=False),
                         dtype=torch.int32, device="cuda")
    got = pq.pq_scan_lists_cuda(lut, index.list_codes, probe)
    want = pq_scan_lists_ref(lut, index.list_codes, probe)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("pq_scan_lists over the serve index is not "
                             "bit-equal to its plain version")
    out["lists"] = {
        "rows": probe.tolist(),
        "ms": device_ms(lambda: pq.pq_scan_lists_cuda(lut, index.list_codes,
                                                      probe)),
        "cold_ms": device_ms_cold(lambda: pq.pq_scan_lists_cuda(
            lut, index.list_codes, probe)),
        "plain_ms": device_ms(lambda: pq_scan_lists_ref(
            lut, index.list_codes, probe))}
    out["max_abs_err"] = 0.0
    return out


#: the retrieve_scale phase's index: the DPR Wikipedia passage corpus
#: (Karpukhin et al. 2020: 21,015,324 passages, 768-d) in 4,096 IVF lists,
#: PQ-coded at RAGSchema.bytes_per_vec = 96 (one byte a sub-quantizer of 8
#: dims); searched by the engine's encoder batch of 32 queries at
#: EngineConfig's nprobe 8, k 10
SCALE_VECTORS = 21_015_324
SCALE_LISTS = 4096
SCALE_DIM = 768
SCALE_SUBQ = 96
SCALE_QUERIES = 32
SCALE_NPROBE = 8
SCALE_K = 10


def synthetic_index(seed: int = 0):
    """An ``IVFPQIndex`` of the scale above, made on the card from a seed:
    list lengths drawn uniformly in [0.5, 1.5] x the mean and summing to
    SCALE_VECTORS, lists padded to the longest (a multiple of 8, as
    ``build_index`` packs them) with id -1 and code 0, random codes, ids a
    permutation of the corpus, random centroids and codebooks.  The scan
    costs the same whatever trained the codes, so no k-means runs."""
    import torch
    from repro_torch.retrieval.ivf_pq import IVFPQIndex
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = 0.5 + torch.rand(SCALE_LISTS, generator=gen, device="cuda",
                         dtype=torch.float64)
    lengths = torch.floor(u / u.sum() * SCALE_VECTORS).long()
    lengths[:SCALE_VECTORS - int(lengths.sum())] += 1
    list_len = -(-int(lengths.max()) // 8) * 8
    valid = (torch.arange(list_len, device="cuda")[None]
             < lengths[:, None])
    codes = torch.randint(0, 256, (SCALE_LISTS, list_len, SCALE_SUBQ),
                          generator=gen, device="cuda", dtype=torch.uint8)
    codes.mul_(valid[..., None])
    ids = torch.full((SCALE_LISTS, list_len), -1, dtype=torch.int32,
                     device="cuda")
    ids[valid] = torch.randperm(SCALE_VECTORS, generator=gen, device="cuda",
                                dtype=torch.int32)
    centroids = torch.randn(SCALE_LISTS, SCALE_DIM, generator=gen,
                            device="cuda")
    codebooks = 0.5 * torch.randn(SCALE_SUBQ, 256, SCALE_DIM // SCALE_SUBQ,
                                  generator=gen, device="cuda")
    return IVFPQIndex(centroids=centroids, codebooks=codebooks,
                      list_ids=ids, list_codes=codes,
                      n_vectors=SCALE_VECTORS)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def lookup_ceiling(list_codes, rows, n_blocks: int,
                   sms: int = 132) -> dict:
    """The least time of the scan's shared-memory traffic at the card's
    highest SM clock.  A warp's lookup of one sub-quantizer for its 32 code
    rows takes as many cycles as the most distinct 4-byte table words one
    of the 32 banks holds (the bank of code c is c % 32; equal codes are
    one word); this counts that for every (warp, sub-quantizer) of these
    codes, lanes past the list's end idle.  The code bytes pass through
    shared memory twice (the copy writes them, the threads read them) and
    each block writes its table once, at 128 bytes a cycle an SM."""
    import torch
    n, ll, s = len(rows), list_codes.shape[1], list_codes.shape[2]
    warps = -(-ll // 32)
    cycles = 0
    for i in range(0, n, 16):
        c = list_codes[rows[i:i + 16].long()]                   # (r, LL, S)
        pad = warps * 32 - ll
        if pad:       # idle lanes repeat lane 0's code: no word of their own
            c = torch.cat([c, c[:, -(ll % 32):][:, :1].expand(
                -1, pad, -1)], dim=1)
        lanes = c.reshape(c.shape[0], warps, 32, s).permute(0, 1, 3, 2)
        present = torch.zeros(*lanes.shape[:3], 256, dtype=torch.bool,
                              device=c.device)
        present.scatter_(-1, lanes.long(), True)
        words = present.view(*lanes.shape[:3], 8, 32).sum(dim=3)
        cycles += int(words.amax(dim=-1).sum())
    lookups = n * ll * s
    code_bytes = n * ll * s
    cycles_total = (cycles + 2 * code_bytes / 128
                    + n_blocks * s * 1024 / 128)
    clock = max_sm_clock_hz()
    return {"ms": cycles_total / sms / clock * 1e3,
            "lookup_cycles": cycles, "lookups": lookups,
            "conflict_degree": cycles * 32 / lookups,
            "sm_clock_mhz": clock / 1e6}


def search_breakdown(index, queries, nprobe: int, k: int,
                     reps: int = 5) -> dict:
    """Where one ``ivf_pq.search`` spends its time, step by step -- coarse
    scan, ADC tables, the PQ scan (the kernel over the lists in place),
    top-k -- each step's device time (``device_ms``) and its wall time on
    the host clock, synchronised after the step (median of ``reps``); and
    beside them the plain scan of the gathered lists and the
    ``list_codes[probe]`` gather alone, which the kernel's path no longer
    runs."""
    import torch
    from repro_torch.retrieval import ivf_pq

    probe = ivf_pq.probe_lists(index, queries, nprobe)
    tables = ivf_pq.adc_tables(index, queries, index.centroids[probe])
    dists = ivf_pq.scan_lists(index, tables, probe, use_kernel=True)
    steps = {
        "coarse": lambda: ivf_pq.probe_lists(index, queries, nprobe),
        "adc_tables": lambda: ivf_pq.adc_tables(index, queries,
                                                index.centroids[probe]),
        "scan": lambda: ivf_pq.scan_lists(index, tables, probe,
                                          use_kernel=True),
        "top_k": lambda: ivf_pq.select_top_k(index, probe, dists, k),
        "scan_plain": lambda: ivf_pq.scan_lists(index, tables, probe,
                                                use_kernel=False),
        "gather": lambda: index.list_codes[probe]}
    out = {}
    for name, fn in steps.items():
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"device_ms": device_ms(fn, reps=3 if name == "scan_plain"
                                            else 10),
                     "wall_ms": float(np.median(walls))}
    q, p, s, _, dsub = (*tables.shape, index.codebooks.shape[-1])
    out["adc_temp_bytes"] = q * p * s * 256 * dsub * 4
    return out


def phase_retrieve_scale() -> dict:
    """IVF-PQ search at the paper's scale: a Wikipedia-sized index on the
    card (``synthetic_index``: 4,096 lists, 96-byte codes, ~3.0 GB of
    codes), 32 queries from a seed through ``IVFPQBackend.search`` -- one
    ``pq_scan`` launch a search -- held to the plain search's ids and
    distances; the kernel against its plain version, bit-equal, timed warm
    and cold beside its bytes bound and its shared-memory lookup ceiling;
    where a search's time goes; the phase's peak device memory."""
    import torch
    from repro_torch.kernels.pq_scan import ops as pq
    from repro_torch.kernels.pq_scan.ref import pq_scan_lists_ref
    from repro_torch.retrieval import ivf_pq
    from repro_torch.retrieval.backend import IVFPQBackend

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = synthetic_index(seed=0)
    queries = torch.randn(SCALE_QUERIES, SCALE_DIM, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    backend = IVFPQBackend.from_index(index, nprobe=SCALE_NPROBE,
                                      device="cuda")
    backend.search(queries, SCALE_K)                 # warm-up
    torch.cuda.synchronize()
    reset_launches()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        scores, ids = backend.search(queries, SCALE_K)
        walls.append(time.perf_counter() - t0)
    launches = read_launches()
    if launches != {**{name: 0 for name in launches}, "pq_scan": 5}:
        raise AssertionError(f"5 searches launched {launches}")
    d_k, i_k = ivf_pq.search(index, queries, SCALE_NPROBE, SCALE_K,
                             use_kernel=True)
    d_p, i_p = ivf_pq.search(index, queries, SCALE_NPROBE, SCALE_K,
                             use_kernel=False)
    if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
            and np.array_equal(ids, i_k.cpu().numpy())
            and np.array_equal(-scores, d_k.cpu().numpy())):
        raise AssertionError("IVF-PQ search at scale differs with the scan "
                             "kernel")
    if not (torch.isfinite(d_k).all() and (i_k >= 0).all()):
        raise AssertionError("IVF-PQ search at scale: padding in the top-k")
    # the kernel at this scan's shape
    probe = ivf_pq.probe_lists(index, queries, SCALE_NPROBE)
    tables = ivf_pq.adc_tables(index, queries, index.centroids[probe])
    lut = tables.reshape(-1, SCALE_SUBQ, 256).contiguous()
    rows = probe.reshape(-1).int()
    codes = index.list_codes
    got = pq.pq_scan_lists_cuda(lut, codes, rows)
    want = pq_scan_lists_ref(lut, codes, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("pq_scan_lists at scale is not bit-equal to "
                             "its plain version")
    del want
    b, ll = got.shape
    ms = device_ms(lambda: pq.pq_scan_lists_cuda(lut, codes, rows), reps=20)
    cold_ms = device_ms_cold(lambda: pq.pq_scan_lists_cuda(lut, codes, rows))
    plain_ms = device_ms(lambda: pq_scan_lists_ref(lut, codes, rows), reps=3)
    distinct = int(torch.unique(rows).numel())
    code_bytes = distinct * ll * SCALE_SUBQ
    n_bytes = code_bytes + lut.numel() * 4 + b * 4 + b * ll * 4
    bound_ms, bound_by = bound(n_bytes, b * ll * SCALE_SUBQ, "float32")
    n_split, _, _ = pq.scan_plan(b, ll, SCALE_SUBQ)
    ceiling = lookup_ceiling(codes, rows, b * n_split)
    result = {
        "phase": "retrieve_scale", "index_s": t_index,
        "vectors": SCALE_VECTORS, "lists": SCALE_LISTS, "list_len": ll,
        "subq": SCALE_SUBQ, "code_bytes_total": codes.numel(),
        "queries": SCALE_QUERIES, "nprobe": SCALE_NPROBE, "k": SCALE_K,
        "launches": launches, "search_wall_ms": [w * 1e3 for w in walls],
        "search_ids_equal": True,
        "kernel": {"shape": [b, ll, SCALE_SUBQ], "distinct_lists": distinct,
                   "n_split": n_split, "ms": ms, "cold_ms": cold_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": n_bytes,
                   "lookup_ceiling_ms": ceiling["ms"],
                   "lookup_ceiling": ceiling,
                   "codes_gb_per_s": code_bytes / ms / 1e6,
                   "cold_codes_gb_per_s": code_bytes / cold_ms / 1e6,
                   "bit_equal": True},
        "search_device": search_breakdown(index, queries, SCALE_NPROBE,
                                          SCALE_K),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "phase_peak_mem_bytes": torch.cuda.max_memory_allocated() - base}
    emit(result)
    return result


def phase_kernels(engine) -> dict:
    import torch
    pa = check_paged_attention()
    emit({"phase": "kernels", "kernel": "paged_decode_attention", **pa})
    backend = engine.backend.chain[0]
    pq = check_pq_scan(backend.index, backend.nprobe)   # one query a search
    emit({"phase": "kernels", "kernel": "pq_scan", "tol": "bit-equal",
          **pq})
    dense = check_decode_attention()
    emit({"phase": "kernels", "kernel": "decode_attention", **dense})
    flash = check_flash_attention()
    emit({"phase": "kernels", "kernel": "flash_attention", **flash})
    partial = check_decode_partial()
    emit({"phase": "kernels", "kernel": "decode_attention_partial",
          **partial})
    chunk = check_paged_chunk_attention()
    emit({"phase": "kernels", "kernel": "paged_chunk_attention", **chunk})
    torch.cuda.synchronize()
    return {"paged_decode_attention": pa, "pq_scan": pq,
            "decode_attention": dense, "flash_attention": flash,
            "decode_attention_partial": partial,
            "paged_chunk_attention": chunk}


#: the decode_sync phase, at serve's pool (8 slots of s_max 1,024 in pages
#: of 16): row 6 is idle (write_mask False) with an idle slot's table of
#: zeros and row 0's position, so its own clamped target is row 0's live
#: target on page 0; row 7 steps at its table's end (pos == M * page ==
#: s_max), which JAX drops.  The dense batch takes the same positions and
#: mask (row 6 masked, row 7 at pos == S_max).
SYNC_POS = [5, 1, 537, 1000, 300, 299, 5, 1024]
SYNC_MASK = [True] * 6 + [False, True]
SYNC_REPS = 20


def _bits(t):
    import torch
    return t.view(torch.int16) if t.element_size() == 2 else t.view(
        torch.int32)


def check_step_sync(name: str, step, cache: dict, written) -> dict:
    """One decode step ``step() -> logits`` that writes ``cache`` in place,
    run eagerly under ``torch.cuda.set_sync_debug_mode("error")`` (a sync
    raises) and then captured in a CUDA graph and replayed from the same
    cache bytes: logits and cache bit-equal to the eager step's.  Every
    byte outside ``written`` (a bool mask over the cache's leading dims:
    the rows JAX writes) keeps its value, and every row inside it
    changes.  Then eager steps and replays timed on CUDA events."""
    import torch
    before = {k: v.clone() for k, v in cache.items()}

    def restore():
        for k, v in cache.items():
            v.copy_(before[k])

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = step()
        eager = eager.clone()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = {k: v.clone() for k, v in cache.items()}
    nd = written.dim()
    for k in cache:
        changed = (_bits(after[k]) != _bits(before[k])).flatten(nd).any(-1)
        if bool((changed & ~written).any()):
            raise AssertionError(f"decode_sync {name}: the step changed "
                                 f"{k} bytes that JAX leaves alone")
        if not bool(changed[written].all()):
            raise AssertionError(f"decode_sync {name}: a kept row of {k} "
                                 "was not written")
    restore()
    graph, out = graph_of(step)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(_bits(out), _bits(eager)):
        raise AssertionError(f"decode_sync {name}: replayed logits differ "
                             "from the eager step's")
    for k in cache:
        if not torch.equal(_bits(cache[k]), _bits(after[k])):
            raise AssertionError(f"decode_sync {name}: the replayed step "
                                 f"left other {k} bytes than the eager one")
    # on CUDA events, launches included: an eager step is bound by them
    eager_ms = cuda_ms(step, SYNC_REPS)
    graph_ms = cuda_ms(graph.replay, SYNC_REPS)
    del graph, out, before, after
    return {"logits": list(eager.shape), "tol": "bit-equal",
            "rows_written": int(written.sum()),
            "cache_bytes": sum(v.numel() * v.element_size()
                               for v in cache.values()),
            "eager_ms": float(np.median(eager_ms)),
            "eager_ms_range": [min(eager_ms), max(eager_ms)],
            "graph_ms": float(np.median(graph_ms)),
            "graph_ms_range": [min(graph_ms), max(graph_ms)],
            "eager_over_graph": float(np.median(eager_ms)
                                      / np.median(graph_ms))}


def phase_decode_sync(engine) -> dict:
    """The decode steps with no host read: Granite-3.0-2B at full width
    (serve's generator) at serve's shape, one ``paged_decode_step``
    through the paged kernel and one dense ``decode_step`` through the
    dense kernel (``check_step_sync``).  Pool and cache are fresh, filled
    with random bytes; the batch drops two rows (``SYNC_POS``)."""
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.models import transformer as tr

    gen = engine.gen
    cfg = gen.cfg
    n, s_max, page = (engine.cfg.decode_slots, engine.cfg.s_max,
                      engine.cfg.page_size)
    m = s_max // page
    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    pos_h = np.asarray(SYNC_POS, np.int32)
    mask_h = np.asarray(SYNC_MASK)
    token = torch.tensor(rng.integers(0, cfg.vocab_size, n, dtype=np.int32),
                         device=dev)
    pos = torch.tensor(pos_h, device=dev)
    mask = torch.tensor(mask_h, device=dev)
    # every row but the idle one owns m pages; row 0's first page is page
    # 0, which the idle row's table of zeros points at
    pages = np.concatenate([[0], 1 + rng.permutation(n * m - 1)])
    tables_h = np.zeros((n, m), np.int32)
    live = [b for b in range(n) if mask_h[b]]
    for i, b in enumerate(live):
        tables_h[b] = pages[i * m:(i + 1) * m]
    if tables_h[6].any() or mask_h[6] or pos_h[6] != pos_h[0] \
            or tables_h[0, 0] != 0 or pos_h[7] != m * page:
        raise AssertionError("decode_sync: the batch lost its drop cases")
    tables = torch.tensor(tables_h, device=dev)

    reset_launches()
    pool = tr.make_paged_cache(cfg, n * m, page, device=dev)
    for v in pool.values():
        v.normal_(generator=g)
    written = torch.zeros((cfg.n_layers, n * m, page), dtype=torch.bool)
    for b in range(n):
        if mask_h[b] and pos_h[b] // page < m:
            written[:, tables_h[b, pos_h[b] // page], pos_h[b] % page] = True
    paged = check_step_sync(
        "paged", lambda: tr.paged_decode_step(
            gen.params, pool, token, pos, tables, cfg,
            attn_impl=paged_decode_attention, write_mask=mask)[0],
        pool, written.to(dev))
    del pool
    torch.cuda.empty_cache()

    cache = tr.make_cache(cfg, n, s_max, device=dev)
    for v in cache.values():
        v.normal_(generator=g)
    written = torch.zeros((cfg.n_layers, n, s_max), dtype=torch.bool)
    for b in range(n):
        if mask_h[b] and pos_h[b] < s_max:
            written[:, b, pos_h[b]] = True
    dense = check_step_sync(
        "dense", lambda: tr.decode_step(
            gen.params, cache, token, pos, cfg, attn_impl=decode_attention,
            write_mask=mask)[0],
        cache, written.to(dev))
    del cache
    torch.cuda.empty_cache()
    launches = read_launches()
    # each step's kernel, once a layer: the checked step, the graph's
    # warm-up and its capture, and the timed eager steps after their own
    # warm-up (a replay calls no wrapper)
    want = cfg.n_layers * (4 + SYNC_REPS)
    for name in ("paged_decode_attention", "decode_attention"):
        if launches[name] != want:
            raise AssertionError(f"decode_sync: {name} launched "
                                 f"{launches[name]} times, not {want}")
    out = {"phase": "decode_sync", "model": cfg.name, "slots": n,
           "s_max": s_max, "page": page, "pos": SYNC_POS,
           "write_mask": SYNC_MASK, "paged": paged, "dense": dense,
           "launches": launches, "nvidia_smi": nvidia_smi_line()}
    emit(out)
    return out


def phase_serve(engine, questions) -> dict:
    import torch
    from repro_torch.serving.server import RAGServer, poisson_offsets

    server = RAGServer(engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    handles = server.replay(questions,
                            poisson_offsets(QPS, len(questions), seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = engine.metrics_snapshot()
    summary = server.summary()
    steps = snap["decode_host_syncs"]            # decode steps that stepped
    searches = snap["histograms"]["stage_seconds:retrieve"]["count"]
    result = {
        "phase": "serve", "wall_s": wall, "n_done": summary["n_done"],
        "qps": summary["qps"], "ttft_s": summary["ttft_s"],
        "ttft_p99_s": summary["ttft_p99_s"], "tpot_s": summary["tpot_s"],
        "tpot_p99_s": summary["tpot_p99_s"],
        "stage_time_s": snap["stage_time_s"],
        "decode_steps": steps, "searches": searches,
        "prefills": snap["prefills"], "pages_shared": snap["pages_shared"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "attn_impl": snap["attn_impl"], "launches": launches,
        "first_output": handles[0].output[:8]}
    emit(result)
    check_served(engine, [h.request for h in handles], questions, snap)
    check_paged_launches(engine, launches, snap, len(questions))
    return result


def check_paged_launches(engine, launches, snap, n_requests: int) -> None:
    """The paged path's kernels over one phase: paged decode once a layer
    a decode step, the dense kernel never, one PQ scan a search (a search
    a request at least), flash on every prefill and query embed."""
    steps = snap["decode_host_syncs"]            # decode steps that stepped
    searches = snap["histograms"]["stage_seconds:retrieve"]["count"]
    n_layers = engine.gen.cfg.n_layers
    if launches["paged_decode_attention"] != n_layers * steps:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {n_layers} x {steps}")
    if launches["decode_attention"] != 0:
        raise AssertionError("the dense kernel ran on the paged path")
    if launches["pq_scan"] != searches or searches < n_requests:
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    check_flash_launches(engine, launches, snap["prefills"], searches)


def check_flash_launches(engine, launches, prefills, searches) -> None:
    """Every prefill forward and every query embed ran the flash kernel:
    one launch per layer each, at least."""
    least = (engine.gen.cfg.n_layers * prefills
             + engine.enc.cfg.n_layers * searches)
    if launches["flash_attention"] < least:
        raise AssertionError(f"flash attention launched "
                             f"{launches['flash_attention']} times, fewer "
                             f"than the {least} layers of {prefills} "
                             f"prefills and {searches} query embeds")


def reset_launches() -> None:
    from repro_torch.kernels import launch_counters
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import launch_counters
    return {name: fn.launches for name, fn in launch_counters().items()}


def check_served(engine, reqs, questions, snap,
                 n_tokens: int = NEW_TOKENS) -> None:
    """Every request DONE with ``n_tokens`` in-vocabulary tokens and
    in-corpus documents, through the CUDA attention kernels."""
    from repro_torch.serving.request import State
    vocab = engine.gen.cfg.vocab_size
    for r in reqs:
        if r.state is not State.DONE or len(r.output) != n_tokens:
            raise AssertionError(f"request {r.rid}: {r.state} with "
                                 f"{len(r.output)} tokens")
        if not all(0 <= t < vocab for t in r.output):
            raise AssertionError(f"request {r.rid}: token out of range")
        if not all(0 <= i < len(engine.corpus) for i in r.retrieved_ids[0]):
            raise AssertionError(f"request {r.rid}: bad retrieved ids")
    if len(reqs) != len(questions):
        raise AssertionError(f"{len(reqs)} of {len(questions)} served")
    if snap["attn_impl"] != "cuda":
        raise AssertionError(f"attn_impl resolved to {snap['attn_impl']}")


TRACE_REPEATS = 3
#: where serve_disagg's trace is written (git-ignored through build/)
TRACE_DIR = ROOT / "build" / "traces"


def check_trace(tracer, reqs, label: str) -> dict:
    """A phase's trace is complete and well formed (``validate_spans``:
    every span ended, one SUBMIT and one TERMINAL a request, retry
    attempts disjoint); returns its span counts by kind."""
    from repro_torch.serving.telemetry import validate_spans
    violations = validate_spans(tracer, reqs)
    if violations or tracer.dropped:
        raise AssertionError(f"{label} trace: {tracer.dropped} spans "
                             f"dropped, violations {violations[:5]}")
    kinds = {}
    for sp in tracer.spans():
        kinds[sp.kind] = kinds.get(sp.kind, 0) + 1
    return {"spans": len(tracer.spans()), "dropped": tracer.dropped,
            "violations": 0, "kinds": kinds}


def latency_crosscheck(tracer, reqs) -> dict:
    """Largest gap between the span-derived TTFT and TPOT and the request
    fields (a span closes a few microseconds after the field it mirrors
    is stamped)."""
    from repro_torch.serving.telemetry import derive_latencies
    err, n = 0.0, 0
    for r in reqs:
        d = derive_latencies(tracer, r)
        if d["ttft"] is None or r.ttft is None:
            continue
        err = max(err, abs(d["ttft"] - r.ttft))
        n += 1
        if d["tpot"] is not None and len(r.output) > 1:
            start = r.t_decode if r.t_decode is not None else r.t_first_token
            err = max(err, abs(d["tpot"]
                               - (r.t_done - start) / (len(r.output) - 1)))
    return {"n": n, "max_err_s": err}


def self_timed_tracer():
    """A ``SpanTracer`` that sums the host time spent inside its own calls
    (outermost calls only: ``terminal`` calls ``close_open`` and
    ``event``).  What the call sites add around a call (the ``enabled``
    test, building an ``attrs`` dict) is not in it."""
    from repro_torch.serving.telemetry import SpanTracer

    class SelfTimedTracer(SpanTracer):
        def __init__(self):
            super().__init__()
            self.self_s, self.calls, self._inside = 0.0, 0, False

    def timed(method):
        def call(self, *args, **kwargs):
            if self._inside:
                return method(self, *args, **kwargs)
            self._inside = True
            t0 = time.perf_counter()
            try:
                return method(self, *args, **kwargs)
            finally:
                self.self_s += time.perf_counter() - t0
                self.calls += 1
                self._inside = False
        return call

    for name in ("event", "record", "begin", "end", "end_kind", "annotate",
                 "close_open", "terminal"):
        setattr(SelfTimedTracer, name, timed(getattr(SpanTracer, name)))
    return SelfTimedTracer()


def phase_trace(engine, questions) -> dict:
    """What span tracing costs on the card and what it records: on serve's
    warm engine, the 16 questions as one closed batch, 3 times with the
    tracer off and 3 times with a fresh ``SpanTracer``, alternating (as
    the reference's ``run_telemetry`` does).  The overhead is the min of
    each arm, reported and not gated (host noise moves walls by tens of
    percent between runs); a seventh, traced run with
    :func:`self_timed_tracer` gives the host time spent inside the
    tracer itself, which that noise does not blur.  Every traced run must
    be well formed, and every run must launch the same kernels and sync
    the host as often: tracing adds no device work and no
    synchronisation."""
    import torch
    from repro_torch.serving.request import Request, State
    from repro_torch.serving.telemetry import SpanTracer, slo_summary

    arms = ("off", "on", "self_timed")
    walls, runs, tokens = ({a: [] for a in arms} for _ in range(3))
    make = {"off": lambda: None, "on": SpanTracer,
            "self_timed": self_timed_tracer}
    traced = None
    for mode in ("off", "on") * TRACE_REPEATS + ("self_timed",):
        tracer = make[mode]()
        engine.set_tracer(tracer)
        batch = [Request(question=q.copy()) for q in questions]
        syncs = (engine.metrics["host_syncs"],
                 engine.metrics["decode_host_syncs"])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.serve(batch)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        runs[mode].append({
            "launches": read_launches(),
            "host_syncs": engine.metrics["host_syncs"] - syncs[0],
            "decode_host_syncs":
                engine.metrics["decode_host_syncs"] - syncs[1]})
        tokens[mode].append([r.output for r in batch])
        bad = [r.rid for r in batch if r.state is not State.DONE
               or len(r.output) != NEW_TOKENS]
        if bad:
            raise AssertionError(f"trace {mode}: requests {bad} not served")
        if tracer is not None:
            counts = check_trace(tracer, batch, f"trace {mode}")
            if mode == "on":
                traced = (tracer, batch, counts)
    engine.set_tracer(None)
    timer = tracer
    tracer, batch, counts = traced
    off, on = min(walls["off"]), min(walls["on"])
    result = {
        "phase": "trace", "requests": len(questions),
        "new_tokens": NEW_TOKENS, "repeats": TRACE_REPEATS,
        "untraced_wall_s": off, "traced_wall_s": on,
        "untraced_range_s": [off, max(walls["off"])],
        "traced_range_s": [on, max(walls["on"])],
        "walls_s": walls, "overhead_frac": on / off - 1.0,
        "tracer_self_s": timer.self_s, "tracer_calls": timer.calls,
        "tracer_us_per_call": timer.self_s / timer.calls * 1e6,
        "tracer_self_frac": timer.self_s / off,
        **counts, "latency_crosscheck": latency_crosscheck(tracer, batch),
        "slo": slo_summary(tracer, batch),
        "runs": runs, "tokens_equal_across_arms":
            all(t == tokens["off"][0] for arm in tokens.values()
                for t in arm)}
    emit(result)
    first = runs["off"][0]
    if any(r != first for arm in runs.values() for r in arm):
        raise AssertionError(f"trace: launches or host syncs differ "
                             f"between runs: {runs}")
    if first["launches"]["paged_decode_attention"] == 0:
        raise AssertionError("trace: the paged kernel did not run")
    return result


def phase_serve_dense(dense, questions) -> dict:
    """The dense pool behind every stage of full_pipeline: rewrite (32
    tokens), fan-out (one 16-token variant), IVF-PQ retrieval of 16
    candidates, rerank to 2, the safety screen, prefill, 32 decode steps."""
    import torch
    from repro_torch.serving.kv_cache import KVCachePool
    from repro_torch.serving.server import RAGServer, poisson_offsets

    questions = questions[:N_DENSE_QUESTIONS]
    server = RAGServer(dense)
    reset_launches()
    t0 = time.perf_counter()
    handles = server.replay(questions,
                            poisson_offsets(DENSE_QPS, len(questions), seed=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = dense.metrics_snapshot()
    summary = server.summary()
    steps = snap["decode_host_syncs"]
    searches = snap["histograms"]["stage_seconds:retrieve"]["count"]
    stage_time = snap["stage_time_s"]
    first = handles[0].request
    result = {
        "phase": "serve_dense", "wall_s": wall, "n_done": summary["n_done"],
        "qps": summary["qps"], "ttft_s": summary["ttft_s"],
        "ttft_p99_s": summary["ttft_p99_s"], "tpot_s": summary["tpot_s"],
        "tpot_p99_s": summary["tpot_p99_s"], "stage_time_s": stage_time,
        "decode_steps": steps, "searches": searches,
        "prefills": snap["prefills"], "cache_copy_bytes":
        snap["cache_copy_bytes"], "attn_impl": snap["attn_impl"],
        "launches": launches, "first_output": first.output[:8],
        "first_rewritten_len": len(first.rewritten),
        "first_variants": len(first.query_variants),
        "first_safety_scores": first.safety_scores}
    emit(result)
    if not isinstance(dense.pool, KVCachePool):
        raise AssertionError("the dense engine is not on the dense pool")
    check_served(dense, [h.request for h in handles], questions, snap)
    missing = [n for n in DENSE_STAGES if not stage_time.get(n, 0) > 0]
    if missing:
        raise AssertionError(f"no stage time for executors {missing}")
    for h in handles:
        r = h.request
        if (len(r.rewritten) != len(r.question) + 32
                or len(r.query_variants) != 2 or not r.safety_scores):
            raise AssertionError(f"request {r.rid}: a stage did not run")
    # the engine's decode steps and the greedy steps of rewrite and fan-out
    # (n - 1 decode steps after the prompt pass for n generated tokens)
    cfg = dense.cfg
    greedy = len(questions) * (cfg.rewrite_tokens - 1 + cfg.fanout_tokens - 1)
    n_layers = dense.gen.cfg.n_layers
    if launches["decode_attention"] != n_layers * (steps + greedy):
        raise AssertionError(f"dense attention launched "
                             f"{launches['decode_attention']} times, "
                             f"expected {n_layers} x ({steps} + {greedy})")
    if launches["paged_decode_attention"] != 0:
        raise AssertionError("the paged kernel ran on the dense path")
    if launches["pq_scan"] != searches or searches < 2 * len(questions):
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    check_flash_launches(dense, launches, snap["prefills"], searches)
    return result


def granite_iterative_schema():
    """The ``iterative`` preset (``repro/configs/rag_pipelines.py``) with
    Granite-3.0-2B's shape in place of its 8B generator."""
    import dataclasses
    from repro_torch.configs import granite_3_2b
    from repro_torch.configs.rag_pipelines import iterative
    from repro_torch.core.ragschema import ModelShape
    c = granite_3_2b.CONFIG
    shape = ModelShape("granite-3.0-2b", c.n_layers, c.d_model, c.n_heads,
                       c.n_kv_heads, c.d_ff, c.vocab_size)
    return dataclasses.replace(iterative(), generative=shape)


def plan_system():
    """One server of 4 H100s, the system serve_plan plans for."""
    from repro_torch.core.hardware import H100_SXM, SystemConfig
    return SystemConfig(n_servers=1, xpus_per_server=4, xpu=H100_SXM)


#: what the JAX package's optimizer plans for that schema on 1 x 4 H100s
#: (``tests/test_torch_plan.py`` holds the port's planner to it)
EXPECTED_PLAN = {"decode_slots": 128, "retrieval_batch": 1, "s_max": 768,
                 "max_new_tokens": 256, "iterative_interval": 64,
                 "retrieval_backend": "ivfpq"}
#: ... and its placement: prefill@2 || decode@1, as engine groups
EXPECTED_GROUPS = (2, 1)
#: the JSONL trace serve_plan writes and serve_disagg and control replay
PLAN_TRACE = ROOT / "build" / "serve_plan_trace.jsonl"


def phase_serve_plan(engine, questions) -> dict:
    """RAGO's workflow on the card: plan ``iterative`` (Granite as its
    generator) for 1 server of 4 H100s, deploy the plan's schedule
    collocated on this one card with ``RAGServer.from_plan`` -- a fresh
    engine that embeds the corpus through the encoder and builds its own
    IVF-PQ index -- and replay 8 questions from a JSONL trace.  The plan's
    128 decode slots, s_max 768 and 256 new tokens stand unclamped."""
    import dataclasses
    import torch
    from repro_torch.core.serving_plan import ServingPlan
    from repro_torch.serving.server import RAGServer, poisson_offsets
    from repro_torch.serving.trace import TraceEntry, save_trace

    questions = questions[:N_PLAN_QUESTIONS]
    plan = ServingPlan.optimize(granite_iterative_schema(), plan_system())
    fields = dataclasses.asdict(plan.engine_config())
    emit({"phase": "serve_plan", "plan": plan.describe(),
          "engine_config": fields})
    wrong = {k: fields[k] for k, v in EXPECTED_PLAN.items() if fields[k] != v}
    if wrong or plan.iter_batch != 1:
        raise AssertionError(f"plan differs from the reference's: {wrong}, "
                             f"iter_batch {plan.iter_batch}")
    trace = PLAN_TRACE
    trace.parent.mkdir(parents=True, exist_ok=True)
    save_trace(trace, [TraceEntry(arrival_s=float(t), question=q)
                       for t, q in zip(poisson_offsets(
                           PLAN_QPS, len(questions), seed=2), questions)])
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = RAGServer.from_plan(plan, engine.gen, engine.enc, engine.corpus,
                                 topology="single", device=engine.device)
    torch.cuda.synchronize()
    t_deploy = time.perf_counter() - t0
    plan_engine = server.engine
    t0 = time.perf_counter()
    handles = server.replay_trace(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = plan_engine.metrics_snapshot()
    summary = server.summary()
    steps = snap["decode_host_syncs"]
    searches = snap["histograms"]["stage_seconds:retrieve"]["count"]
    iterative = [h.request.retrievals_done for h in handles]
    result = {
        "phase": "serve_plan", "deploy_s": t_deploy, "wall_s": wall,
        "n_done": summary["n_done"], "n_submitted": len(handles),
        "qps": summary["qps"], "ttft_s": summary["ttft_s"],
        "ttft_p99_s": summary["ttft_p99_s"], "tpot_s": summary["tpot_s"],
        "tpot_p99_s": summary["tpot_p99_s"],
        "stage_time_s": snap["stage_time_s"], "decode_steps": steps,
        "searches": searches, "retrieval_batches": snap["retrieval_batches"],
        "iterative_retrievals": iterative, "prefills": snap["prefills"],
        "append_calls": snap["append_calls"],
        "append_kernel_calls": snap["append_kernel_calls"],
        "kv_pages": plan_engine.pool.n_pages,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "attn_impl": snap["attn_impl"], "launches": launches,
        "first_output": handles[0].output[:8]}
    emit(result)
    check_served(plan_engine, [h.request for h in handles], questions,
                 snap,
                 n_tokens=EXPECTED_PLAN["max_new_tokens"])
    if min(iterative) < 1:
        raise AssertionError(f"iterative retrievals per request: {iterative}")
    n_layers = plan_engine.gen.cfg.n_layers
    if launches["paged_decode_attention"] != n_layers * steps:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {n_layers} x {steps}")
    if launches["decode_attention"] != 0:
        raise AssertionError("the dense kernel ran on the paged path")
    if launches["pq_scan"] != searches:
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    # every iterative append forward attends through the chunk kernel
    appends = snap["append_calls"]
    if (appends < 1 or snap["append_kernel_calls"] != appends
            or launches["paged_chunk_attention"] != n_layers * appends):
        raise AssertionError(f"paged chunk attention launched "
                             f"{launches['paged_chunk_attention']} times "
                             f"over {snap['append_kernel_calls']} of "
                             f"{appends} append forwards, expected "
                             f"{n_layers} x {appends}")
    # the corpus encode of the fresh engine, then the prefills and embeds
    n_docs = len(plan_engine.corpus)
    corpus_batches = -(-n_docs // 32)
    check_flash_launches(plan_engine, launches, snap["prefills"],
                         searches + corpus_batches)
    return result, plan


#: the handoff's four steps, each timed on the engine that runs it
HANDOFF_STEPS = (("export", "prefill"), ("checksum", "prefill"),
                 ("verify", "decode"), ("import", "decode"))


def handoff_times(cluster) -> dict:
    """Per-request wall time (ms) of each handoff step over a cluster's
    engines: mean and max from the engines' stage histograms.  Export
    ends in its copy to host memory and import's host-to-device copy
    waits for the device, so both read the device's work; the checksums
    are host work."""
    out = {}
    for step, group in HANDOFF_STEPS:
        engines = (cluster.prefill_engines if group == "prefill"
                   else cluster.decode_engines)
        hists = [e.metrics_snapshot().get("histograms", {})
                 .get("stage_seconds:" + step) for e in engines]
        hists = [h for h in hists if h and h["count"]]
        n = sum(h["count"] for h in hists)
        out[step] = {"n": n,
                     "mean_ms": sum(h["sum"] for h in hists) / n * 1e3
                     if n else None,
                     "max_ms": max(h["max"] for h in hists) * 1e3
                     if n else None}
    return out


def phase_serve_disagg(engine, questions, plan) -> dict:
    """serve_plan's own plan deployed as its placement: ``RAGServer.
    from_plan(..., topology="disagg")`` builds ``plan.group_sizes()`` =
    2 prefill engines + 1 decode engine on this card (the first prefill
    engine embeds the corpus and builds the IVF-PQ index, the others
    share them), and the same 8-question trace is replayed, 256 tokens
    each, no deadline.  Every engine runs on this one card and one Python
    thread, so the groups take turns: the phase shows the handoff's cost,
    not what disaggregation buys across chips."""
    import torch
    from repro_torch.serving.server import RAGServer
    from repro_torch.serving.telemetry import (SpanTracer, export_jsonl,
                                               export_perfetto, load_spans)

    questions = questions[:N_PLAN_QUESTIONS]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # serve's and serve_dense's
    t0 = time.perf_counter()
    server = RAGServer.from_plan(plan, engine.gen, engine.enc, engine.corpus,
                                 topology="disagg", device=engine.device)
    torch.cuda.synchronize()
    t_deploy = time.perf_counter() - t0
    cluster = server.cluster
    groups = (len(cluster.prefill_engines), len(cluster.decode_engines))
    if groups != plan.group_sizes() or groups != EXPECTED_GROUPS:
        raise AssertionError(f"disagg groups {groups}, plan "
                             f"{plan.group_sizes()}")
    tracer = SpanTracer()
    server.set_tracer(tracer)
    t0 = time.perf_counter()
    handles = server.replay_trace(PLAN_TRACE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    summary = server.summary()
    group = cluster.group_summary()
    reqs = [h.request for h in handles]
    trace = check_trace(tracer, reqs, "serve_disagg")
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    perfetto, jsonl = TRACE_DIR / "serve_disagg.json", \
        TRACE_DIR / "serve_disagg.jsonl"
    export_perfetto(tracer, perfetto)
    export_jsonl(tracer, jsonl)
    with open(perfetto) as f:
        doc = json.load(f)
    rows = load_spans(jsonl)
    trace.update({
        "perfetto": str(perfetto.relative_to(ROOT)),
        "jsonl": str(jsonl.relative_to(ROOT)),
        "tracks": sum(e["ph"] == "M" and e["name"] == "thread_name"
                      for e in doc["traceEvents"]),
        "perfetto_events": sum(e["ph"] != "M" for e in doc["traceEvents"]),
        "jsonl_spans": len(rows),
        "latency_crosscheck": latency_crosscheck(tracer, reqs),
        "slo": group["slo"]})
    engines = cluster.prefill_engines + cluster.decode_engines
    snaps = [e.metrics_snapshot() for e in engines]
    decode_snap = snaps[-1]
    steps = decode_snap["decode_host_syncs"]
    searches = sum(sn.get("histograms", {}).get("stage_seconds:retrieve",
                                                {}).get("count", 0)
                   for sn in snaps)
    prefills = sum(sn["prefills"] for sn in snaps)
    iterative = [h.request.retrievals_done for h in handles]
    n_handoffs = cluster.metrics["handoffs"]
    result = {
        "phase": "serve_disagg", "deploy_s": t_deploy, "wall_s": wall,
        "groups": {"prefill": groups[0], "decode": groups[1]},
        "n_done": summary["n_done"], "n_submitted": len(handles),
        "qps": summary["qps"], "ttft_s": summary["ttft_s"],
        "ttft_p99_s": summary["ttft_p99_s"], "tpot_s": summary["tpot_s"],
        "tpot_p99_s": summary["tpot_p99_s"],
        "group_summary": {k: group[k] for k in ("prefill", "decode",
                                                "health", "depths")},
        "handoff": {k: group["scheduler"][k] for k in (
            "handoffs", "handoff_bytes", "handoff_bytes_full",
            "handoff_pages", "handoff_pages_shared")},
        "handoff_bytes_per_request": (group["scheduler"]["handoff_bytes_full"]
                                      / n_handoffs if n_handoffs else None),
        "handoff_ms": handoff_times(cluster),
        "stage_time_s": {f"{g}{i}": sn["stage_time_s"] for (g, i), sn in zip(
            [("prefill", i) for i in range(groups[0])]
            + [("decode", i) for i in range(groups[1])], snaps)},
        "decode_steps": steps, "searches": searches, "prefills": prefills,
        "iterative_retrievals": iterative,
        "kv_pages": {"prefill": cluster.prefill_engines[0].pool.n_pages,
                     "decode": cluster.decode_engines[0].pool.n_pages},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "held_before_deploy_bytes": held,
        "attn_impl": [sn["attn_impl"] for sn in snaps],
        "launches": launches, "first_output": handles[0].output[:8],
        "trace": trace}
    emit(result)
    server.set_tracer(None)
    handoff_spans = trace["kinds"].get("HANDOFF", 0)
    metered = [k for k in trace["kinds"] if k in {
        f"STAGE:{step}" for step, _ in HANDOFF_STEPS}]
    if handoff_spans != n_handoffs or metered:
        raise AssertionError(f"serve_disagg trace: {handoff_spans} HANDOFF "
                             f"spans for {n_handoffs} handoffs, handoff "
                             f"steps traced as spans: {metered}")
    if (trace["jsonl_spans"] != trace["spans"]
            or trace["perfetto_events"] != trace["spans"]
            or trace["tracks"] != 1 + len(engines) + len(reqs)):
        raise AssertionError(f"serve_disagg trace files: {trace}")
    if any(sn["attn_impl"] != "cuda" for sn in snaps):
        raise AssertionError("an engine of the cluster is not on the "
                             "CUDA attention kernels")
    check_served(cluster.decode_engines[0], [h.request for h in handles],
                 questions, decode_snap,
                 n_tokens=EXPECTED_PLAN["max_new_tokens"])
    if min(iterative) < 1:
        raise AssertionError(f"iterative retrievals per request: {iterative}")
    if n_handoffs != len(questions) or not group["scheduler"][
            "handoff_bytes"] > 0:
        raise AssertionError(f"{n_handoffs} handoffs for {len(questions)}")
    n_layers = engine.gen.cfg.n_layers
    if launches["paged_decode_attention"] != n_layers * steps:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {n_layers} x {steps}")
    if launches["decode_attention"] != 0:
        raise AssertionError("the dense kernel ran on the paged path")
    if launches["pq_scan"] != searches:
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    # the corpus encode of the first prefill engine, then every engine's
    # prefills and query embeds
    corpus_batches = -(-len(engine.corpus) // 32)
    check_flash_launches(engine, launches, prefills,
                         searches + corpus_batches)
    result["cluster"] = cluster
    return result


def near_tie_margin(gen, prompt, prefix, device) -> float:
    """Top-2 margin of the plain-attention next-token logits after
    ``prompt + prefix`` (teacher forced, one forward)."""
    import torch
    from repro_torch.models import transformer as tr
    toks = np.concatenate([prompt, prefix]).astype(np.int32)[None]
    logits, _ = tr.forward(gen.params, torch.tensor(toks, device=device),
                           gen.cfg)
    top2 = torch.topk(logits[0, -1, :gen.cfg.vocab_size].float(), 2).values
    return float(top2[0] - top2[1])


def check_disagg_parity(cluster, questions) -> dict:
    """4 questions, one at a time (each run to its end before the next),
    through a 1+1 cluster and through a collocated engine with the same
    ``EngineConfig`` (serve_plan's with 8 slots, 32 new tokens and a
    retrieval every 8), both sharing serve_disagg's corpus encode and
    index: the token streams must be equal.  A difference is reported
    with its step and the plain top-2 margin there, and passes only as a
    near tie (margin <= 2 x ``compare_logits``' atol).  Then one slot
    handed off between two pools reads back bit-equal on the card."""
    import dataclasses
    import torch
    from repro_torch.serving.cluster import RAGCluster
    from repro_torch.serving.engine import RAGEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.server import RAGServer

    base = cluster.prefill_engines[0]
    cfg = dataclasses.replace(cluster.cfg, decode_slots=8, max_new_tokens=32,
                              iterative_interval=8)
    shared = dict(db_vectors=base.db_vectors, backend=base.backend.chain[0],
                  device=base.device)
    gen, enc, corpus = base.gen, base.enc, base.corpus
    colo = RAGEngine(gen, enc, corpus, cfg, **shared)
    first = RAGEngine(gen, enc, corpus, dataclasses.replace(cfg,
                                                            decode_slots=1),
                      **shared)
    pair = RAGCluster([first], [RAGEngine(gen, enc, corpus, cfg,
                                          db_vectors=base.db_vectors,
                                          backend=first.backend,
                                          device=base.device)])
    streams = {}
    for name, target in (("collocated", colo), ("disagg", pair)):
        server = RAGServer(target)
        streams[name] = [server.submit(q.copy()).result()
                         for q in questions[:4]]
    out = {"requests": len(streams["disagg"]), "new_tokens": 32,
           "equal": 0, "near_ties": []}
    atol = 0.1                       # compare_logits' tolerance
    for i, (a, b) in enumerate(zip(streams["collocated"],
                                   streams["disagg"])):
        if a.state is not b.state or a.retrieved_ids != b.retrieved_ids:
            raise AssertionError(f"disagg parity request {i}: {a.state} "
                                 f"{a.retrieved_ids} vs {b.state} "
                                 f"{b.retrieved_ids}")
        if a.output == b.output:
            out["equal"] += 1
            continue
        step = next(t for t, (x, y) in enumerate(zip(a.output, b.output))
                    if x != y)
        margin = near_tie_margin(gen, a.prompt, np.asarray(a.output[:step]),
                                 base.device)
        tie = {"request": i, "step": step, "collocated": a.output[step],
               "disagg": b.output[step], "plain_top2_margin": margin}
        out["near_ties"].append(tie)
        if not margin <= 2 * atol:
            emit({"phase": "check", "disagg_parity": out})
            raise AssertionError(f"disagg parity: not a near tie: {tie}")
    if pair.metrics["handoffs"] != 4 or pair.metrics["handoff_corrupt"]:
        raise AssertionError(f"disagg parity handoffs: {pair.describe()}")
    # one handed-off slot, read back page by page from both pools
    req = Request(question=questions[0].copy())
    req.prompt = streams["disagg"][0].prompt
    src, dst = first.pool, pair.decode_engines[0].pool
    s_slot = src.alloc(req.rid)
    first.prefill_compute(req, s_slot)
    kv, length = src.export_slot(s_slot)
    d_slot = dst.alloc(req.rid)
    dst.import_slot(d_slot, kv, length)
    ps = src.page_size
    for j, (a, b) in enumerate(zip(src.page_tables[s_slot],
                                   dst.page_tables[d_slot])):
        n = min(length - j * ps, ps)
        for k in src.cache:
            if not torch.equal(src.cache[k][:, a, :n], dst.cache[k][:, b, :n]):
                raise AssertionError(f"handed-off page {j} ({k}) differs")
    out["readback"] = {"tokens": length,
                       "pages": len(src.page_tables[s_slot]),
                       "bit_equal": True}
    src.release(s_slot)
    dst.release(d_slot)
    return out


def compare_logits(name: str, plain, kern) -> dict:
    """Teacher-forced next-token logits, plain attention vs the kernel:
    allclose, and the same argmax wherever the plain top-2 margin is wide.
    Raises after printing the numbers when either fails."""
    import torch
    if not (torch.isfinite(plain).all() and torch.isfinite(kern).all()):
        raise AssertionError(f"{name}: non-finite logits")
    # the plain path rounds softmax probabilities to bf16 before P@V, the
    # kernel keeps them f32; over 40 bf16 layers that moves logits of
    # magnitude ~|x| by a few bf16 steps (2^-8 relative each)
    atol = rtol = 0.1
    diff = (plain - kern).abs()
    top2 = torch.topk(plain, 2, dim=-1).values
    decided = top2[:, 0] - top2[:, 1] > 2 * atol
    same_argmax = plain.argmax(-1) == kern.argmax(-1)
    result = {"slots": int(plain.shape[0]),
              "logits_max_abs_diff": float(diff.max()),
              "logits_max_abs": float(plain.abs().max()),
              "atol": atol, "rtol": rtol,
              "argmax_equal": int(same_argmax.sum()),
              "argmax_decided": int(decided.sum())}
    if not torch.allclose(kern, plain, rtol=rtol, atol=atol):
        emit({"phase": "check", name: result})
        raise AssertionError(f"{name}: teacher-forced logits differ beyond "
                             f"tolerance")
    if not bool(same_argmax[decided].all()):
        emit({"phase": "check", name: result})
        raise AssertionError(f"{name}: argmax differs where the top-2 "
                             f"margin is wide")
    return result


class PinnedRouting:
    """Inside the block, the second run of the model replays the first
    run's MoE routing (``tr.moe_route``'s gates, experts and aux), so a
    kernel-vs-plain comparison of an MoE model differs by attention
    alone: a bf16 step of difference upstream flips an expert at a router
    near-tie, and a flipped expert moves its row by far more than the
    attention paths differ.  ``summary()`` counts the choices the second
    run would have made otherwise.  A dense model never routes."""

    def __init__(self):
        self.calls: list = []
        self.replay = False
        self.choices = self.flips = 0

    def __enter__(self):
        from repro_torch.models import transformer as tr
        self._tr, self._route = tr, tr.moe_route
        tr.moe_route = self._route_pinned
        return self

    def __exit__(self, *exc):
        self._tr.moe_route = self._route

    def second_run(self) -> None:
        self.replay, self._next = True, 0

    def _route_pinned(self, *args, **kw):
        out = self._route(*args, **kw)
        if not self.replay:
            self.calls.append(out)
            return out
        pinned = self.calls[self._next]
        self._next += 1
        self.choices += out[2].numel()
        self.flips += int((out[2] != pinned[2]).sum())
        return pinned

    def summary(self) -> dict:
        return {"layer_calls": len(self.calls), "choices": self.choices,
                "flipped_unpinned": self.flips}


def teacher_forced_paged(engine, questions,
                         attn=None) -> tuple[dict, np.ndarray]:
    """Admit and prefill one fresh request a decode slot, then one
    teacher-forced decode step of the full-width model over the whole
    pool, plain attention vs the paged kernel, or vs ``attn`` when given
    (``compare_logits``; an MoE model's routing pinned to the plain run's:
    ``PinnedRouting``).  The requests stay in their slots; returns the
    comparison and their prompts' last 512 tokens."""
    import torch
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.models import transformer as tr
    from repro_torch.serving.request import Request, State

    attn = paged_decode_attention if attn is None else attn

    vocab = engine.gen.cfg.vocab_size
    dev = engine.device
    for q in questions[:engine.cfg.decode_slots]:
        engine.queue.append(Request(question=q.copy(),
                                    max_new_tokens=NEW_TOKENS))
    engine.tick()
    slots = sorted(s for s, r in engine.active.items()
                   if r.state is State.DECODE)
    n = engine.pool.n_slots
    tokens = np.zeros(n, np.int32)
    for s in slots:
        tokens[s] = engine.active[s].output[-1]
        engine.pool.prepare_append(s, 1)
    mask = np.zeros(n, bool)
    mask[slots] = True
    args = (torch.tensor(tokens, device=dev), engine.pool.positions(),
            torch.tensor(engine.pool.block_tables(), device=dev))
    logits = {}
    with PinnedRouting() as pin:
        for name, impl in (("plain", None), ("kernel", attn)):
            # the step writes the same K/V rows before attending, so the
            # two runs see the same pool whichever goes first
            lg, _ = tr.paged_decode_step(
                engine.gen.params, engine.pool.cache, *args, engine.gen.cfg,
                attn_impl=impl, write_mask=torch.tensor(mask, device=dev))
            logits[name] = lg[slots, :vocab].float()
            pin.second_run()
    torch.cuda.synchronize()
    prompts = np.stack([engine.active[s].prompt[-512:] for s in slots])
    result = compare_logits("paged", logits["plain"], logits["kernel"])
    if engine.gen.cfg.moe is not None:
        result["routing"] = pin.summary()
    return result, prompts


def teacher_forced_prefill(gen, prompts: np.ndarray):
    """``tr.prefill`` of ``prompts`` (B, S) in one teacher-forced
    full-width forward, through the plain attention and through the flash
    kernel (an MoE model's routing pinned to the first run's:
    ``PinnedRouting``); the logits are each prompt's first token's.
    Returns the comparison and the kernel's logits (B, vocab), f32."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer as tr

    tokens = torch.tensor(prompts, device=DEVICE)
    logits = {}
    with PinnedRouting() as pin:
        for name, attn in (("plain", None), ("kernel", flash_attention)):
            lg, _ = tr.prefill(gen.params, tokens, gen.cfg, attn_impl=attn)
            logits[name] = lg[:, :gen.cfg.vocab_size].float()
            pin.second_run()
    torch.cuda.synchronize()
    result = compare_logits("prefill", logits["plain"], logits["kernel"])
    result["prompt_shape"] = list(prompts.shape)
    if gen.cfg.moe is not None:
        result["routing"] = pin.summary()
    return result, logits["kernel"]


def abort_all(engine, reason: str) -> None:
    for slot in list(engine.active):
        engine.abort_request(engine.active[slot], reason)


def phase_check(engine, dense, questions, cluster) -> dict:
    """One teacher-forced decode step of the full-width model on each pool,
    every slot filled, and one teacher-forced prefill of 8 prompts, plain
    attention vs the kernel; IVF-PQ search with the scan kernel vs the
    plain scan; and disagg parity (``check_disagg_parity``) on
    serve_disagg's corpus encode and index."""
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models import transformer as tr
    from repro_torch.retrieval.ivf_pq import search
    from repro_torch.serving.request import Request

    result = {"phase": "check",
              "tol_reason": "plain attention rounds probabilities to bf16, "
                            "the kernel keeps f32; 40 bf16 layers carry "
                            "that to a few bf16 steps of each logit"}
    vocab = engine.gen.cfg.vocab_size
    dev = engine.device
    result["paged"], _ = teacher_forced_paged(engine, questions)

    # dense: prefill 8 prompts of two retrieved documents + the question
    # straight into the slots (the stage executors ran in serve_dense)
    for q in questions[:dense.cfg.decode_slots]:
        req = Request(question=q.copy(), max_new_tokens=NEW_TOKENS)
        req.candidate_ids = dense.retrieve(q[None], dense.cfg.retrieval_k)[0]
        req.prompt = dense._assemble_prompt(req)
        slot = dense.pool.alloc(req.rid)
        dense._prefill(req, slot)
        dense.active[slot] = req
    slots = sorted(dense.active)
    tokens = np.zeros(dense.pool.n_slots, np.int32)
    for s in slots:
        tokens[s] = dense.active[s].output[-1]
    mask = np.zeros(dense.pool.n_slots, bool)
    mask[slots] = True
    logits = {}
    for name, attn in (("plain", None), ("kernel", decode_attention)):
        lg, _ = tr.decode_step(
            dense.gen.params, dense.pool.cache,
            torch.tensor(tokens, device=dev), dense.pool.positions(),
            dense.gen.cfg, attn_impl=attn,
            write_mask=torch.tensor(mask, device=dev))
        logits[name] = lg[slots, :vocab].float()
    torch.cuda.synchronize()
    result["dense"] = compare_logits("dense", logits["plain"],
                                     logits["kernel"])
    result["dense"]["prompt_lengths"] = [int(dense.pool.lengths[s])
                                         for s in slots]

    # prefill: the same 8 prompts (two retrieved documents + the question,
    # cut to 512 tokens) in one teacher-forced full-width forward, through
    # the flash kernel and through the "ref" attention; the logits of each
    # prompt's last position are its first token's
    prompts = np.stack([dense.active[s].prompt[-512:] for s in slots])
    result["prefill"], _ = teacher_forced_prefill(dense.gen, prompts)

    # retrieval: the scan kernel and the plain scan give the same search
    backend = engine.backend.chain[0]
    qv = engine._embed_batched(np.stack(questions))
    d_k, i_k = search(backend.index, qv, nprobe=backend.nprobe, k=8,
                      use_kernel=True)
    d_p, i_p = search(backend.index, qv, nprobe=backend.nprobe, k=8,
                      use_kernel=False)
    if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
        raise AssertionError("IVF-PQ search differs with the scan kernel")
    result["search_ids_equal"] = True
    for eng in (engine, dense):
        abort_all(eng, "smoke check done")
    result["disagg_parity"] = check_disagg_parity(cluster, questions)
    emit(result)
    return result


#: the chaos phase: 4 questions, 16 new tokens, 8 decode slots, 2+2
N_CHAOS_QUESTIONS = 4
CHAOS_TOKENS = 16


def chaos_cluster(base, cfg, injector):
    """A 2-prefill + 2-decode cluster on the card sharing ``base``'s corpus
    encode and IVF-PQ index (its own fallback chain, so the injector
    reaches no other cluster)."""
    import dataclasses
    from repro_torch.serving.cluster import RAGCluster
    from repro_torch.serving.engine import RAGEngine

    gen, enc, corpus = base.gen, base.enc, base.corpus
    one = dataclasses.replace(cfg, decode_slots=1)
    first = RAGEngine(gen, enc, corpus, one, db_vectors=base.db_vectors,
                      backend=base.backend.chain[0], device=base.device)
    shared = dict(db_vectors=first.db_vectors, backend=first.backend,
                  device=base.device)
    return RAGCluster(
        [first, RAGEngine(gen, enc, corpus, one, **shared)],
        [RAGEngine(gen, enc, corpus, cfg, **shared) for _ in range(2)],
        injector=injector, retry_backoff=0.001)


def check_no_leaks(cluster, engines=None) -> None:
    """Nothing waiting anywhere, every slot free and every page's
    refcount zero (free, or cached as a prefix page)."""
    if cluster.queue or cluster.handoff or cluster.retrying:
        raise AssertionError("requests left waiting in the cluster")
    for eng in engines or cluster.prefill_engines + cluster.decode_engines:
        pool = eng.pool
        if (eng.active or eng.pending_retrievals or eng.prefilling
                or sorted(pool.free) != list(range(pool.n_slots))
                or int(np.sum(pool.ref)) != 0):
            raise AssertionError(f"engine leaks: {len(pool.free)} of "
                                 f"{pool.n_slots} slots free, "
                                 f"{int(np.sum(pool.ref))} page references")


def phase_chaos(disagg_cluster, questions) -> dict:
    """Every ``CHAOS_SCHEDULES`` entry on a 2+2 cluster at Granite width
    on the card (8 decode slots, s_max 768, 16 new tokens, 4 questions),
    beside an unfaulted run of the same questions.  Each must end with
    every request in exactly one terminal state, free every slot and
    page, give every DONE request that was not degraded and retrieved
    the unfaulted run's documents the unfaulted run's tokens (retry
    parity), and fire each point of its schedule as often as the
    schedule says.  A request whose first retrieval was served by the
    exact-scan fallback (``retrieval_timeout``) may have other documents,
    and so other tokens; those are counted and must not outnumber the
    backend's fallbacks."""
    import dataclasses
    from repro_torch.serving.faults import (CHAOS_SCHEDULES, FaultInjector,
                                            FaultPlan)
    from repro_torch.serving.request import TERMINAL_STATES, State
    from repro_torch.serving.server import RAGServer
    from repro_torch.serving.telemetry import SpanTracer

    base = disagg_cluster.prefill_engines[0]
    cfg = dataclasses.replace(disagg_cluster.cfg, decode_slots=8,
                              max_new_tokens=CHAOS_TOKENS)
    questions = questions[:N_CHAOS_QUESTIONS]

    def run(injector, name):
        """One traced run; its trace must be well formed, every firing a
        FAULT event and every retry a RETRY event."""
        cluster = chaos_cluster(base, cfg, injector)
        tracer = SpanTracer()
        server = RAGServer(cluster, tracer=tracer)
        handles = [server.submit(q.copy()) for q in questions]
        server.run_until_idle(max_steps=5000)
        reqs = [h.request for h in handles]
        trace = check_trace(tracer, reqs, f"chaos {name}")
        kinds = trace["kinds"]
        fired = len(injector.log) if injector is not None else 0
        faults = sum(n for k, n in kinds.items() if k.startswith("FAULT:"))
        retries = sum(r.retries for r in reqs)
        if faults != fired or kinds.get("RETRY", 0) != retries:
            raise AssertionError(f"chaos {name} trace: {faults} FAULT "
                                 f"events for {fired} firings, "
                                 f"{kinds.get('RETRY', 0)} RETRY events "
                                 f"for {retries} retries")
        return cluster, reqs, trace

    t0 = time.perf_counter()
    cluster, ref, _ = run(None, "unfaulted")
    if any(r.state is not State.DONE for r in ref):
        raise AssertionError("unfaulted chaos run: not every request DONE")
    check_no_leaks(cluster)
    out = {"phase": "chaos", "questions": len(questions),
           "new_tokens": CHAOS_TOKENS, "decode_slots": cfg.decode_slots,
           "unfaulted_s": time.perf_counter() - t0, "schedules": {}}
    for name, schedule in sorted(CHAOS_SCHEDULES.items()):
        t0 = time.perf_counter()
        inj = FaultInjector(FaultPlan.from_schedule(schedule, seed=7))
        cluster, reqs, trace = run(inj, name)
        for r in reqs:
            if (r.state not in TERMINAL_STATES
                    or sum(s in TERMINAL_STATES
                           for s in r.state_history) != 1):
                raise AssertionError(f"chaos {name}: request {r.rid} "
                                     f"{r.state_history}")
        check_no_leaks(cluster)
        fired = {}
        for point, *_ in inj.log:
            fired[point] = fired.get(point, 0) + 1
        want = {}
        for spec in schedule:
            want[spec["point"]] = want.get(spec["point"], 0) + \
                spec.get("count", 1)
        if fired != want:
            raise AssertionError(f"chaos {name}: fired {fired}, schedule "
                                 f"{want}")
        other_docs = 0
        for r, u in zip(reqs, ref):
            if r.state is not State.DONE or r.degraded:
                continue
            if r.retrieved_ids != u.retrieved_ids:
                other_docs += 1
                continue
            if r.output != u.output:
                raise AssertionError(f"chaos {name}: request {r.rid} lost "
                                     f"retry parity")
        scheduler = cluster.group_summary()["scheduler"]
        if other_docs > scheduler["retrieval_fallbacks"]:
            raise AssertionError(f"chaos {name}: {other_docs} requests "
                                 f"retrieved other documents with "
                                 f"{scheduler['retrieval_fallbacks']} "
                                 f"fallbacks")
        out["schedules"][name] = {
            "seconds": time.perf_counter() - t0, "fired": fired,
            "states": [r.state.value for r in reqs],
            "degraded": sum(r.degraded for r in reqs),
            "other_documents": other_docs,
            "parity_checked": sum(r.state is State.DONE and not r.degraded
                                  and r.retrieved_ids == u.retrieved_ids
                                  for r, u in zip(reqs, ref)),
            "counters": {k: v for k, v in scheduler.items() if v},
            "trace": {k: trace[k] for k in ("spans", "dropped",
                                            "violations")},
            "trace_events": {k: n for k, n in trace["kinds"].items()
                             if k.startswith("FAULT:")
                             or k in ("RETRY", "MIGRATE")}}
    emit(out)
    if not any(s["trace_events"].get("RETRY")
               for s in out["schedules"].values()):
        raise AssertionError("chaos: no schedule traced a RETRY")
    return out


def phase_control(disagg, questions, plan) -> dict:
    """A ``ClusterController`` on serve_disagg's cluster: the H100 spec
    calibrated from what the cluster measured (``measured_specs``) beside
    the nominal one, the plan ``ServingPlan.optimize`` gives on it, then
    a make-before-break resize during a fresh replay of the 8-question
    trace: ``resize(2, 2)`` after the 3rd arrival (a decode engine built
    on the cluster's corpus encode and index), ``resize(2, 1)`` after the
    6th, which drains the newest decode engine and migrates its
    requests."""
    import dataclasses
    import torch
    from repro_torch.core.serving_plan import ServingPlan
    from repro_torch.serving.controller import ClusterController
    from repro_torch.serving.engine import RAGEngine
    from repro_torch.serving.request import State
    from repro_torch.serving.server import RAGServer
    from repro_torch.serving.telemetry import SpanTracer

    cluster = disagg["cluster"]
    base = cluster.prefill_engines[0]
    schema, system = granite_iterative_schema(), plan_system()

    def factory(group):
        cfg = cluster.cfg if group == "decode" else \
            dataclasses.replace(cluster.cfg, decode_slots=1)
        return RAGEngine(base.gen, base.enc, base.corpus, cfg,
                         db_vectors=base.db_vectors, backend=base.backend,
                         device=base.device)

    server = RAGServer.from_cluster(cluster)
    tracer = SpanTracer()
    server.set_tracer(tracer)
    ctl = ClusterController(server, schema, system, plan,
                            engine_factory=factory)
    xpu, host, record = ctl.measured_specs()
    replan = ServingPlan.optimize(schema, system, xpu=xpu, host=host,
                                  **plan.engine_overrides)
    nominal = system.xpu
    specs = {
        "calibrated": record,
        "nominal": {"flops_eff": nominal.flops_eff,
                    "mem_eff": nominal.mem_eff,
                    "decode_bytes_per_s": nominal.eff_mem_bw,
                    "host_scan_bytes_per_s_per_core":
                        system.host.pq_scan_bw_per_core},
        "measured": {"flops_eff": xpu.flops_eff, "mem_eff": xpu.mem_eff,
                     "decode_bytes_per_s": xpu.eff_mem_bw,
                     "host_scan_bytes_per_s_per_core":
                         host.pq_scan_bw_per_core if host else None}}
    emit({"phase": "control", "specs": specs,
          "plan": plan.describe(), "replan": replan.describe(),
          "replan_groups": replan.group_sizes(),
          "predicted_ttft_s": {"plan": plan.predicted.get("ttft"),
                               "replan": replan.predicted.get("ttft")},
          "measured_ttft_s": {"mean": disagg["ttft_s"],
                              "p99": disagg["ttft_p99_s"]}})
    steps = [(3, (2, 2)), (6, (2, 1))]         # (after arrival, target)
    resized = []

    def hook(srv):
        while (len(resized) < len(steps)
               and len(srv.handles) >= steps[len(resized)][0]):
            at, target = steps[len(resized)]
            resized.append({"after_arrival": at, "target": target,
                            **ctl.resize(*target)})
    server.add_step_hook(hook)
    added0 = cluster.metrics["engines_added"]
    removed0 = cluster.metrics["engines_removed"]
    t0 = time.perf_counter()
    handles = server.replay_trace(PLAN_TRACE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = server.summary()
    m = cluster.metrics
    trace = check_trace(tracer, [h.request for h in handles], "control")
    control = {k: n for k, n in trace["kinds"].items()
               if k.startswith("CONTROL:")}
    trace["migrate_events"] = trace["kinds"].get("MIGRATE", 0)
    migrated = sum(h.request.migrations for h in handles)
    result = {"phase": "control", "wall_s": wall,
              "n_done": summary["n_done"], "n_submitted": len(handles),
              "ttft_s": summary["ttft_s"], "tpot_s": summary["tpot_s"],
              "resizes": resized,
              "engines_added": m["engines_added"] - added0,
              "engines_removed": m["engines_removed"] - removed0,
              "requests_migrated": m["requests_migrated"],
              "retired": [(g, eid) for g, eid, _ in cluster.retired],
              "groups": {"prefill": len(cluster.prefill_engines),
                         "decode": len(cluster.decode_engines)},
              "trace": {**{k: trace[k] for k in ("spans", "dropped",
                                                 "violations",
                                                 "migrate_events")},
                        "control_events": control,
                        "controller_events": len(ctl.events)}}
    emit(result)
    server.set_tracer(None)
    if sum(control.values()) != len(ctl.events) or \
            trace["migrate_events"] != migrated or not migrated:
        raise AssertionError(f"control trace: {control} for "
                             f"{len(ctl.events)} controller events, "
                             f"{trace['migrate_events']} MIGRATE events for "
                             f"{migrated} migrations")
    if [h.state for h in handles] != [State.DONE] * len(handles) or \
            len(handles) != N_PLAN_QUESTIONS:
        raise AssertionError(f"control: {[h.state for h in handles]}")
    if len(resized) != 2 or result["engines_added"] != 1 or \
            result["engines_removed"] != 1:
        raise AssertionError(f"control resized {resized}, added "
                             f"{result['engines_added']}, removed "
                             f"{result['engines_removed']}")
    retired = [e for g, _eid, e in cluster.retired if g == "decode"]
    if len(retired) != 1:
        raise AssertionError(f"retired engines: {cluster.retired}")
    check_no_leaks(cluster, cluster.prefill_engines
                   + cluster.decode_engines + retired)
    result["specs"] = specs
    return result


#: the reference registry's other dense LMs, each served at full width in
#: bf16 and int8 (the models phase), one after the other
MODEL_ARCHS = ("minitron-8b", "chatglm3-6b")
N_MODEL_QUESTIONS = 4


def check_model(arch_id: str, enc, corpus, db_vectors, backend,
                questions) -> dict:
    """One reference LM at full width: random bf16 weights from a seed, a
    teacher-forced decode step and prefill (kernel vs plain attention);
    ``quantize_for_serving``, the largest gap between the bf16 and int8
    next-token distributions of those prefills (printed, not gated), and
    4 questions served through a paged engine on the int8 weights.  Both
    engines share serve's encoder, corpus embedding and IVF-PQ index."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Component, RAGEngine
    from repro_torch.serving.request import Request

    cfg = get_arch(arch_id).config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = Component(cfg, tr.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0),
        dtype=torch.bfloat16, device=DEVICE))
    torch.cuda.synchronize()
    result = {"phase": "models", "model": arch_id,
              "init_s": time.perf_counter() - t0,
              "params": sum(t.numel() for t in gen.params.buffers()),
              "param_bytes": buffer_bytes(gen.params)}

    def engine_for(g):
        return RAGEngine(g, enc, corpus, serve_engine_config(),
                         db_vectors=db_vectors, backend=backend,
                         device=DEVICE)

    engine = engine_for(gen)
    result["paged"], prompts = teacher_forced_paged(engine, questions)
    result["prefill"], bf16_logits = teacher_forced_prefill(gen, prompts)
    abort_all(engine, "models check done")
    del engine
    t0 = time.perf_counter()
    qgen = Component(cfg, tr.quantize_for_serving(gen.params))
    torch.cuda.synchronize()
    result["quantize_s"] = time.perf_counter() - t0
    result["int8_param_bytes"] = buffer_bytes(qgen.params)
    del gen
    _, int8_logits = teacher_forced_prefill(qgen, prompts)
    gap = (torch.softmax(bf16_logits, -1)
           - torch.softmax(int8_logits, -1)).abs()
    result["int8_softmax_max_gap"] = float(gap.max())
    result["int8_argmax_equal"] = int(
        (bf16_logits.argmax(-1) == int8_logits.argmax(-1)).sum())

    qengine = engine_for(qgen)
    reqs = [Request(question=q.copy(), max_new_tokens=NEW_TOKENS)
            for q in questions[:N_MODEL_QUESTIONS]]
    reset_launches()
    t0 = time.perf_counter()
    qengine.serve(reqs)
    torch.cuda.synchronize()
    launches = read_launches()
    snap = qengine.metrics_snapshot()
    result.update(
        int8_serve_wall_s=time.perf_counter() - t0,
        int8_decode_steps=snap["decode_host_syncs"],
        int8_prefills=snap["prefills"],
        int8_stage_time_s=snap["stage_time_s"], int8_launches=launches,
        int8_first_output=reqs[0].output[:8],
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit(result)
    check_served(qengine, reqs, questions[:N_MODEL_QUESTIONS], snap)
    check_paged_launches(qengine, launches, snap, len(reqs))
    return result


def phase_models(enc, corpus, db_vectors, backend, questions) -> dict:
    """``check_model`` for each of MODEL_ARCHS, each freed before the
    next."""
    out = {}
    for arch_id in MODEL_ARCHS:
        out[arch_id] = check_model(arch_id, enc, corpus, db_vectors, backend,
                                   questions)
        release_device_memory()
    return out


def buffer_bytes(module) -> int:
    return sum(t.numel() * t.element_size() for t in module.buffers())


# ---------------------------------------------------------------------------
# train: the LM trainer at Granite-3.0-2B's full width
# ---------------------------------------------------------------------------

#: the train phase's model (the launcher's default arch)
TRAIN_ARCH = "granite-3-2b"
#: batch x sequence of the timed steps, which recompute each layer (remat)
TRAIN_TIMED_SHAPE = (4, 2048)
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 5
#: the launcher's optimizer settings (``launch/train.py``)
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 10}


def train_batch(vocab: int, batch: int, seq: int, n: int, seed: int = 0):
    """``lm_batches`` on the card: a list of ``{"tokens", "labels"}``."""
    import torch
    from repro_torch.data.synthetic import lm_batches
    return [{k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
            for b in lm_batches(vocab, batch, seq, n, seed=seed)]


def check_train_parity(card: str) -> dict:
    """One ``make_train_step`` step of a 2-layer slice of Granite at full
    width (0.33 B parameters), float32 compute with TF32 off, on the card
    and on the CPU from the same weights and batch: loss, gradient norm
    and the updated parameters."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.training.optim import AdamWConfig, lr_schedule
    from repro_torch.training.pytree import leaves, tree_map
    from repro_torch.training.train_loop import init_state, make_train_step

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).config, n_layers=2)
    host = tr.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu").tree()
    opt = AdamWConfig(**TRAIN_OPT)

    def loss_fn(p, b):
        return tr.loss_fn(p, b["tokens"], b["labels"], cfg,
                          compute_dtype=torch.float32)
    step = make_train_step(loss_fn, opt)
    # a copy: the CPU state's leaves are views of ``host``, updated in place
    card_state = init_state(tree_map(lambda t: t.to(DEVICE, copy=True), host))
    cpu_state = init_state(host)
    batch = train_batch(cfg.vocab_size, 2, 64, 1)[0]
    t0 = time.perf_counter()
    _, m_card = step(card_state, batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, m_cpu = step(cpu_state, {k: v.cpu() for k, v in batch.items()})
    t_cpu = time.perf_counter() - t0
    lr1 = float(lr_schedule(torch.tensor(1, dtype=torch.int32), opt))
    worst, n_off, n = 0.0, 0, 0
    with torch.no_grad():
        for a, b in zip(leaves(card_state["params"]),
                        leaves(cpu_state["params"])):
            d = (a.cpu() - b).abs()
            worst = max(worst, float(d.max()))
            n_off += int((d > 1e-3 * lr1).sum())
            n += d.numel()
    result = {
        "phase": "train", "part": "parity", "card": card,
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "vocab": cfg.vocab_size}, "params": n,
        "batch": [2, 64], "compute_dtype": "float32",
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss": [float(m_card["loss"]), float(m_cpu["loss"])],
        "grad_norm": [float(m_card["grad_norm"]), float(m_cpu["grad_norm"])],
        "param_max_abs_diff": worst, "lr_step1": lr1,
        "params_off_by_more_than_1e-3_lr": n_off,
        "step_s": {"card": t_card, "cpu": t_cpu},
        "tol": {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4,
                "param_max_abs": 2 * lr1, "param_off_share": 1e-3},
        "tol_reason": "float32 on both, summed in other orders: the loss "
                      "to 1e-5 and the norm to 1e-4 relative; AdamW's first "
                      "step moves a parameter by lr * g / (|g| + eps), +-lr "
                      "for any gradient well above eps, so a gradient near "
                      "0 can step the other way on the other device (at "
                      "most 2 lr apart); such parameters must stay rare"}
    emit(result)
    tol = result["tol"]
    if abs(result["loss"][0] - result["loss"][1]) > tol["loss_rtol"] * abs(
            result["loss"][1]):
        raise AssertionError("train step: the card's loss differs from the "
                             "CPU's")
    if abs(result["grad_norm"][0] - result["grad_norm"][1]) > tol[
            "grad_norm_rtol"] * result["grad_norm"][1]:
        raise AssertionError("train step: the card's gradient norm differs "
                             "from the CPU's")
    if worst > tol["param_max_abs"] or n_off > tol["param_off_share"] * n:
        raise AssertionError("train step: the card's updated parameters "
                             "differ from the CPU's")
    return result


def train_loss(params, batch, cfg, **kw) -> float:
    import torch
    from repro_torch.models import transformer as tr
    with torch.no_grad():
        return float(tr.loss_fn(params, batch["tokens"], batch["labels"],
                                cfg, **kw))


def check_train_launcher(card: str):
    """Granite-3.0-2B at full width through ``launch.train.main`` at its
    defaults (batch 4, seq 64, 40 layers, bf16 compute, f32 state): one
    step, then the loss on the same batch must be lower; then the default
    5 steps, every loss finite.  Returns the result and the trained state
    (the timed part goes on from it)."""
    import math
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.training.pytree import leaves

    cfg = get_arch(TRAIN_ARCH).config
    argv = ["--arch", TRAIN_ARCH, "--device", DEVICE]
    reset_launches()
    t0 = time.perf_counter()
    state, hist1 = launch_train.main(argv + ["--steps", "1"])
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    first = train_batch(cfg.vocab_size, 4, 64, 1)[0]    # the launcher's
    after = train_loss(state["params"], first, cfg)
    del state
    release_device_memory()
    t0 = time.perf_counter()
    state, hist = launch_train.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    result = {
        "phase": "train", "part": "launcher", "card": card,
        "model": TRAIN_ARCH,
        "params": sum(t.numel() for t in leaves(state["params"])),
        "one_step_s": t_one, "loss_before": hist1[0]["loss"],
        "loss_after_one_step": after,
        "losses": [h["loss"] for h in hist],
        "step_s": [h["time"] for h in hist],
        "wall_s": time.perf_counter() - t0, "kernel_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    if not all(math.isfinite(x) for x in result["losses"] + [after]):
        raise AssertionError("train launcher: a loss is not finite")
    if not after < result["loss_before"]:
        raise AssertionError("train launcher: one step did not lower the "
                             "loss on its batch")
    if any(launches.values()):
        raise AssertionError("train launcher: the training path launched "
                             "a serving kernel")
    return result, state


def time_train_step(state, card: str, profile: bool = False) -> dict:
    """The step at batch 4 x seq 2,048 with every layer recomputed
    (remat): forward+backward and AdamW on CUDA events, medians of
    TRAIN_TIMED_STEPS after TRAIN_WARMUP_STEPS; tokens/s, model FLOPs
    (6 N a token plus causal attention) against the bf16 peak, AdamW
    against its bytes bound (28 B a parameter), peak memory.  Beside it,
    forward+backward at the launcher's shape with the stacked weights
    indexed layer by layer (``layer_params``) against ``unstack_layers``;
    with ``profile``, one more step traced (``profile_train_step``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.training.optim import AdamWConfig, adamw_update
    from repro_torch.training.pytree import leaves
    from repro_torch.training.train_loop import value_and_grad

    cfg = get_arch(TRAIN_ARCH).config
    params, opt_state = state["params"], state["opt"]
    n_params = sum(t.numel() for t in leaves(params))
    B, S = TRAIN_TIMED_SHAPE
    opt = AdamWConfig(**TRAIN_OPT)
    grad_fn = value_and_grad(lambda p, b: tr.loss_fn(
        p, b["tokens"], b["labels"], cfg, remat=True))
    batches = train_batch(cfg.vocab_size, B, S,
                          TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb_ms, adam_ms, wall_ms, losses = [], [], [], []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        loss, grads = grad_fn(params, b)
        ev[1].record()
        adamw_update(grads, opt_state, params, opt)
        ev[2].record()
        ev[2].synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        fb_ms.append(ev[0].elapsed_time(ev[1]))
        adam_ms.append(ev[1].elapsed_time(ev[2]))
        losses.append(float(loss))
        del grads
    peak = torch.cuda.max_memory_allocated()
    med = lambda xs: float(np.median(xs[TRAIN_WARMUP_STEPS:]))  # noqa: E731
    step_ms = med(wall_ms)
    tokens = B * S
    attn_flops = 6 * B * cfg.n_heads * cfg.d_head * S * S * cfg.n_layers
    model_flops = 6 * n_params * tokens + attn_flops
    adam_bound_ms = 28 * n_params / HBM_BYTES_PER_S * 1e3
    result = {
        "phase": "train", "part": "timed", "card": card,
        "model": TRAIN_ARCH, "params": n_params, "batch": [B, S],
        "remat": True, "compute_dtype": "bfloat16",
        "warmup_steps": TRAIN_WARMUP_STEPS, "timed_steps": TRAIN_TIMED_STEPS,
        "losses": losses, "fwd_bwd_ms": fb_ms, "adamw_ms": adam_ms,
        "step_wall_ms": wall_ms,
        "median_fwd_bwd_ms": med(fb_ms), "median_adamw_ms": med(adam_ms),
        "median_step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "model_flops": model_flops, "attention_flops": attn_flops,
        "model_flops_share_of_989_tflops": model_flops / (step_ms / 1e3)
        / PEAK_OPS_PER_S["bfloat16"],
        "adamw_bound_ms": adam_bound_ms,
        "adamw_over_bound": med(adam_ms) / adam_bound_ms,
        "peak_mem_bytes": peak}
    result["stack_grad"] = time_stack_grad(params, cfg)
    if profile:
        result["profile"] = profile_train_step(
            grad_fn, params, opt_state, opt, batches[-1])
    emit(result)
    return result


def profile_train_step(grad_fn, params, opt_state, opt, batch) -> dict:
    """Where the timed step's time goes (``--profile``): one step traced
    by ``torch.profiler``, its device time by kernel against the host
    clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.optim import adamw_update

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = grad_fn(params, batch)
        adamw_update(grads, opt_state, params, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del grads
    return {"wall_ms_per_step": wall * 1e3,
            **kernel_breakdown(prof, wall, 1, "step", top_k=12)}


def time_stack_grad(params, cfg, reps: int = 2) -> dict:
    """Forward+backward at the launcher's shape (4 x 64, bf16) with each
    stack unbound once (``unstack_layers``, the port's way) and indexed
    layer by layer (each layer's gradient a zero-filled stack-sized
    tensor), alternating, ``reps`` times each after a warm-up."""
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.training.train_loop import value_and_grad

    b = train_batch(cfg.vocab_size, 4, 64, 1)[0]
    grad_fn = value_and_grad(lambda p, bb: tr.loss_fn(
        p, bb["tokens"], bb["labels"], cfg))
    unbound = tr.unstack_layers

    def per_layer(layers, n_layers):
        return [tr.layer_params(layers, i) for i in range(n_layers)]

    def timed(split):
        tr.unstack_layers = split
        try:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, grads = grad_fn(params, b)
            ev[1].record()
            ev[1].synchronize()
            del grads
            return ev[0].elapsed_time(ev[1])
        finally:
            tr.unstack_layers = unbound
    timed(unbound)
    timed(per_layer)
    out = {"unbind_ms": [], "per_layer_select_ms": []}
    for _ in range(reps):
        out["unbind_ms"].append(timed(unbound))
        out["per_layer_select_ms"].append(timed(per_layer))
        out["per_layer_select_ms"].append(timed(per_layer))
        out["unbind_ms"].append(timed(unbound))
    return out


def check_train_compression(state, card: str) -> dict:
    """``with_error_feedback`` over Granite's full-width gradients (one
    batch at the launcher's shape; the moments are dropped first to make
    room): each leaf within the int8 error bound of
    ``test_int8_compression_error_bound`` (amax / 127 + 1e-6), and the
    time of a call from a zero residual and of one carrying it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.training import compression as comp
    from repro_torch.training.pytree import leaves
    from repro_torch.training.train_loop import value_and_grad

    cfg = get_arch(TRAIN_ARCH).config
    state.pop("opt")
    release_device_memory()
    params = state["params"]
    b = train_batch(cfg.vocab_size, 4, 64, 1, seed=2)[0]
    _, grads = value_and_grad(lambda p, bb: tr.loss_fn(
        p, bb["tokens"], bb["labels"], cfg))(params, b)
    residual = comp.init_residual(params)
    times = []
    for i in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sent, new_residual = comp.with_error_feedback(grads, residual)
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
        if i == 0:
            worst = 0.0
            for g, r in zip(leaves(grads), leaves(new_residual)):
                bound_ = float(g.abs().max()) / 127.0 + 1e-6
                worst = max(worst, float(r.abs().max()) / bound_)
        del sent
        residual = new_residual
    n_bytes = sum(g.numel() for g in leaves(grads))
    result = {"phase": "train", "part": "compression", "card": card,
              "leaves": len(leaves(grads)), "elements": n_bytes,
              "error_over_bound_max": worst, "ms": times,
              "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    if worst > 1.0:
        raise AssertionError("with_error_feedback: a leaf exceeds the int8 "
                             "error bound")
    return result


def check_train_restart(card: str) -> dict:
    """On the reduced Granite config on the card: 10 steps uninterrupted;
    then 6 steps with a checkpoint every 3 (under ``build/``), ended there
    and resumed to 10 from a fresh state.  The resumed run starts at step
    7, and the two histories agree."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_loop import (TrainConfig, init_state,
                                                 train)

    cfg = get_arch(TRAIN_ARCH).reduced()
    ckpt_dir = ROOT / "build" / "train_restart"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    batches = train_batch(cfg.vocab_size, 4, 64, 10, seed=3)
    opt = AdamWConfig(**TRAIN_OPT)

    def fresh():
        return init_state(tr.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(0),
            device=DEVICE))

    def loss_fn(p, b):
        return tr.loss_fn(p, b["tokens"], b["labels"], cfg)
    _, full = train(fresh(), batches, loss_fn, TrainConfig(steps=10), opt)
    _, first = train(fresh(), batches[:6], loss_fn,
                     TrainConfig(steps=6, ckpt_dir=str(ckpt_dir),
                                 ckpt_every=3), opt)
    saved = ck.latest_step(ckpt_dir)
    _, resumed = train(fresh(), batches[6:], loss_fn,
                       TrainConfig(steps=10, ckpt_dir=str(ckpt_dir),
                                   ckpt_every=3), opt)
    got = first + resumed
    rel = {key: max(abs(a[key] - b[key]) / abs(b[key])
                    for a, b in zip(got, full))
           for key in ("loss", "grad_norm")}
    result = {"phase": "train", "part": "restart", "card": card,
              "model": cfg.name, "saved_step": saved,
              "resumed_steps": [h["step"] for h in resumed],
              "losses": [h["loss"] for h in got],
              "uninterrupted_losses": [h["loss"] for h in full],
              "max_rel_diff": rel, "tol_rtol": 1e-3,
              "tol_reason": "bf16 compute; the card's embedding backward "
                            "accumulates with atomics, so a rerun may round "
                            "a gradient otherwise"}
    emit(result)
    if saved != 6 or result["resumed_steps"] != [7, 8, 9, 10]:
        raise AssertionError("train restart: did not resume at step 7")
    if len(got) != 10 or max(rel.values()) > result["tol_rtol"]:
        raise AssertionError("train restart: the resumed history differs "
                             "from the uninterrupted one")
    return result


def phase_train(profile: bool = False) -> dict:
    """The LM trainer on the emptied card: card-vs-CPU parity of one step
    on a 2-layer full-width slice, Granite-3.0-2B at full width through
    ``launch.train.main`` (descent, finite losses), the timed step,
    gradient compression, then the restart check on the reduced config.
    No serving kernel runs on this path."""
    card = nvidia_smi_line()
    out = {"parity": check_train_parity(card)}
    release_device_memory()
    out["launcher"], state = check_train_launcher(card)
    out["timed"] = time_train_step(state, card, profile)
    out["compression"] = check_train_compression(state, card)
    del state
    release_device_memory()
    out["restart"] = check_train_restart(card)
    return out


# ---------------------------------------------------------------------------
# recsys_gnn: the recsys and GNN families at the published widths
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("dlrm-rm2", "two-tower-retrieval", "xdeepfm", "mind")
_BB_LOGITS = ("the in-batch softmax's (B, B) float32 logits are 17.2 GB at "
              "the reference's 65,536, and autograd keeps several")
#: each model's train batch on one 80 GB card, and the reason for a cut
#: below the reference's ``train_batch`` shape (65,536)
RECSYS_TRAIN = {
    "dlrm-rm2": (65536, None),
    "two-tower-retrieval": (32768, _BB_LOGITS),
    "xdeepfm": (16384, "the CIN's (B, 200, 39, 10) float32 intermediate is "
                       "20.4 GB a layer at the reference's 65,536"),
    "mind": (32768, _BB_LOGITS),
}
#: rows of one xDeepFM forward at serve_bulk and score: each row is scored
#: on its own, so the chunks give the reference's numbers
XDEEPFM_CHUNK = 16384
RECSYS_CHECK_BATCH = 512
RECSYS_STEPS = 5               # one step, then 4 more on the same batch
TOP_K = 100
N_CANDIDATES = 1_000_000
#: card vs CPU, float32 on both with TF32 off: each tensor within this
#: share of its largest magnitude, the loss to LOSS_RTOL; PNA's float32
#: forward to PNA_PARITY_TOL (the std aggregator's cancellation and the
#: attenuation scaler's 1 / 1e-5 amplify rounding) and its gradients in
#: float64 to PNA_GRAD64_TOL (see ``pna_parity``; the same amplification
#: of float64's rounding measured 1.5e-14 to 6.1e-10 on an H100)
RECSYS_PARITY_TOL = 1e-4
PNA_PARITY_TOL = 1e-3
LOSS_RTOL = 1e-5
PNA_GRAD64_TOL = 1e-7
#: the PNA shapes run on the card (ogb_products needs the partitioned PNA)
PNA_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


def _to(batch: dict, device) -> dict:
    import torch
    return {k: (torch.as_tensor(v).to(device) if isinstance(
        v, (np.ndarray, torch.Tensor)) else v) for k, v in batch.items()}


def recsys_ops(arch_id: str) -> dict:
    """The reference's step programs for ``arch_id`` (``launch/steps.py``'s
    ``_RECSYS``): init, loss, the serving forward, and the score's top-100
    (``score`` returns ``(scores or None, values, ids)``)."""
    from repro_torch.models import recsys as rec
    from repro_torch.retrieval.exact import top_k

    def chunked(fn, rows):
        import torch
        n = rows.shape[0]
        return torch.cat([fn(rows[i:i + XDEEPFM_CHUNK])
                          for i in range(0, n, XDEEPFM_CHUNK)])

    if arch_id == "dlrm-rm2":
        def score(p, b, c):
            s = rec.dlrm_score_candidates(p, b["dense"], b["sparse"],
                                          b["candidates"], c)
            return (s,) + tuple(top_k(s, TOP_K))
        return {"init": rec.dlrm_init, "loss": rec.dlrm_loss,
                "fwd": lambda p, b, c: rec.dlrm_forward(
                    p, b["dense"], b["sparse"], c), "score": score}
    if arch_id == "two-tower-retrieval":
        return {"init": rec.two_tower_init, "loss": rec.two_tower_loss,
                "fwd": lambda p, b, c: rec.user_tower(
                    p, b["user_ids"], b["hist_ids"], c),
                "score": lambda p, b, c: (None,) + tuple(
                    rec.two_tower_score_candidates(
                        p, b["user_ids"], b["hist_ids"], b["candidates"], c,
                        TOP_K))}
    if arch_id == "xdeepfm":
        def score(p, b, c):
            # xdeepfm_score_candidates a chunk of candidates at a time
            s = chunked(lambda cand: rec.xdeepfm_score_candidates(
                p, b["sparse"], cand, c), b["candidates"])
            return (s,) + tuple(top_k(s, TOP_K))
        return {"init": rec.xdeepfm_init, "loss": rec.xdeepfm_loss,
                "fwd": lambda p, b, c: chunked(
                    lambda r: rec.xdeepfm_forward(p, r, c), b["sparse"]),
                "score": score}
    return {"init": rec.mind_init, "loss": rec.mind_loss,
            "fwd": lambda p, b, c: rec.mind_interests(p, b["hist_ids"], c),
            "score": lambda p, b, c: (None,) + tuple(
                rec.mind_score_candidates(p, b["hist_ids"], b["candidates"],
                                          c, TOP_K))}


def recsys_inputs(arch_id: str, cfg, b: int, seed: int) -> dict:
    """A batch of numpy arrays: ``recsys_batches`` for DLRM and xDeepFM
    (with labels), uniform ids for two-tower (with a log-Q correction) and
    MIND."""
    from repro_torch.data.synthetic import recsys_batches
    rng = np.random.default_rng(seed)
    if arch_id in ("dlrm-rm2", "xdeepfm"):
        return next(recsys_batches(cfg.n_sparse, cfg.vocab_per_field, b, 1,
                                   n_dense=getattr(cfg, "n_dense", 0),
                                   seed=seed))
    hist = rng.integers(0, cfg.n_items, (b, cfg.hist_len)).astype(np.int32)
    items = rng.integers(0, cfg.n_items, b).astype(np.int32)
    if arch_id == "mind":
        return {"hist_ids": hist, "item_ids": items}
    return {"user_ids": rng.integers(0, cfg.n_users, b).astype(np.int32),
            "hist_ids": hist, "item_ids": items,
            "log_q": np.log(rng.random(b) * 1e-3 + 1e-6).astype(np.float32)}


def touched_rows(arch_id: str, cfg, batch: dict) -> dict:
    """Per table leaf, the rows a batch reads (global ids into the stacked
    table)."""
    if arch_id in ("dlrm-rm2", "xdeepfm"):
        rows = (batch["sparse"].astype(np.int64)
                + cfg.tables().offsets[:-1][None, :]).reshape(-1)
        return ({"tables": rows} if arch_id == "dlrm-rm2"
                else {"tables": rows, "linear": rows})
    items = np.concatenate([batch["hist_ids"].reshape(-1),
                            batch["item_ids"]]).astype(np.int64)
    if arch_id == "mind":
        return {"item_table": items}
    return {"item_table": items,
            "user_table": batch["user_ids"].astype(np.int64)}


def cuda_ms(fn, reps: int = 3) -> list[float]:
    """``fn()``'s time on CUDA events, ``reps`` times after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return times


def scaled_err(got, want) -> float:
    """max |got - want| over max |want| (``want`` on the CPU)."""
    got = got.detach().cpu().float()
    want = want.detach().float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def row_scaled_err(got, want) -> float:
    """The largest, over rows (dim 0), of max |got - want| over the row's
    max |want|; a row of zeros in ``want`` must be zeros in ``got``
    (infinite error otherwise)."""
    import torch
    diff = (got.float() - want.float()).abs().flatten(1).amax(1)
    mag = want.float().abs().flatten(1).amax(1)
    err = torch.where(mag > 0, diff / torch.clamp(mag, min=1e-30),
                      torch.where(diff > 0, torch.inf, 0.0))
    return float(err.max())


def relu_recorder():
    """A ``TorchFunctionMode`` whose ``seen`` keeps a host copy of the input
    of every ``torch.relu`` call made under it, in call order."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Record(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.relu:
                self.seen.append(args[0].detach().cpu())
            return func(*args, **(kwargs or {}))
    return Record()


def kink_rows(card: list, cpu: list, n_rows: int,
              tol: float) -> tuple[np.ndarray, float]:
    """Rows of a batch at which an MLP's ReLU gate differs between the
    card's forward and the CPU's (``relu_recorder`` of each), and the
    largest such pre-activation over its layer's largest.  A gate flips
    only at a pre-activation within rounding of 0 -- the card's embedding
    bags sum with atomics, so its rounding changes from run to run -- and
    there the gradient jumps, so such a row's gradients cannot agree.  A
    flip farther from 0 than ``tol`` of the layer raises."""
    rows = np.zeros(n_rows, bool)
    worst = 0.0
    for zc, zh in zip(card, cpu):
        if zh.dim() < 2 or zh.shape[0] != n_rows:
            continue
        flip = (zc > 0) != (zh > 0)
        if not flip.any():
            continue
        margin = max(float(zc.abs()[flip].max()),
                     float(zh.abs()[flip].max())) / float(zh.abs().max())
        worst = max(worst, margin)
        if margin > tol:
            raise AssertionError("a ReLU gate differs between the card and "
                                 "the CPU away from 0")
        rows |= flip.reshape(n_rows, -1).any(dim=1).numpy()
    return rows, worst


def grad_parity(params_card, host, loss_fn, fwd_fn, batch: dict,
                tables: dict) -> dict:
    """The loss, ``fwd_fn``'s output and every gradient leaf of one batch on
    the card against the CPU from the same weights (``host``, a copy).
    A leaf in ``tables`` (name -> rows the batch reads) is compared at
    those rows, and every other row of its card gradient must be exactly
    0; every other leaf whole.  ``relu_inputs`` holds each side's ReLU
    inputs of the differentiated forward (``relu_recorder``)."""
    import torch
    from repro_torch.training.pytree import leaves, tree_map
    from repro_torch.training.train_loop import value_and_grad

    res = {}
    for side, params, dev in (("card", params_card, DEVICE),
                              ("cpu", host, "cpu")):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        b = _to(batch, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fwd_fn(p, b)
        record = relu_recorder()
        with record:
            loss, grads = value_and_grad(loss_fn)(p, b)
        if dev != "cpu":
            torch.cuda.synchronize()
        res[side] = (out, loss, grads, time.perf_counter() - t0, record.seen)
    out_c, loss_c, g_c, t_card, z_c = res["card"]
    out_h, loss_h, g_h, t_cpu, z_h = res["cpu"]
    worst, untouched = {}, {}
    for key in sorted(g_c):
        if key in tables:
            rows = torch.from_numpy(np.unique(tables[key]))
            worst[key] = scaled_err(g_c[key][rows.to(DEVICE)], g_h[key][rows])
            keep = torch.ones(g_c[key].shape[0], dtype=torch.bool,
                              device=DEVICE)
            keep[rows.to(DEVICE)] = False
            untouched[key] = float((g_c[key].abs().amax(dim=1)
                                    * keep).max())
        else:
            worst[key] = max(scaled_err(a, b) for a, b in zip(
                leaves(g_c[key]), leaves(g_h[key])))
    return {"loss": [float(loss_c), float(loss_h)],
            "output_err": scaled_err(out_c, out_h),
            "grad_err": worst, "untouched_rows_max_abs_grad": untouched,
            "touched_rows": {k: int(np.unique(v).size)
                             for k, v in tables.items()},
            "seconds": {"card": t_card, "cpu": t_cpu},
            "relu_inputs": (z_c, z_h)}


def check_parity(name: str, res: dict, tol: float) -> None:
    loss_c, loss_h = res["loss"]
    if abs(loss_c - loss_h) > LOSS_RTOL * abs(loss_h):
        raise AssertionError(f"{name}: the card's loss differs from the CPU's")
    if not res["output_err"] <= tol:
        raise AssertionError(f"{name}: the card's output differs from the "
                             f"CPU's")
    bad = {k: v for k, v in res["grad_err"].items() if not v <= tol}
    if bad:
        raise AssertionError(f"{name}: gradients differ from the CPU's: {bad}")
    if any(res["untouched_rows_max_abs_grad"].values()):
        raise AssertionError(f"{name}: a row no id reads has a gradient")


def check_score_parity(score_card, params_host, user: dict, cand, cfg,
                       ops) -> dict:
    """The 1,000,000-candidate scores and their top-100 on the CPU from the
    same weights against the card's: every score within the parity
    tolerance, and a top-100 id that differs only where the two ids'
    CPU scores are within twice the largest score difference (a near
    tie)."""
    import torch
    s_card, _, i_card = score_card
    b = _to(dict(user, candidates=cand), "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        s_cpu, _, i_cpu = ops["score"](params_host, b, cfg)
    t_cpu = time.perf_counter() - t0
    s_card, i_card = s_card.cpu(), i_card.cpu()
    diff = float((s_card - s_cpu).abs().max())
    scale = float(s_cpu.abs().max())
    moved = (i_card != i_cpu).nonzero().flatten().tolist()
    gaps = [float((s_cpu[i_card[j]] - s_cpu[i_cpu[j]]).abs()) for j in moved]
    out = {"score_max_abs_diff": diff, "score_scale": scale,
           "top100_positions_differing": moved, "their_cpu_gaps": gaps,
           "near_tie_margin": 2 * diff, "cpu_score_s": t_cpu}
    if diff > RECSYS_PARITY_TOL * scale:
        raise AssertionError("score: the card's scores differ from the "
                             "CPU's")
    if any(g > 2 * diff for g in gaps):
        raise AssertionError("score: a top-100 id differs from the CPU's "
                             "away from a near tie")
    return out


def train_steps(loss_fn, params, batch: dict, n_rows: int, cell) -> dict:
    """``RECSYS_STEPS`` steps of ``cell`` (a train ``CellProgram`` of
    ``launch/steps.py`` on a 1 x 1 mesh, AdamW at ``AdamWConfig()`` as in
    the reference's step programs) on one batch: forward+backward and
    AdamW on CUDA events, split by the step's ``mark``; the loss on the
    batch after the first step; the wall time of each step; rows/s from
    the median of steps 2..5."""
    import math
    import torch
    from repro_torch.training.optim import init_opt_state
    from repro_torch.training.pytree import leaves

    state = {"params": params, "opt": init_opt_state(params)}
    fb, adam, wall, losses = [], [], [], []
    after = None
    for i in range(RECSYS_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        state, metrics = cell.fn(state, batch, mark=ev[1].record)
        ev[2].record()
        ev[2].synchronize()
        fb.append(ev[0].elapsed_time(ev[1]))
        adam.append(ev[1].elapsed_time(ev[2]))
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        if i == 0:
            with torch.no_grad():
                after = float(loss_fn(state["params"], batch))
    n_params = sum(t.numel() for t in leaves(state["params"]))
    med = lambda xs: float(np.median(xs[1:]))  # noqa: E731
    out = {"cell": cell.name, "losses": losses, "loss_before": losses[0],
           "loss_after_one_step": after, "step_wall_ms": wall,
           "median_step_ms": med(wall),
           "rows_per_s": n_rows / med(wall) * 1e3,
           "fwd_bwd_ms": fb, "adamw_ms": adam, "median_fwd_bwd_ms": med(fb),
           "median_adamw_ms": med(adam),
           "adamw_bound_ms": 28 * n_params / HBM_BYTES_PER_S * 1e3}
    if not all(math.isfinite(x) for x in losses + [after]):
        raise AssertionError("train: a loss is not finite")
    if not after < losses[0]:
        raise AssertionError(f"train: one step did not lower the loss on "
                             f"its batch: {losses[0]} -> {after}")
    return out


def emit_reduced(what: str, reason: str) -> None:
    emit({"phase": "recsys_gnn", "reduced": what, "reason": reason})


def check_recsys(arch_id: str, card: str) -> dict:
    """One recsys model at its published widths on the card: weights drawn
    there from a generator; card vs CPU at batch 512 (loss, the serving
    output, every gradient, touched table rows, untouched rows 0); the
    1,000,000-candidate top-100 (held against the CPU for DLRM-RM2);
    serve_p99 and serve_bulk forwards; RECSYS_STEPS AdamW steps at the
    train batch."""
    import torch
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_recsys_cell
    from repro_torch.models.common import count_params
    from repro_torch.training.pytree import leaves, tree_map

    arch = get_arch(arch_id)
    cfg = arch.config
    ops = recsys_ops(arch_id)
    release_device_memory()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = ops["init"](gen, cfg, device=DEVICE)
    n_params = count_params(params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))

    def loss_fn(p, b):
        return ops["loss"](p, b, cfg)

    check = recsys_inputs(arch_id, cfg, RECSYS_CHECK_BATCH, seed=1)
    host = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    rows = np.arange(RECSYS_CHECK_BATCH)
    for _ in range(3):
        parity = grad_parity(params, host, loss_fn,
                             lambda p, b: ops["fwd"](p, b, cfg), check,
                             touched_rows(arch_id, cfg, check))
        kinks, margin = kink_rows(*parity.pop("relu_inputs"), rows.size,
                                  RECSYS_PARITY_TOL)
        if not kinks.any():
            break
        # drop the rows at a kink and compare again
        emit({"phase": "recsys_gnn", "model": arch_id,
              "kink_rows": rows[kinks].tolist(), "kink_margin": margin})
        rows = rows[~kinks]
        check = {k: v[~kinks] for k, v in check.items()}
    else:
        raise AssertionError(f"{arch_id}: ReLU gates flip in every try")
    parity["rows_compared"] = int(rows.size)
    check_parity(arch_id, parity, RECSYS_PARITY_TOL)

    vocab = getattr(cfg, "vocab_per_field", getattr(cfg, "n_items", 0))
    cand = np.random.default_rng(4).permutation(vocab)[:N_CANDIDATES].astype(
        np.int32)
    user = recsys_inputs(arch_id, cfg, 1, seed=5)
    score_in = _to(dict(user, candidates=cand), DEVICE)
    with torch.no_grad():
        score = ops["score"](params, score_in, cfg)
        score_ms = cuda_ms(lambda: ops["score"](params, score_in, cfg))
    out = {"phase": "recsys_gnn", "model": arch_id, "card": card,
           "params": n_params, "param_bytes": n_bytes,
           "parity_batch": RECSYS_CHECK_BATCH, "parity": parity,
           "parity_tol": {"of_largest_magnitude": RECSYS_PARITY_TOL,
                          "loss_rtol": LOSS_RTOL},
           "score": {"candidates": N_CANDIDATES, "top_k": TOP_K,
                     "ms": score_ms, "top_ids": score[2].tolist(),
                     "top_values": score[1].tolist()}}
    if arch_id == "dlrm-rm2":
        out["score"]["cpu_parity"] = check_score_parity(
            score, host, user, cand, cfg, ops)
    del host, score
    serve = {}
    for shape in ("serve_p99", "serve_bulk"):
        n = arch.shape(shape).dims["batch"]
        b = _to(recsys_inputs(arch_id, cfg, n, seed=6), DEVICE)
        with torch.no_grad():
            ms = cuda_ms(lambda: ops["fwd"](params, b, cfg))
        serve[shape] = {"batch": n, "ms": ms,
                        "rows_per_s": n / float(np.median(ms)) * 1e3}
        del b
    out["serve"] = serve
    b_train, cut = RECSYS_TRAIN[arch_id]
    if cut:
        emit_reduced(f"{arch_id}:train_batch 65536 -> {b_train}", cut)
    torch.cuda.synchronize()
    train_batch = _to(recsys_inputs(arch_id, cfg, b_train, seed=2), DEVICE)
    shape = arch.shape("train_batch")
    cell = build_recsys_cell(arch, dataclasses.replace(
        shape, dims=dict(shape.dims, batch=b_train)), make_host_mesh())
    out["train"] = dict(batch=b_train, **train_steps(
        loss_fn, params, train_batch, b_train, cell))
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def synthetic_graph(n_nodes: int, n_edges: int, seed: int) -> np.ndarray:
    """(2, n_edges) int32 edges (src, dst) over ``n_nodes``: in-degrees
    multinomial over the nodes, sources uniform; stored dst-major (CSR
    order), as a graph store keeps it."""
    rng = np.random.default_rng(seed)
    deg = rng.multinomial(n_edges, np.full(n_nodes, 1.0 / n_nodes))
    dst = np.repeat(np.arange(n_nodes, dtype=np.int32), deg)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    return np.stack([src, dst])


def pna_batch(shape, cfg, gen) -> tuple[dict, dict]:
    """The padded batch of a PNA shape on the card (the reference's
    ``gnn_batch_abstract`` layout: node and edge arrays padded to a
    multiple of 512, padded edges masked and pointing at the last node,
    pad nodes with zero features and ``label_mask`` 0 -- molecule: pad
    nodes in graph ``n_graphs``), and what was measured making it."""
    import torch
    d = shape.dims
    rng = np.random.default_rng(7)
    info = {}
    if shape.name == "molecule":
        g, nn, ne = d["batch"], d["n_nodes"], d["n_edges"]
        base = np.repeat(np.arange(g) * nn, ne)
        edges = np.stack([base + rng.integers(0, nn, g * ne),
                          base + rng.integers(0, nn, g * ne)])
        n_real, n_pad = g * nn, _pad512(g * nn)
        gids = np.full(n_pad, g, np.int32)
        gids[:n_real] = np.repeat(np.arange(g), nn)
        extra = {"graph_ids": gids,
                 "y": rng.normal(size=g).astype(np.float32), "n_graphs": g}
        e_pad = _pad512(g * ne)
    elif shape.name == "minibatch_lg":
        from repro_torch.data.synthetic import graph_neighbor_sampler
        t0 = time.perf_counter()
        graph = synthetic_graph(d["n_nodes"], d["n_edges"], seed=8)
        info["graph_s"] = time.perf_counter() - t0
        sampler = graph_neighbor_sampler(graph, d["n_nodes"], d["fanout"],
                                         d["batch_nodes"], seed=9)
        t0 = time.perf_counter()
        sub = next(sampler)
        info["csr_build_and_first_sample_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        next(sampler)
        info["sample_s"] = time.perf_counter() - t0
        del graph, sampler
        b, (f1, f2) = d["batch_nodes"], d["fanout"]
        n_real, n_pad = sub["nodes"].size, _pad512(b * (1 + f1 + f1 * f2))
        edges = sub["edges"].astype(np.int64)
        e_pad = _pad512(b * f1 + b * f1 * f2)
        label_mask = np.zeros(n_pad, np.float32)
        label_mask[sub["targets"]] = 1.0
        extra = {"label_mask": label_mask}
        info.update(subgraph_nodes=int(n_real),
                    subgraph_edges=int(edges.shape[1]))
    else:
        n_real, n_pad = d["n_nodes"], _pad512(d["n_nodes"])
        edges = rng.integers(0, n_real, (2, d["n_edges"]))
        e_pad = _pad512(d["n_edges"])
        label_mask = np.zeros(n_pad, np.float32)
        label_mask[:n_real] = 1.0
        extra = {"label_mask": label_mask}
    n_e = edges.shape[1]
    if n_e < e_pad and n_real >= n_pad:
        raise AssertionError(f"{shape.name}: no pad node for the padded "
                             f"edges")
    full = np.full((2, e_pad), n_pad - 1, np.int32)
    full[:, :n_e] = edges
    mask = np.zeros(e_pad, np.float32)
    mask[:n_e] = 1.0
    x = torch.randn((n_pad, cfg.d_feat), generator=gen, device=DEVICE)
    x[n_real:] = 0.0
    batch = {"x": x, "edges": full, "edge_mask": mask, **extra}
    if not cfg.graph_level:
        batch["labels"] = rng.integers(0, cfg.n_classes, n_pad).astype(
            np.int32)
    info.update(nodes=int(n_real), nodes_padded=int(n_pad), edges=int(n_e),
                edges_padded=int(e_pad))
    return _to(batch, DEVICE), info


def pna_parity(params, loss_fn, fwd, batch: dict, gen) -> dict:
    """PNA on the card against the CPU from the same weights and graph.
    float32: the forward and the loss within PNA_PARITY_TOL and LOSS_RTOL;
    the gradients are printed beside it with the ReLU gates that differ,
    ungated.  The std aggregator's ``relu(sq / deg - mean**2)`` sits at
    its kink wherever a node's messages nearly agree, and message
    pre-activations come within rounding of 0, so one ulp of rounding
    flips gates and moves single gradient entries by up to ~1e-3 of their
    leaf (measured on the CPU).  So the gradients are held in float64,
    where no gate flips: ``value_and_grad`` of a fixed random projection
    of the forward's output (every op's backward, the f32 loss cast
    aside), within PNA_GRAD64_TOL."""
    import torch
    from repro_torch.training.pytree import leaves, tree_map
    from repro_torch.training.train_loop import value_and_grad

    host = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    b_cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in batch.items()}
    f32 = {}
    for side, p, b in (("card", params, batch), ("cpu", host, b_cpu)):
        pp = tree_map(lambda t: t.detach().requires_grad_(), p)
        with torch.no_grad():
            o = fwd(pp, b)
        record = relu_recorder()
        with record:
            loss, grads = value_and_grad(loss_fn)(pp, b)
        f32[side] = (o, float(loss), grads, record.seen)
    (o_c, l_c, g_c, z_c), (o_h, l_h, g_h, z_h) = f32["card"], f32["cpu"]
    res = {"float32": {
        "loss": [l_c, l_h], "output_err": scaled_err(o_c, o_h),
        "grad_err_ungated": {k: max(scaled_err(a, b) for a, b in zip(
            leaves(g_c[k]), leaves(g_h[k]))) for k in sorted(g_c)},
        "relu_gates_differing": [int(((a > 0) != (b > 0)).sum())
                                 for a, b in zip(z_c, z_h)]},
        "tol": {"float32_output_of_largest_magnitude": PNA_PARITY_TOL,
                "loss_rtol": LOSS_RTOL,
                "float64_grads_of_largest_magnitude": PNA_GRAD64_TOL}}
    if abs(l_c - l_h) > LOSS_RTOL * abs(l_h):
        raise AssertionError("pna: the card's loss differs from the CPU's")
    if not res["float32"]["output_err"] <= PNA_PARITY_TOL:
        raise AssertionError("pna: the card's output differs from the CPU's")
    del f32, g_c, g_h
    n_out = o_h.shape
    cot = torch.randn(n_out, generator=gen, device=DEVICE,
                      dtype=torch.float64)

    def project(p, b):
        return torch.sum(fwd(p, b) * cot.to(b["x"].device))

    def f64(b):
        return {k: (v.double() if isinstance(v, torch.Tensor)
                    and v.is_floating_point() else v) for k, v in b.items()}
    res["float64"] = grad_parity(
        tree_map(lambda t: t.double(), params),
        tree_map(lambda t: t.double(), host), project, fwd, f64(b_cpu), {})
    z_c, z_h = res["float64"].pop("relu_inputs")
    res["float64"]["relu_gates_differing"] = [
        int(((a > 0) != (b > 0)).sum()) for a, b in zip(z_c, z_h)]
    check_parity("pna (float64)", res["float64"], PNA_GRAD64_TOL)
    return res


def check_pna(shape_name: str, card: str) -> dict:
    """PNA at one shape's config: weights drawn on the card; at
    full_graph_sm the forward, loss and every gradient against the CPU;
    the forward's time; RECSYS_STEPS AdamW steps on the batch."""
    import torch
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_gnn_cell
    from repro_torch.models import gnn
    from repro_torch.models.common import count_params
    from repro_torch.training.pytree import leaves

    shape = pna_cfg.ARCH.shape(shape_name)
    cfg = pna_cfg.config_for_shape(shape)
    release_device_memory()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = gnn.init_params(gen, cfg, device=DEVICE)
    batch, info = pna_batch(shape, cfg, gen)

    def loss_fn(p, b):
        return gnn.loss_fn(p, b, cfg)

    def fwd(p, b):
        return gnn.forward(p, b["x"], b["edges"], cfg, b["edge_mask"],
                           b.get("graph_ids"), b.get("n_graphs"))

    out = {"phase": "recsys_gnn", "model": f"pna:{shape_name}",
           "card": card, "params": count_params(params),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params)),
           "config": {"d_feat": cfg.d_feat, "n_classes": cfg.n_classes,
                      "graph_level": cfg.graph_level}, "batch": info}
    if shape_name == "full_graph_sm":
        out["parity"] = pna_parity(params, loss_fn, fwd, batch, gen)
        out["partitioned"] = check_partitioned_one_shard(params, cfg, batch,
                                                         fwd)
    with torch.no_grad():
        out["forward_ms"] = cuda_ms(lambda: fwd(params, batch))
    # every PNA shape trains through its cell program (launch/steps.py)
    cell = build_gnn_cell(pna_cfg.ARCH, shape, make_host_mesh())
    out["train"] = train_steps(loss_fn, params, batch, info["nodes"], cell)
    out["train"]["nodes_per_s"] = out["train"].pop("rows_per_s")
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def check_partitioned_one_shard(params, cfg, batch: dict, fwd) -> dict:
    """The dst-partitioned PNA forward on one shard (a 1 x 1 mesh: no
    collective) against ``gnn.forward`` on the card, within the
    reference's 1e-4 of the output's largest magnitude."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.gnn_partitioned import forward_partitioned
    with torch.no_grad():
        part = forward_partitioned(params, batch["x"], batch["edges"], cfg,
                                   make_host_mesh(),
                                   ("data", "model"), batch["edge_mask"])
        want = fwd(params, batch)
    err = scaled_err(part, want.cpu())
    if not err <= 1e-4:
        raise AssertionError(f"partitioned PNA on one shard: {err} > 1e-4")
    return {"err_of_largest_magnitude": err, "tol": 1e-4}


def phase_recsys_gnn() -> dict:
    """The recsys and GNN families on the emptied card, float32 with TF32
    off: DLRM-RM2, two-tower, xDeepFM and MIND at their published widths,
    then PNA at full_graph_sm, molecule and minibatch_lg; no serving
    kernel runs on this path (launches are checked to stay 0)."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("recsys_gnn: TF32 matmuls are on")
    card = nvidia_smi_line()
    reset_launches()
    out = {}
    for arch_id in RECSYS_ARCHS:
        out[arch_id] = check_recsys(arch_id, card)
    emit_reduced("pna:ogb_products not run",
                 "its (E, 150) float32 message input alone is 37 GB a "
                 "layer (61.9 M edges); it needs the partitioned PNA over "
                 "a mesh")
    for shape_name in PNA_SHAPES:
        out[f"pna:{shape_name}"] = check_pna(shape_name, card)
    launches = read_launches()
    emit({"phase": "recsys_gnn", "kernel_launches": launches})
    if any(launches.values()):
        raise AssertionError("recsys_gnn: the path launched a serving "
                             "kernel")
    return out


# ---------------------------------------------------------------------------
# distributed: split-K decode on the card
# ---------------------------------------------------------------------------

#: one Granite-width layer's split-K decode over two ranks on the card:
#: (B, S, H, H_kv, D), bf16 (1.07 GB of K/V, half on each rank)
SPLITK_SHAPE = (16, 32768, 32, 8, 64)
SPLITK_RANKS = 2
SPLITK_REPS = 10
#: the decode variant cell at Granite's full width on a 1 x 1 mesh
VARIANT_DIMS = {"seq_len": 4096, "global_batch": 8}
VARIANT_POS = [4095, 4000, 3000, 2048, 1024, 100, 1, 0]
VARIANT_SOFTMAX_BOUND = 0.1   # the reference's int8-KV softmax bound
#: the variant step's logits vs the same step given plain f32 attention:
#: one bf16 step apart in a layer's attention grows to 0.20 over 40
#: random-weight layers (H100, PR 22)
VARIANT_LOGIT_TOL = 0.5
#: split-K output vs a whole-cache version, of each row's largest
#: magnitude: one bf16 step of that value is 2^-8 to 2^-7 of it
SPLITK_ROW_TOL = 2e-2


def splitk_lengths(s: int) -> list[int]:
    """Lengths that leave the second rank's shard empty, partly and
    wholly visible, and one past S (clamps)."""
    h = s // SPLITK_RANKS
    return [0, 1, 100, h - 1, h, h + 1, h + 4097, s - 1, s, s + 1, 7000,
            12345, 20000, 30000, 2, h + 2]


def splitk_rank(rank: int, world: int, port: int, out: str, shape: tuple,
                device: str) -> None:
    """One rank of the two-rank split-K decode on one card over gloo: its
    half of the sequence, the partial kernel, the combine's all-reduces;
    rank 0 also runs the rank-free kernel and the plain version over the
    whole cache.  Writes ``splitk_rank{rank}.json`` under ``out``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.decode_attn import (
        make_distributed_decode_attn)
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    res = {"rank": rank, "collectives_on": f"{device} tensors"}
    try:
        dist.all_reduce(torch.ones(1, device=device))
    except RuntimeError as e:
        # gloo without CUDA support: only the (B, H) and (B, H, D)
        # partials go through the host; the kernel stays on the card
        res["collectives_on"] = f"host copies ({str(e)[:120]})"
        reduce = dist.all_reduce

        def staged(t, op=dist.ReduceOp.SUM, group=None):
            host = t.cpu()
            reduce(host, op=op, group=group)
            t.copy_(host)
        dist.all_reduce = staged
    b, s, h, h_kv, d = shape
    g = h // h_kv
    gen = torch.Generator(device=device).manual_seed(11)
    q = torch.randn((b, 1, h, d), generator=gen, device=device,
                    dtype=torch.bfloat16)
    k = torch.randn((b, s, h_kv, d), generator=gen, device=device,
                    dtype=torch.bfloat16)
    v = torch.randn((b, s, h_kv, d), generator=gen, device=device,
                    dtype=torch.bfloat16)
    ln = torch.tensor(splitk_lengths(s)[:b], dtype=torch.int32,
                      device=device)
    s_loc = s // world
    kh = k[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    vh = v[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    mesh = DeviceMesh("cpu", torch.arange(world)[None],
                      mesh_dim_names=("data", "model"))
    attn = make_distributed_decode_attn(mesh, g)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    da.decode_attention_partial.launches = 0
    got = attn(q, kh, vh, ln)
    sync()
    res["partial_launches"] = da.decode_attention_partial.launches
    times = []
    for _ in range(SPLITK_REPS):
        dist.barrier()
        t0 = time.perf_counter()
        attn(q, kh, vh, ln)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    res["combine_ms"] = times
    t0 = time.perf_counter()
    for _ in range(SPLITK_REPS):
        da.decode_attention_partial(q, kh, vh, ln, rank * s_loc)
    sync()
    res["partial_ms_host_clock"] = ((time.perf_counter() - t0) * 1e3
                                    / SPLITK_REPS)
    if rank == 0:
        kernel = da.decode_attention(q, k, v, ln)
        plain = decode_attention_ref(q[:, 0].reshape(b, h_kv, g, d), k, v,
                                     ln).reshape(b, 1, h, d)
        sync()
        for name, want in (("kernel", kernel), ("plain", plain)):
            res[f"max_abs_err_vs_{name}"] = float(
                (got.float() - want.float()).abs().max())
            res[f"row_scaled_err_vs_{name}"] = row_scaled_err(got, want)
        res["finite"] = bool(torch.isfinite(got).all())
    with open(Path(out) / f"splitk_rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_two_ranks() -> dict:
    """SPLITK_RANKS processes on cuda:0 (NCCL takes one rank a card, gloo
    takes more), each holding half of one Granite-width layer's cache:
    the split-K output against the rank-free kernel and the plain
    version over the whole cache (within ``SPLITK_ROW_TOL`` of each
    row's largest magnitude; the absolute errors printed beside), and
    the combine's time."""
    import torch.multiprocessing as mp
    out_dir = ROOT / "build" / "splitk"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("splitk_rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    ctx = mp.spawn(splitk_rank, args=(SPLITK_RANKS, free_port(),
                                      str(out_dir), SPLITK_SHAPE, DEVICE),
                   nprocs=SPLITK_RANKS, join=False)
    while not ctx.join(timeout=10):
        if time.perf_counter() - t0 > 300:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError("two-rank split-K did not finish in 300 s")
    ranks = [json.loads((out_dir / f"splitk_rank{r}.json").read_text())
             for r in range(SPLITK_RANKS)]
    r0 = ranks[0]
    b, s, h, h_kv, d = SPLITK_SHAPE
    res = {"shape": {"B": b, "S": s, "H": h, "H_kv": h_kv, "D": d,
                     "dtype": "bfloat16", "ranks": SPLITK_RANKS},
           "kv_bytes": 2 * b * s * h_kv * d * 2,
           "lengths": splitk_lengths(s)[:b], "ranks": ranks,
           "collectives_on": r0["collectives_on"],
           **{k: r0[k] for k in r0 if "_err_vs_" in k},
           "row_scaled_tol": SPLITK_ROW_TOL,
           "combine_ms_median": float(np.median(
               [t for r in ranks for t in r["combine_ms"]])),
           "wall_s": time.perf_counter() - t0}
    if not (r0["finite"]
            and r0["row_scaled_err_vs_kernel"] <= SPLITK_ROW_TOL
            and r0["row_scaled_err_vs_plain"] <= SPLITK_ROW_TOL):
        raise AssertionError(f"two-rank split-K disagrees: {res}")
    if DEVICE == "cuda" and any(r["partial_launches"] != 1 for r in ranks):
        raise AssertionError("a rank did not launch the partial kernel once")
    return res


def serve_splitk(engine, questions) -> dict:
    """Serve the questions on ``engine`` through a server, with every
    kernel's launches over the run."""
    import torch
    from repro_torch.serving.server import RAGServer, poisson_offsets
    server = RAGServer(engine)
    reset_launches()
    t0 = time.perf_counter()
    handles = server.replay(questions,
                            poisson_offsets(QPS, len(questions), seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = server.summary()
    snap = engine.metrics_snapshot()
    return {"wall_s": wall, "n_done": summary["n_done"],
            "ttft_s": summary["ttft_s"], "ttft_p99_s": summary["ttft_p99_s"],
            "tpot_s": summary["tpot_s"], "tpot_p99_s": summary["tpot_p99_s"],
            "decode_steps": snap["decode_host_syncs"],
            "stage_time_s": snap["stage_time_s"],
            "attn_impl": snap["attn_impl"], "launches": read_launches(),
            "requests": [h.request for h in handles], "snap": snap}


def check_splitk_serving() -> dict:
    """Granite-3.0-2B at full width through serve's engine config with
    ``attn_impl="splitk"`` and with ``"cuda"``, sharing the generator,
    the encoder, the corpus encode and the IVF-PQ index: 16 Poisson
    questions on each.  The splitk engine decodes through the partial
    kernel (40 launches a decode step, no other attention kernel); its
    tokens equal the cuda engine's, or differ first at a near tie (plain
    top-2 margin <= 2 x ``compare_logits``' atol); then a teacher-forced
    decode step, plain attention vs the engine's split-K callable."""
    import dataclasses
    import torch
    from repro_torch.configs import granite_3_2b
    from repro_torch.data.synthetic import topical_corpus
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Component, RAGEngine

    t0 = time.perf_counter()
    cfg = granite_3_2b.CONFIG
    gen = Component(cfg, tr.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0),
        dtype=torch.bfloat16, device=DEVICE))
    enc = encoder_component(cfg.vocab_size)
    corpus, _topics, make_q = topical_corpus(4096, 256, cfg.vocab_size)
    base = RAGEngine(gen, enc, corpus, serve_engine_config(), device=DEVICE)
    splitk = RAGEngine(gen, enc, corpus, dataclasses.replace(
        serve_engine_config(), attn_impl="splitk"),
        db_vectors=base.db_vectors, backend=base.backend.chain[0],
        device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    questions = [make_q(i % 8) for i in range(N_QUESTIONS)]
    runs = {name: serve_splitk(eng, questions)
            for name, eng in (("cuda", base), ("splitk", splitk))}
    sk, cu = runs["splitk"], runs["cuda"]
    check_served(base, cu["requests"], questions, cu["snap"], NEW_TOKENS)
    for r in sk["requests"]:
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"splitk request {r.rid}: token out of "
                                 f"range")
    n_layers = cfg.n_layers
    launches = sk["launches"]
    if sk["attn_impl"] != "splitk" or sk["n_done"] != len(questions):
        raise AssertionError(f"splitk engine: {sk['attn_impl']}, "
                             f"{sk['n_done']} done")
    if launches["decode_attention_partial"] != n_layers * sk["decode_steps"]:
        raise AssertionError(f"partial kernel launched "
                             f"{launches['decode_attention_partial']} "
                             f"times, expected {n_layers} x "
                             f"{sk['decode_steps']}")
    if any(launches[k] for k in ("paged_decode_attention",
                                 "decode_attention", "flash_attention")):
        raise AssertionError(f"splitk engine launched another attention "
                             f"kernel: {launches}")
    out = {"model": cfg.name, "setup_s": setup_s, "equal": 0,
           "near_ties": [], "runs": {}}
    for i, (a, b) in enumerate(zip(cu["requests"], sk["requests"])):
        if a.retrieved_ids != b.retrieved_ids or len(b.output) != NEW_TOKENS:
            raise AssertionError(f"splitk request {i}: {a.retrieved_ids} vs "
                                 f"{b.retrieved_ids}, {len(b.output)} "
                                 f"tokens")
        if a.output == b.output:
            out["equal"] += 1
            continue
        step = next(t for t, (x, y) in enumerate(zip(a.output, b.output))
                    if x != y)
        margin = near_tie_margin(gen, a.prompt, np.asarray(a.output[:step]),
                                 DEVICE)
        tie = {"request": i, "step": step, "cuda": a.output[step],
               "splitk": b.output[step], "plain_top2_margin": margin}
        out["near_ties"].append(tie)
        if not margin <= 2 * 0.1:
            raise AssertionError(f"splitk vs cuda: not a near tie: {tie}")
    for name, r in runs.items():
        out["runs"][name] = {k: r[k] for k in (
            "wall_s", "n_done", "ttft_s", "ttft_p99_s", "tpot_s",
            "tpot_p99_s", "decode_steps", "stage_time_s", "launches")}
    out["partial_launches"] = launches["decode_attention_partial"]
    out["teacher_forced"], _ = teacher_forced_paged(splitk, questions,
                                                    splitk.paged_attn)
    abort_all(splitk, "distributed check done")
    return out


def check_decode_variant() -> dict:
    """``build_lm_decode_variant(splitk=True, int8_kv=True)`` at Granite's
    full width on a 1 x 1 mesh, B 8, S 4,096: its cache int8 with bf16
    scales (``_quantize_token`` of a bf16 cache drawn from a seed); one
    step (40 launches of the partial) against the same step given plain
    attention in f32 over the same cache, dequantized as the reference
    does: each layer's split-K attention on that step's inputs within
    ``SPLITK_ROW_TOL`` of each row's largest magnitude, the logits
    within ``VARIANT_LOGIT_TOL``; the softmax gap to the baseline
    ``decode_step`` on the bf16 cache within the reference's 0.1."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.decode_attn import (
        make_distributed_decode_attn, reference_decode_attn)
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.perf.variants import (_quantize_token,
                                           build_lm_decode_variant,
                                           decode_step_variant)

    arch = get_arch("granite-3-2b")
    cfg = arch.config
    shape = ShapeSpec("decode_4k", "decode", VARIANT_DIMS)
    prog = build_lm_decode_variant(arch, shape, make_host_mesh(),
                                   splitk=True, int8_kv=True)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    params = tr.quantize_for_serving(tr.init_params(
        cfg, gen, dtype=torch.bfloat16, device=DEVICE)).tree()
    b, s = VARIANT_DIMS["global_batch"], VARIANT_DIMS["seq_len"]
    shp = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    bf16 = {k: torch.randn(shp, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for k in ("k", "v")}
    q8 = {}
    for k in ("k", "v"):
        q8[k] = torch.empty(shp, dtype=torch.int8, device=DEVICE)
        q8[k + "_scale"] = torch.empty(shp[:-1], dtype=torch.bfloat16,
                                       device=DEVICE)
        for i in range(cfg.n_layers):
            codes, scale = _quantize_token(bf16[k][i].reshape(
                b * s, cfg.n_kv_heads, cfg.d_head))
            q8[k][i] = codes.reshape(shp[1:])
            q8[k + "_scale"][i] = scale.reshape(shp[1:-1])
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    pos = torch.tensor(VARIANT_POS, dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    da.decode_attention_partial.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    logits, _ = prog.fn(params, q8, token, pos)
    ev[1].record()
    launches = da.decode_attention_partial.launches
    ev[2].record()
    base, _ = tr.decode_step(params, bf16, token, pos, cfg)
    ev[3].record()
    ev[3].synchronize()

    # the same step with plain attention (the new token's K/V are written
    # again, to the same values) in f32, as the kernel keeps scores and p
    # (in bf16 the plain version read 1.2e-2 of a row from it on the
    # H100); each layer also runs the program's split-K callable on its
    # inputs
    split = make_distributed_decode_attn(make_host_mesh(), cfg.q_per_kv,
                                         quantized=True)
    layer_errs = []

    def plain_attn(q, kc, vc, ks, vs, cache_len):
        k = kc.to(q.dtype) * ks[..., None].to(q.dtype)
        v = vc.to(q.dtype) * vs[..., None].to(q.dtype)
        want = reference_decode_attn(q.float(), k.float(), v.float(),
                                     cache_len, cfg.q_per_kv).to(q.dtype)
        layer_errs.append(row_scaled_err(
            split(q, kc, vc, ks, vs, cache_len), want))
        return want

    plain, _ = decode_step_variant(params, q8, token, pos, cfg, plain_attn,
                                   int8_kv=True)
    vocab = cfg.vocab_size
    plain, got = plain[:, :vocab].float(), logits[:, :vocab].float()
    top2 = torch.topk(plain, 2, dim=-1).values
    logit_diff = float((plain - got).abs().max())
    gap = float((torch.softmax(got, -1)
                 - torch.softmax(base[:, :vocab].float(), -1)).abs().max())
    res = {"cell": prog.name, "batch": b, "seq_len": s,
           "int8_cache_bytes": sum(q8[k].numel() for k in ("k", "v")),
           "scale_bytes": sum(q8[k].numel() * 2
                              for k in ("k_scale", "v_scale")),
           "bf16_cache_bytes": sum(t.numel() * 2 for t in bf16.values()),
           "attention_row_scaled_err": layer_errs,
           "attention_row_scaled_tol": SPLITK_ROW_TOL,
           "logits_max_abs_diff": logit_diff,
           "logits_tol": VARIANT_LOGIT_TOL,
           "argmax_equal": int((plain.argmax(-1) == got.argmax(-1)).sum()),
           "plain_top2_margins": (top2[:, 0] - top2[:, 1]).tolist(),
           "softmax_max_abs_gap_to_baseline": gap,
           "reference_softmax_bound": VARIANT_SOFTMAX_BOUND,
           "partial_launches": launches, "variant_step_ms":
           ev[0].elapsed_time(ev[1]), "baseline_step_ms":
           ev[2].elapsed_time(ev[3]),
           "finite": bool(torch.isfinite(logits).all())}
    if not (res["finite"] and len(layer_errs) == cfg.n_layers
            and max(layer_errs) <= SPLITK_ROW_TOL
            and logit_diff <= VARIANT_LOGIT_TOL
            and gap < VARIANT_SOFTMAX_BOUND):
        raise AssertionError(f"decode variant: {res}")
    if launches != cfg.n_layers:
        raise AssertionError(f"decode variant launched the partial "
                             f"{launches} times, expected {cfg.n_layers}")
    return res


def phase_distributed() -> dict:
    """The split-K decode on the card: Granite-3.0-2B served at full width
    through ``attn_impl="splitk"`` against the ``"cuda"`` engine; the
    combine across two real ranks on one card; the int8-KV decode
    variant cell at full width on a 1 x 1 mesh."""
    import torch
    card = nvidia_smi_line()
    res = {"phase": "distributed", "card": card}
    res["serve"] = check_splitk_serving()
    emit({"phase": "distributed", "serve": res["serve"]})
    release_device_memory()
    res["two_ranks"] = check_two_ranks()
    emit({"phase": "distributed", "two_ranks": res["two_ranks"]})
    res["variant"] = check_decode_variant()
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "distributed", "variant": res["variant"],
          "peak_mem_bytes": res["peak_mem_bytes"]})
    return res


#: the MoE phase: Moonlight-16B-A3B in the reference's config
MOE_ARCH = "moonshot-v1-16b-a3b"


def moe_tokenwise(x, lp: dict, cfg, compute_dtype=None):
    """The MoE FFN token by token, with no capacity: each token's top-k
    experts (stable descending order, as ``jax.lax.top_k``) are gathered
    and applied, weighted by their renormalised gates.  Equal to
    ``tr.moe_ffn`` wherever no slot is dropped, as at decode (S = 1)."""
    import torch
    from repro_torch.models import common as cm
    compute_dtype = compute_dtype or torch.bfloat16
    B, S, d = x.shape
    k = cfg.moe.top_k
    xc = x.to(compute_dtype)
    gates = torch.softmax(
        (xc @ cm.maybe_dequant(lp["router"], compute_dtype)).float(), dim=-1)
    gval, eidx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gval, eidx = gval[..., :k], eidx[..., :k].reshape(B * S, k)
    gval = gval / (gval.sum(-1, keepdim=True) + 1e-9)
    xt = xc.reshape(B * S, 1, 1, d)

    def expert(name):                                  # (B*S, k, d_in, d_out)
        return cm.maybe_dequant(lp[name], compute_dtype)[eidx]
    up = xt @ expert("w_up")                                 # (N, k, 1, f)
    if cfg.ffn_type == "relu2":
        act = torch.square(torch.relu(up))
    else:
        act = cm.swiglu(xt @ expert("w_gate"), up)
    out = (act @ expert("w_down"))[:, :, 0]                  # (N, k, d)
    y = (out * gval.reshape(B * S, k, 1).to(compute_dtype)).sum(dim=1)
    return y.reshape(B, S, d).to(x.dtype)


def check_moe_decode(gen) -> dict:
    """``moe_ffn`` at the decode shape (B=8, S=1: one slot an expert, none
    dropped) on layer 0's experts against ``moe_tokenwise``, in bf16; and
    its device time a layer beside the bound of reading every expert's
    weights once (the reference's dispatch runs all of them)."""
    import torch
    from repro_torch.models import transformer as tr

    cfg = gen.cfg
    lp = tr.layer_params(gen.params["layers"], 0)
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (8, 1, cfg.d_model)), dtype=torch.bfloat16, device=DEVICE)
    _, _, eidx, _ = tr.moe_route(x, lp, cfg)
    _, keep = tr.capacity_slots(eidx, cfg.moe.n_experts, 1)
    got, _ = tr.moe_ffn(x, lp, cfg)
    want = moe_tokenwise(x, lp, cfg)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-2
    result = {"shape": [8, 1, cfg.d_model], "experts": cfg.moe.n_experts,
              "top_k": cfg.moe.top_k, "kept_all": bool(keep.all()),
              "max_abs_err": err, "max_abs": float(want.float().abs().max()),
              "tol": tol,
              "tol_reason": "both sides round every product to bf16 "
                            "once; they run other GEMM shapes, so an "
                            "output of order one may differ by a few "
                            "bf16 steps (2^-8 relative)"}
    if not result["kept_all"]:
        raise AssertionError("moe_ffn dropped a slot at S = 1")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        emit({"phase": "serve_moe", "moe_decode": result})
        raise AssertionError("moe_ffn differs from the token-wise version")
    mats = [lp[n] for n in ("w_gate", "w_up", "w_down") if n in lp]
    # every expert runs on its one capacity slot of each of the 8 rows
    result["ms_per_layer"] = device_ms(lambda: tr.moe_ffn(x, lp, cfg))
    result["bound_ms_per_layer"], result["bound_by"] = bound(
        sum(w.numel() * w.element_size() for w in mats) + 2 * x.numel() * 2,
        2 * len(mats) * 8 * cfg.moe.n_experts * cfg.d_model * cfg.d_ff,
        "bfloat16")
    result["tokenwise_ms_per_layer"] = device_ms(
        lambda: moe_tokenwise(x, lp, cfg))
    return result


def phase_serve_moe() -> dict:
    """Moonlight-16B-A3B in the reference's config at full width (48
    layers, d_model 2,048, 16/16 heads of 128, 64 experts of d_ff 1,408
    top-6, vocabulary 163,840; random bf16 weights drawn on the card),
    an encoder of ENCODER_120M's widths with its vocabulary, a corpus of
    4,096 documents and serve's engine: 16 Poisson questions, every
    kernel's launches over them, then a teacher-forced decode step and
    prefill (kernel vs plain attention) and ``moe_ffn`` against the
    token-wise version.  Runs after every earlier engine is collected."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import topical_corpus
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Component, RAGEngine
    from repro_torch.serving.server import RAGServer, poisson_offsets

    cfg = get_arch(MOE_ARCH).config
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = Component(cfg, tr.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0),
        dtype=torch.bfloat16, device=DEVICE))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    enc = encoder_component(cfg.vocab_size)
    corpus, _topics, make_q = topical_corpus(4096, 256, cfg.vocab_size)
    engine = RAGEngine(gen, enc, corpus, serve_engine_config(),
                       device=DEVICE)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    param_bytes = buffer_bytes(gen.params)
    embed_bytes = gen.params["embed"].numel() * 2
    questions = [make_q(i % 8) for i in range(N_QUESTIONS)]

    server = RAGServer(engine)
    reset_launches()
    t0 = time.perf_counter()
    handles = server.replay(questions,
                            poisson_offsets(QPS, len(questions), seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    summary = server.summary()
    snap = engine.metrics_snapshot()
    steps = snap["decode_host_syncs"]
    result = {
        "phase": "serve_moe", "model": cfg.name, "init_s": t_init,
        "setup_s": t_setup, "device_bytes_held_before": held,
        "params": sum(t.numel() for t in gen.params.buffers()),
        "param_bytes": param_bytes,
        "kv_pool_bytes": sum(v.numel() * v.element_size()
                             for v in engine.pool.cache.values()),
        "encoder_bytes": buffer_bytes(enc.params),
        "wall_s": wall, "n_done": summary["n_done"], "qps": summary["qps"],
        "ttft_s": summary["ttft_s"], "ttft_p99_s": summary["ttft_p99_s"],
        "tpot_s": summary["tpot_s"], "tpot_p99_s": summary["tpot_p99_s"],
        "stage_time_s": snap["stage_time_s"], "decode_steps": steps,
        "prefills": snap["prefills"], "launches": launches,
        "prefill_s_per_request": snap["stage_time_s"]["prefill"]
        / max(1, snap["prefills"]),
        "decode_s_per_step": snap["stage_time_s"]["decode"] / max(1, steps),
        # every weight but the embedding table is read once a decode step
        "decode_floor_ms": (param_bytes - embed_bytes) / HBM_BYTES_PER_S
        * 1e3,
        "peak_mem_bytes_serving": torch.cuda.max_memory_allocated(),
        "first_output": handles[0].output[:8]}
    emit(result)
    check_served(engine, [h.request for h in handles], questions, snap)
    check_paged_launches(engine, launches, snap, len(questions))
    result["paged"], prompts = teacher_forced_paged(engine, questions)
    result["prefill"], _ = teacher_forced_prefill(gen, prompts)
    abort_all(engine, "serve_moe check done")
    result["moe_decode"] = check_moe_decode(gen)
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit({"phase": "serve_moe", "paged": result["paged"],
          "prefill": result["prefill"], "moe_decode": result["moe_decode"],
          "peak_mem_bytes": result["peak_mem_bytes"]})
    return result


def release_device_memory() -> None:
    """Collect what an earlier phase left (serve_plan's server, engine and
    handles hold one another in a reference cycle), hand its blocks back
    to the device and restart the peak statistic, so the next phase's
    peak is its own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


#: kinds of device kernel by marks in their names (the first kind that
#: matches wins): cuBLAS/CUTLASS matmuls, softmax, copies and casts,
#: other elementwise passes, reductions
KERNEL_KINDS = (("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
                ("softmax", ("softmax",)),
                ("copy", ("direct_copy", "copy_kernel", "memcpy")),
                ("elementwise", ("elementwise",)),
                ("reduce", ("reduce",)))


def kernel_breakdown(prof, wall_s: float, n: int, unit: str,
                     top_k: int = 8) -> dict:
    """Device time a ``unit`` (of ``n`` in the trace), its share of the
    host-clock ``wall_s``, launches, device time by ``KERNEL_KINDS``, and
    the ``top_k`` kernels by device time, from a ``torch.profiler``
    trace."""
    import torch
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_k]
    by_kind: dict = {}
    for e in kernels:
        kind = next((k for k, marks in KERNEL_KINDS
                     if any(m in e.key.lower() for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (
            e.self_device_time_total / n / 1e3)
    return {f"device_ms_per_{unit}": device_us / n / 1e3,
            "device_busy_share": device_us / 1e6 / wall_s,
            f"kernel_launches_per_{unit}": sum(e.count for e in kernels) / n,
            f"ms_per_{unit}_by_kind": by_kind,
            "top_kernels": [{"name": e.key[:60],
                             f"ms_per_{unit}": e.self_device_time_total
                             / n / 1e3,
                             f"calls_per_{unit}": e.count / n}
                            for e in top]}


def phase_profile(engine, questions, ticks: int = 5) -> dict:
    """Where a decode tick's time goes (``--profile``): fill every slot,
    time ``ticks`` pure decode ticks on the host clock, then trace as many
    more with ``torch.profiler`` for the kernels'
    device time, and compare the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.request import Request

    for q in questions[:engine.cfg.decode_slots]:
        engine.queue.append(Request(question=q.copy(), max_new_tokens=32))
    engine.tick()                                # admit + prefill + 1 step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
    result = {"phase": "profile", "ticks": ticks,
              "wall_ms_per_tick": wall / ticks * 1e3,
              **kernel_breakdown(prof, wall, ticks, "tick")}
    emit(result)
    for slot in list(engine.active):
        engine.abort_request(engine.active[slot], "profile done")
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    profile = "--profile" in sys.argv[1:]

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
        return out

    dev = timed("device", phase_device)
    timed("build", phase_build)
    engine, dense, questions = timed("setup", phase_setup)
    checks = timed("kernels", phase_kernels, engine)
    timed("decode_sync", phase_decode_sync, engine)
    timed("retrieve_scale", phase_retrieve_scale)
    served = timed("serve", phase_serve, engine, questions)
    timed("trace", phase_trace, engine, questions)
    served_dense = timed("serve_dense", phase_serve_dense, dense, questions)
    served_plan, plan = timed("serve_plan", phase_serve_plan, engine,
                              questions)
    release_device_memory()
    disagg = timed("serve_disagg", phase_serve_disagg, engine, questions,
                   plan)
    timed("check", phase_check, engine, dense, questions, disagg["cluster"])
    timed("chaos", phase_chaos, disagg["cluster"], questions)
    timed("control", phase_control, disagg, questions, plan)
    if profile:
        phase_profile(engine, questions)
    # the full-width models need the card: keep serve's encoder, corpus
    # embedding and index for the models phase, collect everything else
    shared = (engine.enc, engine.corpus, engine.db_vectors,
              engine.backend.chain[0])
    del engine, dense, disagg, plan
    release_device_memory()
    timed("models", phase_models, *shared, questions)
    del shared
    release_device_memory()
    timed("train", phase_train, profile)
    release_device_memory()
    timed("recsys_gnn", phase_recsys_gnn)
    release_device_memory()
    distributed = timed("distributed", phase_distributed)
    release_device_memory()
    timed("serve_moe", phase_serve_moe)

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:112"),
        "pq_scan": ("src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan/pq_scan.py:35"),
        "decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:70"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:61"),
        "decode_attention_partial": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:70"),
        # the reference attends a chunk through plain einsums, no kernel
        "paged_chunk_attention": (
            "src/repro_torch/csrc/paged_chunk_attention.cu",
            "src/repro/models/transformer.py:640"),
    }
    # each kernel's launches on the path it serves: the paged serve phase
    # for paged attention and the PQ scan, serve_dense for dense attention,
    # serve_plan for flash attention and the chunk extend's attention, the
    # distributed phase's splitk engine for the dense kernel's partial
    # entry
    launches = {**served["launches"],
                "decode_attention":
                served_dense["launches"]["decode_attention"],
                "flash_attention":
                served_plan["launches"]["flash_attention"],
                "paged_chunk_attention":
                served_plan["launches"]["paged_chunk_attention"],
                "decode_attention_partial":
                distributed["serve"]["partial_launches"]}
    kernels = []
    for name, (source, replaces) in sources.items():
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c.get("library_ms")})
    emit({"kernels": kernels})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
