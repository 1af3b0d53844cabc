#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's two serving paths -- ``RAGServer`` over ``RAGEngine``
with IBM Granite-3.0-2B at full width (random weights from a seed), an
encoder of ENCODER_120M's widths with Granite's vocabulary, and IVF-PQ
retrieval -- and holds every CUDA kernel of those paths against its plain
PyTorch version.  The paged path decodes through the paged-decode kernel;
the dense path decodes through the dense decode kernel, behind every
pre-prefill stage of ``full_pipeline`` (rewrite, multi-query fan-out,
rerank, safety filter).  Phases, each printed as one JSON line, in order:

  device       card name, ``nvidia-smi`` name and power limit, TF32 flags
  build        nvcc build of ``src/repro_torch/csrc/*.cu`` (seconds)
  setup        model weights, corpus encode, IVF-PQ index, both engines
  kernels      each kernel vs its plain version at its path's shapes
  serve        16 Poisson-arriving questions through the paged engine;
               every kernel's launch count over this phase alone
  serve_dense  8 Poisson-arriving questions through the dense engine and
               its five stage executors; launch counts over this phase
  check        teacher-forced decode step on each pool, kernel vs plain
               attention, and IVF-PQ search with and without the scan
               kernel

then the ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without that last line.  It needs a CUDA
device and the repository around it.

    python3 chip_smoke.py             # every phase above
    python3 chip_smoke.py --profile   # and a torch.profiler breakdown of
                                      # five decode ticks
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
NEW_TOKENS = 32
TIMING_REPS = 50
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


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in one CUDA
    graph, replayed between two CUDA events (host launch cost excluded).
    Inputs stay resident in L2 across the replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    # ENCODER_120M's widths (repro.core.ragschema), bidirectional, with the
    # generator's vocabulary as repro/launch/serve.py sizes its encoder:
    # rewrite and fan-out hand generated ids to it
    enc_cfg = tr.TransformerConfig(
        name="st-120m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=3072, vocab_size=gen_cfg.vocab_size, causal=False)
    enc = Component(enc_cfg, tr.init_params(
        enc_cfg, torch.Generator(device="cuda").manual_seed(1),
        dtype=torch.float32, device="cuda"))
    corpus, _topics, make_q = topical_corpus(4096, 256, enc_cfg.vocab_size)
    cfg = EngineConfig(decode_slots=8, s_max=1024, page_size=16,
                       retrieval_k=2, max_new_tokens=NEW_TOKENS,
                       retrieval_backend="ivfpq")
    engine = RAGEngine(gen, enc, corpus, cfg, device="cuda")
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


def check_paged_attention() -> dict:
    """Kernel vs plain version at the main path's widths (B=8, H_kv=8, G=4,
    D=64, page=16, M=64), bf16 and f32, over lengths 0, 1, a non-multiple
    of the page, M*page + 1 and two rows that share physical pages."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_dense_ref)

    b, h_kv, g, d, page, m = 8, 8, 4, 64, 16, 64
    lengths = [0, 1, 537, m * page + 1, 300, 300, m * page, 16]
    rng = np.random.default_rng(0)
    n_pool = b * m + 1
    tables = rng.permutation(b * m).reshape(b, m).astype(np.int32)
    tables[5] = tables[4]                       # rows 4 and 5 share pages
    out = {"tol_reason": "kernel and plain version both keep f32 softmax "
                         "statistics and round the f32 result once; they "
                         "sum in other orders, so bf16 outputs of order "
                         "one differ by at most about one bf16 step"}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q = torch.tensor(rng.standard_normal((b, h_kv, g, d)),
                         dtype=dtype, device="cuda")
        q[5] = q[4]                             # same query, shared pages
        k = torch.tensor(rng.standard_normal((n_pool, page, h_kv, d)),
                         dtype=dtype, device="cuda")
        v = torch.tensor(rng.standard_normal((n_pool, page, h_kv, d)),
                         dtype=dtype, device="cuda")
        tb = torch.tensor(tables, device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = pa.paged_decode_attention_cuda(q, k, v, tb, ln)
        want = paged_decode_attention_dense_ref(q, k, v, tb, ln)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"paged attention {dtype}: max abs err "
                                 f"{err} > {tol}")
        if got[0].any():
            raise AssertionError("paged attention: length-0 row not zero")
        if not torch.equal(got[4], got[5]):
            raise AssertionError("paged attention: shared pages disagree")
        out[str(dtype).removeprefix("torch.")] = {"max_abs_err": err,
                                                  "tol": tol}
        if dtype is torch.bfloat16:
            ms = device_ms(lambda: pa.paged_decode_attention_cuda(
                q, k, v, tb, ln))
            plain_ms = device_ms(lambda: paged_decode_attention_dense_ref(
                q, k, v, tb, ln))
            # bytes the work needs: each distinct K/V row once (shared
            # pages count once), q, the used table entries, lengths, out
            rows = set()
            n_ops = 0
            for bi, length in enumerate(lengths):
                length = min(length, m * page)
                rows.update((int(tables[bi, p // page]), p % page)
                            for p in range(length))
                n_ops += 4 * length * h_kv * g * d
            used_pages = sum(-(-min(x, m * page) // page) for x in lengths)
            n_bytes = (2 * len(rows) * h_kv * d * 2 + 2 * q.numel() * 2
                       + 4 * used_pages + 4 * b)
            bound_ms, bound_by = bound(n_bytes, n_ops, "bfloat16")
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, max_abs_err=err)
    return out


def check_decode_attention() -> dict:
    """Kernel vs plain version at the dense path's widths (B=8, S=1,024,
    H_kv=8, G=4, D=64), bf16 and f32, over lengths 1, a non-multiple of
    the tile, S, S + 1 (clamps to S), two equal rows, 16 and 1,000.  One
    ``scaled_dot_product_attention`` call on the same inputs is timed as a
    yardstick (``library_ms``); the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    b, s, h_kv, g, d = 8, 1024, 8, 4, 64
    lengths = [1, 537, s, s + 1, 300, 300, 16, 1000]
    rng = np.random.default_rng(2)
    out = {"tol_reason": "kernel and plain version both keep f32 softmax "
                         "statistics and round the f32 result once; they "
                         "sum in other orders, so bf16 outputs of order "
                         "one differ by at most about one bf16 step"}
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
                   shape=[b, s, h_kv, g, d], lengths=lengths)
    return out


def check_pq_scan(rows: int, list_len: int, n_subq: int) -> dict:
    """Kernel vs plain version, bit-equal in f32, at the scan shape one
    search of the serve phase gives: (Q*nprobe, list_len, S)."""
    import torch
    from repro_torch.kernels.pq_scan import ops as pq
    from repro_torch.kernels.pq_scan.ref import pq_scan_ref

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
            out["plain_ms"] = device_ms(lambda: pq_scan_ref(lut, codes))
            n_bytes = lut.numel() * 4 + codes.numel() + rows * n * 4
            out["bound_ms"], out["bound_by"] = bound(
                n_bytes, rows * n * n_subq, "float32")
    out["max_abs_err"] = 0.0
    return out


def phase_kernels(engine) -> dict:
    import torch
    pa = check_paged_attention()
    emit({"phase": "kernels", "kernel": "paged_decode_attention", **pa})
    index = engine.backend.chain[0].index
    rows = engine.backend.chain[0].nprobe        # one query per search
    pq = check_pq_scan(rows, index.list_ids.shape[1], index.n_subq)
    emit({"phase": "kernels", "kernel": "pq_scan", "tol": "bit-equal",
          **pq})
    dense = check_decode_attention()
    emit({"phase": "kernels", "kernel": "decode_attention", **dense})
    torch.cuda.synchronize()
    return {"paged_decode_attention": pa, "pq_scan": pq,
            "decode_attention": dense}


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
    check_served(engine, handles, questions, snap)
    n_layers = engine.gen.cfg.n_layers
    if launches["paged_decode_attention"] != n_layers * steps:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {n_layers} x {steps}")
    if launches["decode_attention"] != 0:
        raise AssertionError("the dense kernel ran on the paged path")
    if launches["pq_scan"] < searches or searches < len(questions):
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    return result


def reset_launches() -> None:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.pq_scan import ops as pq
    for fn in (pa.paged_decode_attention, pq.pq_scan, da.decode_attention):
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.pq_scan import ops as pq
    return {"paged_decode_attention": pa.paged_decode_attention.launches,
            "pq_scan": pq.pq_scan.launches,
            "decode_attention": da.decode_attention.launches}


def check_served(engine, handles, questions, snap) -> None:
    """Every request DONE with NEW_TOKENS in-vocabulary tokens and
    in-corpus documents, through the CUDA attention kernel."""
    from repro_torch.serving.request import State
    vocab = engine.gen.cfg.vocab_size
    for h in handles:
        r = h.request
        if r.state is not State.DONE or len(r.output) != NEW_TOKENS:
            raise AssertionError(f"request {r.rid}: {r.state} with "
                                 f"{len(r.output)} tokens")
        if not all(0 <= t < vocab for t in r.output):
            raise AssertionError(f"request {r.rid}: token out of range")
        if not all(0 <= i < len(engine.corpus) for i in r.retrieved_ids[0]):
            raise AssertionError(f"request {r.rid}: bad retrieved ids")
    if len(handles) != len(questions):
        raise AssertionError(f"{len(handles)} of {len(questions)} served")
    if snap["attn_impl"] != "cuda":
        raise AssertionError(f"attn_impl resolved to {snap['attn_impl']}")


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
    check_served(dense, handles, questions, snap)
    missing = [n for n in DENSE_STAGES if not stage_time.get(n, 0) > 0]
    if missing:
        raise AssertionError(f"no stage time for executors {missing}")
    for h in handles:
        r = h.request
        if (len(r.rewritten) != len(r.question) + 32
                or len(r.query_variants) != 2 or not r.safety_scores):
            raise AssertionError(f"request {r.rid}: a stage did not run")
    n_layers = dense.gen.cfg.n_layers
    if launches["decode_attention"] != n_layers * steps:
        raise AssertionError(f"dense attention launched "
                             f"{launches['decode_attention']} times, "
                             f"expected {n_layers} x {steps}")
    if launches["paged_decode_attention"] != 0:
        raise AssertionError("the paged kernel ran on the dense path")
    if launches["pq_scan"] < searches or searches < 2 * len(questions):
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    return result


def compare_logits(name: str, plain, kern) -> dict:
    """Teacher-forced logits of one decode step, plain attention vs the
    kernel: allclose, and the same argmax wherever the plain top-2 margin
    is wide.  Raises after printing the numbers when either fails."""
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


def phase_check(engine, dense, questions) -> dict:
    """One teacher-forced decode step of the full-width model on each pool,
    every slot filled, plain attention vs the kernel; and IVF-PQ search
    with the scan kernel vs the plain scan."""
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.models import transformer as tr
    from repro_torch.retrieval.ivf_pq import search
    from repro_torch.serving.request import Request, State

    result = {"phase": "check",
              "tol_reason": "plain attention rounds probabilities to bf16, "
                            "the kernel keeps f32; 40 bf16 layers carry "
                            "that to a few bf16 steps of each logit"}
    vocab = engine.gen.cfg.vocab_size
    dev = engine.device
    # paged: admit + prefill 8 fresh requests, then one step
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
    for name, attn in (("plain", None), ("kernel", paged_decode_attention)):
        # the step writes the same K/V rows before attending, so the two
        # runs see the same pool whichever goes first
        lg, _ = tr.paged_decode_step(
            engine.gen.params, engine.pool.cache, *args, engine.gen.cfg,
            attn_impl=attn, write_mask=torch.tensor(mask, device=dev))
        logits[name] = lg[slots, :vocab].float()
    torch.cuda.synchronize()
    result["paged"] = compare_logits("paged", logits["plain"],
                                     logits["kernel"])

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
    emit(result)
    for eng in (engine, dense):
        for slot in list(eng.active):
            eng.abort_request(eng.active[slot], "smoke check done")
    return result


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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    result = {"phase": "profile", "ticks": ticks,
              "wall_ms_per_tick": wall / ticks * 1e3,
              "device_ms_per_tick": device_us / ticks / 1e3,
              "device_busy_share": device_us / 1e6 / wall,
              "kernel_launches_per_tick": sum(e.count for e in kernels)
              / ticks,
              "top_kernels": [{"name": e.key[:60],
                               "ms_per_tick": e.self_device_time_total
                               / ticks / 1e3,
                               "calls_per_tick": e.count / ticks}
                              for e in top]}
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
    profile_decode = "--profile" in sys.argv[1:]

    dev = phase_device()
    phase_build()
    engine, dense, questions = phase_setup()
    checks = phase_kernels(engine)
    served = phase_serve(engine, questions)
    served_dense = phase_serve_dense(dense, questions)
    phase_check(engine, dense, questions)
    if profile_decode:
        phase_profile(engine, questions)

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:112"),
        "pq_scan": ("src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan/pq_scan.py:35"),
        "decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:70"),
    }
    # each kernel's launches on the path it serves: the paged serve phase
    # for paged attention and the PQ scan, serve_dense for dense attention
    launches = {**served["launches"],
                "decode_attention":
                served_dense["launches"]["decode_attention"]}
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
