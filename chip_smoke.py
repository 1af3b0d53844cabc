#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path once -- ``RAGServer`` over ``RAGEngine`` with
IBM Granite-3.0-2B at full width (random weights from a seed), an encoder
of ENCODER_120M's widths, IVF-PQ retrieval and paged decode attention --
and holds every CUDA kernel of that path against its plain PyTorch
version.  Phases, each printed as one JSON line, in order:

  device    card name, ``nvidia-smi`` name and power limit, TF32 flags
  build     nvcc build of ``src/repro_torch/csrc/*.cu`` (seconds)
  setup     model weights, corpus encode, IVF-PQ index, engine
  kernels   each kernel vs its plain version at the main path's shapes
  serve     16 Poisson-arriving questions through the server; every
            kernel's launch count over this phase alone
  check     teacher-forced decode step, kernel vs plain attention, and
            IVF-PQ search with and without the scan kernel

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
TIMING_REPS = 50


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
    # ENCODER_120M's widths (repro.core.ragschema), bidirectional
    enc_cfg = tr.TransformerConfig(
        name="st-120m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=3072, vocab_size=30522, causal=False)
    enc = Component(enc_cfg, tr.init_params(
        enc_cfg, torch.Generator(device="cuda").manual_seed(1),
        dtype=torch.float32, device="cuda"))
    corpus, _topics, make_q = topical_corpus(4096, 256, enc_cfg.vocab_size)
    cfg = EngineConfig(decode_slots=8, s_max=1024, page_size=16,
                       retrieval_k=2, max_new_tokens=32,
                       retrieval_backend="ivfpq")
    engine = RAGEngine(gen, enc, corpus, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in gen.params.buffers())
    gen_bytes = sum(t.numel() * t.element_size()
                    for t in gen.params.buffers())
    pool_bytes = sum(v.numel() * v.element_size()
                     for v in engine.pool.cache.values())
    index = engine.backend.chain[0].index
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "model": gen_cfg.name, "params": n_params,
          "param_bytes": gen_bytes, "kv_pages": engine.pool.n_pages,
          "kv_pool_bytes": pool_bytes, "corpus": list(corpus.shape),
          "ivf_lists": index.n_lists, "ivf_list_len": index.list_ids.shape[1],
          "pq_subq": index.n_subq, "nprobe": engine.backend.chain[0].nprobe,
          "attn_impl": engine.attn_impl})
    questions = [make_q(i % 8) for i in range(N_QUESTIONS)]
    return engine, questions


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
    torch.cuda.synchronize()
    return {"paged_decode_attention": pa, "pq_scan": pq}


def phase_serve(engine, questions) -> dict:
    import torch
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.pq_scan import ops as pq
    from repro_torch.serving.request import State
    from repro_torch.serving.server import RAGServer, poisson_offsets

    server = RAGServer(engine)
    torch.cuda.reset_peak_memory_stats()
    pa.paged_decode_attention.launches = 0
    pq.pq_scan.launches = 0
    t0 = time.perf_counter()
    handles = server.replay(questions,
                            poisson_offsets(QPS, len(questions), seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                "pq_scan": pq.pq_scan.launches}
    snap = engine.metrics_snapshot()
    summary = server.summary()
    steps = snap["decode_host_syncs"]            # decode steps that stepped
    searches = snap["histograms"]["stage_seconds:retrieve"]["count"]
    vocab = engine.gen.cfg.vocab_size
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
    for h in handles:
        r = h.request
        if r.state is not State.DONE or len(r.output) != 32:
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
    n_layers = engine.gen.cfg.n_layers
    if launches["paged_decode_attention"] != n_layers * steps:
        raise AssertionError(f"paged attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {n_layers} x {steps}")
    if launches["pq_scan"] < searches or searches < len(questions):
        raise AssertionError(f"pq_scan launched {launches['pq_scan']} "
                             f"times for {searches} searches")
    return result


def phase_check(engine, questions) -> dict:
    """One teacher-forced decode step of the full-width model on the serve
    phase's pool, plain attention vs the kernel; and IVF-PQ search with the
    scan kernel vs the plain scan."""
    import torch
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.models import transformer as tr
    from repro_torch.retrieval.ivf_pq import search
    from repro_torch.serving.request import Request, State

    # fill every slot: admit + prefill 8 fresh requests, then one step
    for q in questions[:engine.cfg.decode_slots]:
        engine.queue.append(Request(question=q.copy(), max_new_tokens=32))
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
    dev = engine.device
    args = (torch.tensor(tokens, device=dev), engine.pool.positions(),
            torch.tensor(engine.pool.block_tables(), device=dev))
    logits = {}
    for name, attn in (("plain", None), ("kernel", paged_decode_attention)):
        # the step writes the same K/V rows before attending, so the two
        # runs see the same pool whichever goes first
        lg, _ = tr.paged_decode_step(
            engine.gen.params, engine.pool.cache, *args, engine.gen.cfg,
            attn_impl=attn, write_mask=torch.tensor(mask, device=dev))
        logits[name] = lg[slots, :engine.gen.cfg.vocab_size].float()
    torch.cuda.synchronize()
    plain, kern = logits["plain"], logits["kernel"]
    if not (torch.isfinite(plain).all() and torch.isfinite(kern).all()):
        raise AssertionError("non-finite logits")
    # the plain path rounds softmax probabilities to bf16 before P@V, the
    # kernel keeps them f32; over 40 bf16 layers that moves logits of
    # magnitude ~|x| by a few bf16 steps (2^-8 relative each)
    atol = rtol = 0.1
    diff = (plain - kern).abs()
    top2 = torch.topk(plain, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * atol
    same_argmax = plain.argmax(-1) == kern.argmax(-1)
    result = {"phase": "check", "slots": len(slots),
              "tol_reason": "plain attention rounds probabilities to bf16, "
                            "the kernel keeps f32; 40 bf16 layers carry "
                            "that to a few bf16 steps of each logit",
              "logits_max_abs_diff": float(diff.max()),
              "logits_max_abs": float(plain.abs().max()),
              "atol": atol, "rtol": rtol,
              "argmax_equal": int(same_argmax.sum()),
              "argmax_decided": int(decided.sum())}
    if not torch.allclose(kern, plain, rtol=rtol, atol=atol):
        emit(result)
        raise AssertionError("teacher-forced logits differ beyond tolerance")
    if not bool(same_argmax[decided].all()):
        emit(result)
        raise AssertionError("argmax differs where the top-2 margin is wide")

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
    for slot in list(engine.active):
        engine.abort_request(engine.active[slot], "smoke check done")
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
    engine, questions = phase_setup()
    checks = phase_kernels(engine)
    served = phase_serve(engine, questions)
    phase_check(engine, questions)
    if profile_decode:
        phase_profile(engine, questions)

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:112"),
        "pq_scan": ("src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan/pq_scan.py:35"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
