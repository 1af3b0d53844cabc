"""A copy of the benchmark at toy sizes, for the CPU tests.

``make(tmp)`` writes ``tmp/BENCHMARK.json`` and ``tmp/bench/{configs,
workloads,metrics,blocks,reference}`` from the real ones with every width,
depth, slot count, corpus and length cut to a size the CPU runs in
seconds (the model's to its family's ``TINY``); cells, metric readers,
families and limits keep their names.  ``run_cell(..., root=tmp,
bench_dir=tmp / "bench", device="cpu")`` then drives the real harness.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench.core import spec

# limits of the toy copy, from its CPU readings: sound runs of every cell
# over seeds 31-38 read logit_gap_mean <= 0.0006 and retrieval_gap 0; the
# faults of test_bench_faults.py read logit_gap_mean 0.0083-3.2 (a state
# left unchanged: 0.0083-0.0092 in the open ChatGLM3 cell, whose answers
# are short beside their prompts; 0.12-0.22 in the iterative one) or
# retrieval_gap 0.89-1.23 (answer altered)
TINY_LIMITS = {"logit_gap_mean": 0.003, "retrieval_gap": 1e-3}
TINY_ENCODER = dict(num_hidden_layers=2, hidden_size=32,
                    num_attention_heads=2, num_key_value_heads=2,
                    head_dim=16, intermediate_size=64, vocab_size=512)


def tiny_config(cfg: dict, bench_dir: Path = spec.BENCH_DIR) -> dict:
    """``cfg`` at toy sizes; its model family is found under
    ``bench_dir``."""
    cfg = json.loads(json.dumps(cfg))
    cfg["model"].update(spec.family(cfg, bench_dir).TINY)
    cfg["encoder"].update(TINY_ENCODER)
    cfg["corpus"].update(n_docs=64, doc_len=cfg["corpus"]["doc_len"] // 16)
    cfg["serving"].update(decode_slots=8, max_new_tokens=32,
                          s_max=min(cfg["serving"]["s_max"] // 8, 512))
    return cfg


def tiny_traffic(mix: dict) -> dict:
    mix = json.loads(json.dumps(mix))
    if mix["loop"] == "closed":
        mix.update(clients=8, admit_per_tick=2)
    else:
        mix.update(rate_qps=8.0, lead_in_s=0.2)
    out = mix["output_tokens"]
    if out["dist"] == "fixed":
        out["value"] = 16
    else:
        out["range"] = [4, 16]
    if mix.get("iterative_interval"):
        mix.update(iterative_interval=4, retrieval_batch=2)
    mix["question_tokens"]["range"] = [4, 8]
    mix["judge"].update(limits=dict(TINY_LIMITS), sample_requests=16)
    return mix


def make(tmp, root: Path = spec.ROOT) -> dict:
    """The toy benchmark under ``tmp``; returns its BENCHMARK dict."""
    tmp = Path(tmp)
    bench = tmp / "bench"
    for sub in ("configs", "workloads"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "blocks", "reference"):
        shutil.copytree(root / "bench" / sub, bench / sub,
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bm = spec.load_benchmark(root)
    for c in bm["configs"]:
        cfg = tiny_config(json.loads((root / c["file"]).read_text()),
                          root / "bench")
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bm["workloads"]:
        mix = tiny_traffic(spec.load_traffic(w["traffic"], root / "bench"))
        spec.traffic_path(w["traffic"], bench).write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bm))
    return bm
