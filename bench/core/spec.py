"""Find the benchmark's pieces by name.

``BENCHMARK.json`` (at the checkout's root) names every cell, configuration
and metric.  Each piece sits in a file of its own, found by its name:

* a configuration: the ``file`` its ``configs`` entry gives;
* a traffic mix: ``bench/workloads/<traffic>.json``;
* a metric, end to end or per layer: ``bench/metrics/<metric>.py``, whose
  ``read(obs)`` returns the value, or ``None`` where it finds nothing.

A later cell, configuration or metric is new files and new entries; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "bench"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config_entry(bm: dict, name: str) -> dict:
    for c in bm["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"BENCHMARK.json has no configuration {name!r}")


def load_config(bm: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / config_entry(bm, name)["file"]) as f:
        return json.load(f)


def traffic_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "workloads" / f"{name}.json"


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(traffic_path(name, bench_dir)) as f:
        return json.load(f)


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``bench/metrics/<name>.py``, loaded from
    its path (metric names hold dots, which an import name cannot)."""
    path = metric_path(name, bench_dir)
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bm: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric with a
    ``workloads`` key belongs to the cells it lists; one without, to
    every cell that reports what it moves (per layer) or to every cell
    (end to end)."""
    e2e = [m for m in bm["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def belongs(m):
        if "workloads" in m:
            return cell in m["workloads"]
        return m["moves"] in names

    return [m for m in bm["per_layer"] if belongs(m)]
