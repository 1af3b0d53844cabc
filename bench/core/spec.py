"""Find the benchmark's pieces by name.

``BENCHMARK.json`` (at the checkout's root) names every cell, configuration
and metric.  Each piece sits in a file of its own, found by its name:

* a configuration: the ``file`` its ``configs`` entry gives;
* a traffic mix: ``bench/workloads/<traffic>.json``;
* a metric, end to end or per layer: ``bench/metrics/<metric>.py``, whose
  ``read(obs)`` returns the value, or ``None`` where it finds nothing;
* a model family: ``bench/blocks/<block>.py``, named by the ``block`` key
  of a configuration's ``model`` group (no default).  It provides

  - ``TINY``: the toy sizes ``bench/tiny.py`` writes over the ``model``
    group;
  - ``program_config(m, name)``: the program's model config;
  - ``draw_weights(m, program_cfg, seed, device)``: the weight tree,
    drawn on the device from the seed in the type it is served in;
  - ``program_component(m, weights, name, control)``: the program's
    config and parameters for its ``Component``; ``control`` the
    program's int8-weight path (``bench/control.py``);
  - ``prefill_flops(m, n)``, ``decode_flops(m, ctxs)``: model FLOPs of a
    prefill of ``n`` real tokens and of a decode step of rows at
    contexts ``ctxs``;
  - ``prefill_bounds(m, n)``, ``decode_bounds(m, ctxs)``: ``{name:
    seconds}``, the least time of each kernel the family's path runs,
    summed under those names over the traced slice (``Obs.work``), where
    a kernel's roofline metric reads its own;
  - ``REFERENCE``: the name of its plain reference,
    ``bench/reference/<REFERENCE>.py``, whose ``decoder_logits(weights,
    m, seqs, wants)`` the judge calls; it imports nothing of the program.

  The encoder is the RAGO paper's 120M encoder in every configuration and
  stays on the dense code (``core/model.py``, ``reference/lm.py``).

A later cell, configuration, metric or model family is new files and new
entries; no file here changes.
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


class SpecError(LookupError):
    """A piece ``BENCHMARK.json`` or a configuration names is missing."""


def load_module(path: Path, prefix: str):
    """The module of the file ``path``, loaded from its path (names of
    pieces hold dots and dashes, which an import name cannot)."""
    mod_spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return load_module(metric_path(name, bench_dir), "bench_metric_").read


def block_path(block: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "blocks" / f"{block}.py"


def reference_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "reference" / f"{name}.py"


def family(cfg: dict, bench_dir: Path = BENCH_DIR):
    """The model family a configuration names by ``model.block``: the
    module ``bench/blocks/<block>.py``, with its reference module loaded
    as ``reference``."""
    block = cfg["model"].get("block")
    if block is None:
        raise SpecError(
            f"configuration {cfg.get('name')!r}: its \"model\" group has no "
            f"\"block\" key naming its model family "
            f"(bench/blocks/<block>.py); there is no default")
    path = block_path(block, bench_dir)
    if not path.is_file():
        raise SpecError(
            f"configuration {cfg.get('name')!r} names the model family "
            f"{block!r}, and bench/blocks/{block}.py is not there ({path})")
    fam = load_module(path, "bench_block_")
    fam.reference = load_module(reference_path(fam.REFERENCE, bench_dir),
                                "bench_reference_")
    return fam


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
