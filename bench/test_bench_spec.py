"""Every piece ``BENCHMARK.json`` names is found and well-formed, and a new
cell, configuration and metric need only new files and entries."""

import json
import re
import shutil

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.cell import Obs, run_cell

BM = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_shape():
    assert set(BM) == TOP_KEYS
    assert BM["paths"] == ["bench"]
    assert BM["command"][:2] == ["python3", "bench/run.py"]
    assert 1 <= BM["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1,200 s spare, within 43,200 s
    assert (2 + 14 * 24) * (BM["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BM)) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    names += [w["name"] for w in BM["workloads"]]
    names += [c["name"] for c in BM["configs"]]
    for w in BM["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BM["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME_RE.match(n), n
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for kind in ("end_to_end", "per_layer", "workloads", "configs"):
        entries = [e["name"] for e in BM[kind]]
        assert len(entries) == len(set(entries)), kind


def test_every_file_is_found():
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = spec.load_config(BM, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg["model"], key
            assert not key.endswith(("_dim", "_rank", "_size"))
        assert any(w["config"] == c["name"] for w in BM["workloads"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        mix = spec.load_traffic(w["traffic"])
        assert mix["loop"] in ("open", "closed")
        assert set(mix["judge"]["limits"]) == {"logit_gap_mean", "retrieval_gap"}
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_metrics_per_cell():
    e2e = {m["name"] for m in BM["end_to_end"]}
    assert "setup_s" in e2e
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e
    for w in BM["workloads"]:
        reported = {m["name"] for m in spec.cell_metrics(BM, w["name"],
                                                         False)}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        layer = spec.cell_metrics(BM, w["name"], True)
        assert layer, w["name"]
        assert all(m["moves"] in reported for m in layer)


def test_readers_return_nothing_on_an_empty_window():
    obs = Obs("none", {}, {}, 1.0, True)
    for m in BM["per_layer"]:
        assert spec.metric_reader(m["name"])(obs) is None, m["name"]


def test_new_cell_config_and_metric_are_new_files_only(tmp_path):
    """A dummy configuration, traffic mix and per-layer metric added to a
    copy of the benchmark beside the files already there, then run."""
    bm = tiny.make(tmp_path)
    bench = tmp_path / "bench"
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    cfg = json.loads((tmp_path / bm["configs"][0]["file"]).read_text())
    cfg["name"] = "dummy-config"
    (bench / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    shutil.copy(spec.traffic_path("chatglm3-longctx-open", bench),
                spec.traffic_path("dummy-traffic", bench))
    (bench / "metrics" / "dummy_answers.count.py").write_text(
        "def read(obs):\n    return float(len(obs.judged)) or None\n")
    bm["configs"].append(dict(bm["configs"][0], name="dummy-config",
                              file="bench/configs/dummy-config.json"))
    bm["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                            "traffic": "dummy-traffic", "chips": 1,
                            "why": "a cell added by new files only"})
    bm["per_layer"].append({"name": "dummy_answers.count", "unit": "1",
                            "better": "higher", "source": "program_counter",
                            "layer": "server", "moves": "ttft_p95_s",
                            "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    bm = spec.load_benchmark(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _ = run_cell(bm, "dummy-cell", 5, 1.0, True, device="cpu",
                             root=tmp_path, bench_dir=bench)
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], result["checks"]
    assert result["metrics"]["dummy_answers.count"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before
