"""The per-layer metrics that read the engine's sub-stage spans and work
counters: a traced run of each cell of the toy copy on the CPU reads the
span and counter ones, and finds nothing for the device-trace ones (no
device trace there); each has its reader and its entry; on the spans of
a program that records neither the sub-stage spans nor the new attrs,
every reader but the live rows' finds nothing and raises nothing."""

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.cell import Obs, run_cell
from repro_torch.serving.telemetry import Span

BM = spec.load_benchmark()
NEW = {"idle_in_decode_launch.ttft": "chatglm3-longctx-open",
       "idle_in_decode_launch.throughput": "chatglm3-iterative-closed",
       "decode_host_ms.ttft": "chatglm3-longctx-open",
       "decode_host_ms.throughput": "chatglm3-iterative-closed",
       "h2d_copies_per_step.throughput": "chatglm3-iterative-closed",
       "live_rows_per_step.throughput": "chatglm3-iterative-closed",
       "embed_pad_share.ttft": "chatglm3-longctx-open",
       "prefill_wait_ms.ttft": "chatglm3-longctx-open"}
ENTRIES = {m["name"]: m for m in BM["per_layer"] if m["name"] in NEW}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("toy")
    yield tiny.make(root), root
    torch.set_num_threads(threads)


def test_each_metric_has_its_entry_and_reader():
    assert set(ENTRIES) == set(NEW)
    for name, cell in NEW.items():
        assert ENTRIES[name]["workloads"] == [cell], name
        assert spec.metric_path(name).is_file(), name


@pytest.mark.parametrize("cell", sorted(set(NEW.values())))
def test_traced_toy_run_reads_the_tick(toy, cell):
    bm, root = toy
    result, _ = run_cell(bm, cell, 3_000_000_019, 2.0, True, device="cpu",
                         root=root, bench_dir=root / "bench")
    assert result["correct"], result["checks"]
    got = result["metrics"]
    for name in (n for n, c in NEW.items() if c == cell):
        if ENTRIES[name]["source"] == "device_trace":
            assert name not in got, name
        else:
            assert got[name]["value"] > 0, name
            assert got[name]["unit"] == ENTRIES[name]["unit"]
    if cell == "chatglm3-iterative-closed":
        # the paged step copies tokens, positions, block tables, the mask
        assert got["h2d_copies_per_step.throughput"]["value"] == 4.0
        cfg = spec.load_config(bm, spec.workload(bm, cell)["config"], root)
        assert got["live_rows_per_step.throughput"]["value"] <= \
            cfg["serving"]["decode_slots"]
    else:
        # admission embeds one question in a batch of 32
        assert got["embed_pad_share.ttft"]["value"] == \
            pytest.approx(100.0 * 31 / 32)


def _parent_obs() -> Obs:
    """What a traced window holds from a program without the sub-stage
    spans and the new attrs: a tick with only its ``n``, a bare EMBED."""
    obs = Obs("none", {}, {}, 1.0, True, t0=0.0, t1=10.0)
    obs.spans = [Span("EMBED", 1.0, 1.1, engine="engine0"),
                 Span("PREFILL", 1.2, 1.3, rid=0, engine="engine0"),
                 Span("DECODE_TICK", 2.0, 2.05, engine="engine0", tick=1,
                      attrs={"n": 3})]
    obs.device_trace = {"busy_s": 1.0, "window_s": 10.0, "kernel_s": {},
                        "idle_by_stage": {"DECODE_TICK": 5.0},
                        "n_events": 1, "start_s": 0.0}
    return obs


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_finds_nothing_without_the_new_spans(name):
    value = spec.metric_reader(name)(_parent_obs())
    if name == "live_rows_per_step.throughput":
        assert value == 3.0
    else:
        assert value is None
