"""The per-layer metric that reads how many rows a retrieval batch's
chunk-extend forward appends (``append_rows_per_call.throughput``): its
entry and reader; on synthetic spans the window's ``STAGE:append``
spans' ``rows`` over their ``calls``, and nothing where no span carries
them (a program that appends one request a forward records no attr); and
a traced run of the iterative cell of the toy copy on the CPU."""

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.cell import Obs, run_cell
from repro_torch.serving.telemetry import Span

BM = spec.load_benchmark()
NAME = "append_rows_per_call.throughput"
CELL = "chatglm3-iterative-closed"


def _obs(spans) -> Obs:
    obs = Obs("none", {}, {}, 1.0, True, t0=0.0, t1=10.0)
    obs.spans = spans
    return obs


def _append(t0, **attrs):
    return Span("STAGE:append", t0, t0 + 0.05, engine="engine0", tick=1,
                attrs=attrs or None)


def test_entry_and_reader():
    entry, = (m for m in BM["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert (entry["unit"], entry["better"], entry["source"]) == \
        ("rows", "higher", "program_span")
    assert (entry["layer"], entry["moves"]) == ("engine tick",
                                                "answers_per_s")
    assert spec.metric_path(NAME).is_file()


@pytest.mark.parametrize("spans,want", [
    # the window's spans only: the one at 11 s lies past it
    ([_append(1.0, rows=8, tokens=4096, calls=1),
      _append(2.0, rows=7, tokens=3584, calls=1),
      _append(11.0, rows=1, tokens=512, calls=1)], 7.5),
    ([_append(1.0, rows=3, tokens=30, calls=1)], 3.0),
    # a batch whose documents fell in two buckets: two forwards
    ([_append(1.0, rows=8, tokens=3000, calls=2),
      _append(2.0, rows=4, tokens=2048, calls=1)], 4.0),
    # a program that records no rows, or no append at all
    ([_append(1.0), _append(2.0)], None),
    ([_append(1.0, rows=8, tokens=4096)], None),
    ([Span("DECODE_TICK", 2.0, 2.05, engine="engine0", tick=1,
           attrs={"n": 3})], None),
], ids=["window", "one", "two_buckets", "no_attr", "no_calls", "no_append"])
def test_reader_on_synthetic_spans(spans, want):
    assert spec.metric_reader(NAME)(_obs(spans)) == want


def test_traced_toy_run_reads_the_rows(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bm = tiny.make(tmp_path)
        result, _ = run_cell(bm, CELL, 3_000_000_029, 2.0, True,
                             device="cpu", root=tmp_path,
                             bench_dir=tmp_path / "bench")
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], result["checks"]
    got = result["metrics"][NAME]
    assert got["unit"] == "rows"
    # the toy cell retrieves in batches of 2
    mix = spec.load_traffic(spec.workload(bm, CELL)["traffic"],
                            tmp_path / "bench")
    assert 1.0 <= got["value"] <= mix["retrieval_batch"] == 2
