"""The per-layer metric that reads the paged chunk-extend attention's share
of the traced slice (``append_attn_share.throughput``): its entry and
reader; on synthetic device traces the kernel's seconds over the slice,
and nothing where no such kernel ran (a program that attends its appends
plainly, or a slice with no append); and a traced run of the iterative
cell of the toy copy on the CPU, which has no device trace to read."""

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.cell import Obs, run_cell

BM = spec.load_benchmark()
NAME = "append_attn_share.throughput"
CELL = "chatglm3-iterative-closed"
KERNEL = ("void_(anonymous namespace)::paged_chunk_attention_kernel<128>"
          "(__nv_bfloat16 const*, ...)")


def _obs(kernel_s, window_s=10.0) -> Obs:
    obs = Obs("none", {}, {}, 1.0, True, t0=0.0, t1=10.0)
    obs.device_trace = {"busy_s": 6.0, "window_s": window_s,
                        "kernel_s": kernel_s, "idle_by_stage": {},
                        "n_events": 1, "start_s": 0.0}
    return obs


def test_entry_and_reader():
    entry, = (m for m in BM["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert (entry["unit"], entry["better"], entry["source"]) == \
        ("%", "lower", "device_trace")
    assert (entry["layer"], entry["moves"]) == ("kernels", "answers_per_s")
    assert spec.metric_path(NAME).is_file()


@pytest.mark.parametrize("kernel_s,window_s,want", [
    ({KERNEL: 0.15, "nvjet_tst_256x128": 0.5}, 10.0, 1.5),
    ({KERNEL: 0.1, KERNEL.replace("<128>", "<64>"): 0.1}, 8.0, 2.5),
    # the plain path's kernels, or no append in the slice
    ({"void_at::native::cunn_SoftMaxForward": 0.45,
      "void__anonymous_namespace_::split_kernel": 0.4}, 10.0, None),
    ({}, 10.0, None),
    ({KERNEL: 0.1}, 0.0, None),
], ids=["kernel", "two_widths", "plain_path", "no_kernels", "no_window"])
def test_reader_on_synthetic_traces(kernel_s, window_s, want):
    got = spec.metric_reader(NAME)(_obs(kernel_s, window_s))
    assert got == (None if want is None else pytest.approx(want))


def test_reader_finds_nothing_without_a_device_trace():
    obs = _obs({})
    obs.device_trace = None
    assert spec.metric_reader(NAME)(obs) is None


def test_traced_toy_run_has_no_device_share(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bm = tiny.make(tmp_path)
        result, _ = run_cell(bm, CELL, 3_000_000_037, 2.0, True,
                             device="cpu", root=tmp_path,
                             bench_dir=tmp_path / "bench")
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], result["checks"]
    assert NAME not in result["metrics"]
    assert result["metrics"]["append_rows_per_call.throughput"]["value"] \
        >= 1.0
