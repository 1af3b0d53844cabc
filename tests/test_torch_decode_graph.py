"""The engine's decode step replayed from a CUDA graph.

* On the CPU every engine steps eagerly: no capture, no replay, and every
  traced ``DECODE_TICK`` carries ``graph`` 0, whatever the attention and
  the pool.
* The graph path's bookkeeping on the CPU, through a fake capture
  (``step_graph.capture`` replaced by one whose graph runs the step again
  on each replay): the same tokens as the eager engine, one capture, a
  replay every later tick, the ``graph`` attr, the launches a replay adds
  back, and one recapture when the pool's storage is replaced.
* The benchmark's readers of the ``graph`` attr
  (``bench/metrics/decode_graph_share.*.py``): their entries, their
  value on synthetic spans and on a traced toy run of their cells on the
  CPU (0: no tick replays there), and nothing on a program without the
  attr.
* On a GPU only (marker ``cuda``): the real graph on a tiny stack with
  admissions, releases, copy-on-write pages and iterative appends, on
  the paged and the dense pool and with a mixture-of-experts FFN: the
  tokens equal the eager engine's, every tick after the capture replays,
  a replaced pool recaptures once, and the paged kernel's ``launches``
  advance by one a layer each replayed tick.

    python -m pytest -m cuda tests/test_torch_decode_graph.py
"""

import types

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.cell import Obs, run_cell
from repro_torch.data.synthetic import topical_corpus
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as te
from repro_torch.serving import step_graph
from repro_torch.serving.request import State
from repro_torch.serving.server import RAGServer
from repro_torch.serving.telemetry import Span, SpanTracer

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

VOCAB = 128
N_LAYERS = 2
#: decode slots, cache and answers: 7 questions through 3 slots admit and
#: release across the serve; every 3 tokens an iterative append
BASE = {"decode_slots": 3, "s_max": 96, "max_new_tokens": 9,
        "page_size": 4}
ITERATIVE = {"iterative_interval": 3, "retrieval_batch": 2}
PIN_AT = 4      # the tick after which every tail page turns shared
SWAP_AT = 7     # the tick after which the pool's storage is replaced


def _component(seed, device, causal=True, d=48, moe=None):
    cfg = tr.TransformerConfig(name=f"g{seed}", n_layers=N_LAYERS,
                               d_model=d, n_heads=4, n_kv_heads=2,
                               d_head=16, d_ff=64, vocab_size=VOCAB,
                               causal=causal, moe=moe)
    gen = torch.Generator(device=device).manual_seed(seed)
    return te.Component(cfg, tr.init_params(cfg, gen, device=device))


def _engine(device, graph=None, moe=None, **kw):
    """A tiny engine on ``device``; ``graph`` overrides what it chose."""
    corpus, _, make_q = topical_corpus(48, 10, VOCAB, n_topics=4)
    eng = te.RAGEngine(_component(0, device, moe=moe),
                       _component(1, device, causal=False, d=32), corpus,
                       te.EngineConfig(**{**BASE, **kw}), device=device)
    if graph is not None:
        eng.graph_decode = graph
    return eng, [make_q(i % 4) for i in range(7)]


def _pin_tails(pool) -> None:
    """Make every live slot's partial tail page content-addressed, as a
    prefix-cache page is: the slot's next write into it copies it first
    (copy-on-write), which moves the slot's block table."""
    for slot, table in enumerate(pool.page_tables):
        if table and pool.lengths[slot] % pool.page_size:
            pool._register(table[-1], f"pinned{slot}".encode())


def _serve(engine, questions, tracer=None, swap=False) -> list:
    """Serve ``questions`` tick by tick: after tick ``PIN_AT`` the tail
    pages turn shared (paged pool); with ``swap`` the pool's K/V move to
    new storage after tick ``SWAP_AT``.  The requests' outputs."""
    server = RAGServer(engine, tracer=tracer)
    reqs = [server.submit(q.copy()).request for q in questions]
    ticks = 0
    while server.step():
        ticks += 1
        if ticks == PIN_AT and isinstance(engine.pool, te.PagedKVCachePool):
            _pin_tails(engine.pool)
        if swap and ticks == SWAP_AT:
            engine.pool.cache = {k: v.clone()
                                 for k, v in engine.pool.cache.items()}
    server.run_until_idle()
    assert all(r.state is State.DONE for r in reqs)
    return [list(r.output) for r in reqs]


def _stepped_ticks(engine) -> int:
    """Decode ticks that stepped a row: one read of tokens each."""
    return engine.metrics["decode_host_syncs"]


# ---------------------------------------------------------------------------
# CPU: every engine steps eagerly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"attn_impl": "ref", **ITERATIVE}, {"attn_impl": "cuda"},
    {"paged": False}, {"fused_decode": False}],
    ids=["auto", "ref-iterative", "cuda-on-cpu", "dense", "pre-fusion"])
def test_cpu_engines_step_eagerly(kw):
    engine, questions = _engine("cpu", **kw)
    assert not engine.graph_decode
    tracer = SpanTracer()
    _serve(engine, questions, tracer=tracer)
    snap = engine.metrics_snapshot()
    assert snap["decode_graph_captures"] == snap["decode_graph_replays"] == 0
    ticks = [s.attrs for s in tracer.spans() if s.kind == "DECODE_TICK"]
    assert len(ticks) == _stepped_ticks(engine) > 0
    assert all(a["graph"] == 0 for a in ticks)


# ---------------------------------------------------------------------------
# CPU: the graph path's bookkeeping through a fake capture
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Replays by running the step again into the captured output."""

    def __init__(self, step, out):
        self.step, self.out = step, out

    def replay(self):
        self.out.copy_(self.step())


@pytest.fixture
def fake_capture(monkeypatch):
    """``step_graph.capture`` that runs the step once and records nothing;
    its graph says it holds one launch of ``counter`` a layer."""
    counter = types.SimpleNamespace(launches=0)
    captures = []

    def capture(step):
        eager = step()
        out = torch.empty_like(eager)
        captures.append(step)
        return _FakeGraph(step, out), eager, out, [(counter, N_LAYERS)]

    monkeypatch.setattr(step_graph, "capture", capture)
    return counter, captures


@pytest.mark.parametrize("kw", [ITERATIVE, {"paged": False}],
                         ids=["paged-iterative", "dense"])
def test_fake_graph_serves_the_eager_tokens(fake_capture, kw):
    counter, captures = fake_capture
    eager, questions = _engine("cpu", **kw)
    want = _serve(eager, questions)
    engine, _ = _engine("cpu", graph=True, **kw)
    tracer = SpanTracer()
    assert _serve(engine, questions, tracer=tracer) == want
    snap = engine.metrics_snapshot()
    ticks = _stepped_ticks(engine)
    # the first tick captures (and steps eagerly), every later one replays
    assert len(captures) == snap["decode_graph_captures"] == 1
    assert snap["decode_graph_replays"] == ticks - 1
    assert counter.launches == N_LAYERS * (ticks - 1)
    graph = [s.attrs["graph"] for s in tracer.spans()
             if s.kind == "DECODE_TICK"]
    assert graph == [0] + [1] * (ticks - 1)
    # the same four (dense: three) copies a tick, into the static inputs
    paged = kw.get("paged", True)
    h2d = {s.attrs["h2d"] for s in tracer.spans() if s.kind == "DECODE_TICK"}
    assert h2d == {4 if paged else 3}
    if paged:
        assert snap["pages_cow"] > 0


def test_fake_graph_recaptures_once_on_new_storage(fake_capture):
    counter, captures = fake_capture
    eager, questions = _engine("cpu", **ITERATIVE)
    want = _serve(eager, questions, swap=True)
    engine, _ = _engine("cpu", graph=True, **ITERATIVE)
    assert _serve(engine, questions, swap=True) == want
    snap = engine.metrics_snapshot()
    assert snap["decode_graph_captures"] == 2
    assert snap["decode_graph_replays"] == _stepped_ticks(engine) - 2
    assert engine._graph.key == (engine.pool.cache["k"].data_ptr(),
                                 engine.pool.cache["v"].data_ptr())


# ---------------------------------------------------------------------------
# CPU: the benchmark's readers of the ``graph`` attr
# ---------------------------------------------------------------------------

#: each share of decode ticks replayed from the graph, and its cells
GRAPH = {"decode_graph_share.throughput": ["chatglm3-iterative-closed",
                                           "moonlight-longform-closed"],
         "decode_graph_share.ttft": ["chatglm3-longctx-open"]}
MOVES = {"decode_graph_share.throughput": "answers_per_s",
         "decode_graph_share.ttft": "ttft_p95_s"}


def test_each_graph_share_has_its_entry_and_reader():
    entries = {m["name"]: m for m in spec.load_benchmark()["per_layer"]
               if m["name"] in GRAPH}
    assert set(entries) == set(GRAPH)
    for name, cells in GRAPH.items():
        assert entries[name] == {
            "name": name, "unit": "%", "better": "higher",
            "source": "program_span", "layer": "engine tick",
            "moves": MOVES[name], "workloads": cells}
        assert spec.metric_path(name).is_file(), name


def _window(spans) -> Obs:
    obs = Obs("none", {}, {}, 1.0, True, t0=1.0, t1=10.0)
    obs.spans = spans
    return obs


@pytest.mark.parametrize("name", sorted(GRAPH))
def test_graph_share_reads_the_window_ticks(name):
    """The mean of ``graph`` over the window's ticks, in %: a tick before
    the window (the capture's, in set-up) or after it, and spans of other
    kinds, count for nothing."""
    ticks = [(0.5, 0), (2.0, 1), (3.0, 1), (4.0, 0), (5.0, 1), (10.5, 0)]
    spans = [Span("DECODE_TICK", t, t + 0.05, engine="engine0", tick=i,
                  attrs={"n": 3, "h2d": 4, "graph": g})
             for i, (t, g) in enumerate(ticks)]
    spans.append(Span("STAGE:decode.launch", 2.0, 2.01, engine="engine0",
                      tick=1))
    assert spec.metric_reader(name)(_window(spans)) == pytest.approx(75.0)


@pytest.mark.parametrize("name", sorted(GRAPH))
def test_graph_share_finds_nothing_without_the_attr(name):
    """A program without the attr (the parent's ticks carry ``n`` and
    ``h2d`` alone) gives the reader nothing to read."""
    spans = [Span("EMBED", 1.0, 1.1, engine="engine0"),
             Span("DECODE_TICK", 2.0, 2.05, engine="engine0", tick=1,
                  attrs={"n": 3, "h2d": 4})]
    assert spec.metric_reader(name)(_window(spans)) is None


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    return tiny.make(root), root


@pytest.mark.parametrize("cell", sorted({c for cells in GRAPH.values()
                                          for c in cells}))
def test_traced_toy_run_reads_no_replay_on_the_cpu(toy, cell):
    bm, root = toy
    result, _ = run_cell(bm, cell, 3_000_000_019, 2.0, True, device="cpu",
                         root=root, bench_dir=root / "bench")
    assert result["correct"], result["checks"]
    name = next(n for n, cells in GRAPH.items() if cell in cells)
    assert result["metrics"][name] == {"value": 0.0, "unit": "%"}


# ---------------------------------------------------------------------------
# GPU only: the real graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CUDA_CASES = {"paged-iterative": ITERATIVE, "dense": {"paged": False},
              "moe": {"moe": tr.MoEConfig(n_experts=4, top_k=2)}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_graph_serves_the_eager_tokens(cuda, case):
    kw = CUDA_CASES[case]
    eager, questions = _engine(cuda, graph=False, **kw)
    want = _serve(eager, questions)
    engine, _ = _engine(cuda, **kw)
    assert engine.graph_decode
    pa.paged_decode_attention.launches = 0
    assert _serve(engine, questions) == want
    snap = engine.metrics_snapshot()
    ticks = _stepped_ticks(engine)
    assert snap["decode_graph_captures"] == 1
    assert snap["decode_graph_replays"] == ticks - 1
    if engine.cfg.paged:
        # one launch a layer a tick: the eager tick's, then each replay's
        assert pa.paged_decode_attention.launches == N_LAYERS * ticks
        if case == "paged-iterative":
            assert snap["pages_cow"] > 0


@pytest.mark.cuda
def test_graph_recaptures_once_on_new_storage(cuda):
    eager, questions = _engine(cuda, graph=False, **ITERATIVE)
    want = _serve(eager, questions, swap=True)
    engine, _ = _engine(cuda, **ITERATIVE)
    assert _serve(engine, questions, swap=True) == want
    snap = engine.metrics_snapshot()
    assert snap["decode_graph_captures"] == 2
    assert snap["decode_graph_replays"] == _stepped_ticks(engine) - 2


@pytest.mark.cuda
def test_replayed_tick_launches_once_a_layer(cuda):
    engine, questions = _engine(cuda)
    server = RAGServer(engine)
    for q in questions:
        server.submit(q.copy())
    while not engine.metrics["decode_graph_replays"]:
        server.step()
    before = pa.paged_decode_attention.launches
    replays = engine.metrics["decode_graph_replays"]
    server.step()
    assert engine.metrics["decode_graph_replays"] == replays + 1
    assert pa.paged_decode_attention.launches - before == N_LAYERS
    server.run_until_idle()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"attn_impl": "ref"},
                                {"attn_impl": "splitk"},
                                {"fused_decode": False}],
                         ids=["ref", "splitk", "pre-fusion"])
def test_other_cuda_engines_step_eagerly(cuda, kw):
    engine, questions = _engine(cuda, **kw)
    assert not engine.graph_decode
    _serve(engine, questions)
    snap = engine.metrics_snapshot()
    assert snap["decode_graph_captures"] == snap["decode_graph_replays"] == 0
