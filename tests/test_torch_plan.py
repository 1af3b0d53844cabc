"""Port vs JAX: RAGO's schema -> plan -> server chain on the CPU.

* The port's copy of the planner (``repro_torch.core``) reproduces the
  golden Pareto frontiers of ``tests/golden/frontiers.json`` on
  ``gen_frontiers.CASES``, and gives the JAX package's plans and derived
  ``EngineConfig`` fields for every preset, on XPU-C and on the H100 spec;
  the 1-XPU system it cannot plan raises the same ``ValueError`` in both.
* ``RAGServer.from_plan`` then ``serve`` gives the JAX ``from_plan``
  engine's token streams and retrieved ids on the CPU stack of
  ``tests/test_torch_engine.py`` (the JAX side on ``attn_impl="ref"``, the
  IVF-PQ index carried across), under that file's near-tie rule.
* ``replay_trace`` of a saved JSONL trace, the trace generators, and
  the topologies ``from_plan`` takes (``"disagg"`` builds the cluster of
  ``tests/test_torch_cluster.py``; an unknown one raises).
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from repro.configs import rag_pipelines as jpipes
from repro.core import hardware as jhw
from repro.core import ragschema as jrs
from repro.core.serving_plan import ServingPlan as JServingPlan
from repro.core.stage_registry import REGISTRY as JREGISTRY
from repro.serving import engine as jengine
from repro.serving import trace as jtrace
from repro.serving.request import Request as JRequest
from repro.serving.server import RAGServer as JRAGServer
from repro_torch import bridge
from repro_torch.configs import rag_pipelines as tpipes
from repro_torch.core import hardware as thw
from repro_torch.core import optimizer as topt
from repro_torch.core import ragschema as trs
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.core.stage_registry import REGISTRY
from repro_torch.retrieval.backend import (ExactBackend, FallbackBackend,
                                           IVFPQBackend)
from repro_torch.serving import engine as te
from repro_torch.serving import trace as ttrace
from repro_torch.serving.request import Request, State
from repro_torch.serving.server import RAGServer
from test_torch_engine import _compare_streams, _port, stack  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
sys.path.insert(0, GOLDEN_DIR)

from gen_frontiers import CASES, plan_record  # noqa: E402

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

#: the H100 spec in both packages' XPUSpec (the JAX package has none)
JH100 = jhw.XPUSpec("H100-SXM", 989, 80, 3.35e12, 450e9)
XPUS = {"XPU-C": (jhw.XPU_C, thw.XPU_C), "H100": (JH100, thw.H100_SXM)}


def _port_schema(schema: jrs.RAGSchema) -> trs.RAGSchema:
    """The same schema built from the port's dataclasses."""
    def conv(v):
        return trs.ModelShape(**dataclasses.asdict(v)) \
            if isinstance(v, jrs.ModelShape) else v
    return trs.RAGSchema(**{f.name: conv(getattr(schema, f.name))
                            for f in dataclasses.fields(schema)})


def _systems(xpu: str, **kw):
    jx, tx = XPUS[xpu]
    return jhw.SystemConfig(xpu=jx, **kw), thw.SystemConfig(xpu=tx, **kw)


def test_h100_spec_and_default_system():
    assert thw.H100_SXM == thw.XPUSpec("H100-SXM", 989, 80, 3.35e12, 450e9)
    assert thw.SystemConfig().xpu is thw.H100_SXM
    for name in ("XPU_A", "XPU_B", "XPU_C"):     # the paper's Table 2
        assert dataclasses.asdict(getattr(thw, name)) == \
            dataclasses.asdict(getattr(jhw, name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_frontier_matches_golden(case):
    with open(os.path.join(GOLDEN_DIR, "frontiers.json")) as f:
        golden = json.load(f)[case]
    system = thw.SystemConfig(n_servers=4, xpu=thw.XPU_C)
    plans = topt.enumerate_plans(_port_schema(CASES[case]), system)
    assert json.loads(json.dumps([plan_record(p) for p in plans])) == golden


def _plan_fields(plan) -> dict:
    return {"placement": plan.placement, "group_chips": plan.group_chips,
            "decode_chips": plan.decode_chips, "n_servers": plan.n_servers,
            "stage_batches": plan.stage_batches,
            "iter_batch": plan.iter_batch, "predicted": plan.predicted,
            "describe": plan.describe(),
            "engine_config": dataclasses.asdict(plan.engine_config())}


@pytest.mark.parametrize("xpu", sorted(XPUS))
@pytest.mark.parametrize("preset", sorted(jpipes.PRESETS))
def test_plan_and_engine_fields_match_jax(preset, xpu):
    jschema = jpipes.PRESETS[preset]()
    tschema = tpipes.PRESETS[preset]()
    assert tschema == _port_schema(jschema)
    jsys, tsys = _systems(xpu, n_servers=2)
    want = JServingPlan.optimize(jschema, jsys)
    got = ServingPlan.optimize(tschema, tsys)
    assert _plan_fields(got) == _plan_fields(want)
    assert REGISTRY.engine_config_fields(tschema) == \
        JREGISTRY.engine_config_fields(jschema)
    assert REGISTRY.pipeline(tschema) == JREGISTRY.pipeline(jschema)
    over = {"decode_slots": 3, "retrieval_backend": "exact"}
    assert dataclasses.asdict(te.EngineConfig.from_schema(tschema, **over)) \
        == dataclasses.asdict(jengine.EngineConfig.from_schema(jschema,
                                                               **over))


@pytest.mark.parametrize("xpu", sorted(XPUS))
def test_one_xpu_system_raises_as_in_jax(xpu):
    """The reference cannot plan a single chip; neither can the copy."""
    jsys, tsys = _systems(xpu, n_servers=1, xpus_per_server=1)
    with pytest.raises(ValueError) as want:
        JServingPlan.optimize(jpipes.iterative(), jsys)
    with pytest.raises(ValueError) as got:
        ServingPlan.optimize(tpipes.iterative(), tsys)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Deploy: from_plan -> serve against the JAX from_plan engine
# ---------------------------------------------------------------------------

#: test-scale clamps of each plan; iterative retrieval every 3 tokens, since
#: the schema's interval (decode_len / frequency = 64) outlasts 9 tokens
DEPLOY = {"baseline": {"max_new_tokens": 6},
          "iterative": {"max_new_tokens": 9, "iterative_interval": 3}}


@pytest.mark.parametrize("preset", sorted(DEPLOY))
def test_from_plan_serves_as_jax(stack, preset):
    gen, enc, corpus, questions = stack
    jsys, tsys = _systems("XPU-C", n_servers=2)
    jplan = JServingPlan.optimize(jpipes.PRESETS[preset](), jsys)
    plan = ServingPlan.optimize(tpipes.PRESETS[preset](), tsys)
    over = {"decode_slots": 3, "s_max": 96, **DEPLOY[preset]}
    jserver = JRAGServer.from_plan(jplan, gen, enc, corpus, attn_impl="ref",
                                   **over)
    jeng = jserver.engine
    assert jeng.cfg.retrieval_backend == "ivfpq"
    jreqs = [JRequest(question=q.copy()) for q in questions]
    jeng.serve(jreqs)
    server = RAGServer.from_plan(plan, _port(gen), _port(enc), corpus,
                                 device="cpu", **over)
    teng = server.engine
    # the JAX index in place of the port's own: k-means seeds differ by
    # framework (the fallback chain as the engine builds it)
    idx = jeng.backend.chain[0].index
    teng.backend = FallbackBackend([
        IVFPQBackend.from_index(
            bridge.index_from_jax(idx.centroids, idx.codebooks, idx.list_ids,
                                  idx.list_codes, idx.n_vectors,
                                  device="cpu"),
            nprobe=jeng.cfg.nprobe, device="cpu"),
        ExactBackend(teng.db_vectors, device="cpu")])
    assert dataclasses.asdict(teng.cfg) == dataclasses.asdict(
        jplan.engine_config(**over))
    assert teng.attn_impl == "ref" and teng.seq_attn is None
    treqs = [Request(question=q.copy()) for q in questions]
    teng.serve(treqs)
    _compare_streams(stack, jreqs, treqs)
    assert [r.retrievals_done for r in treqs] == \
        [r.retrievals_done for r in jreqs]
    if preset == "iterative":
        assert all(r.retrievals_done >= 1 for r in treqs)


def test_disaggregated_topology_is_not_ported(stack):
    """The name dates from before the cluster was ported: ``"disagg"``
    now deploys the plan's groups, and an unknown topology still raises."""
    gen, enc, corpus, _ = stack
    plan = ServingPlan.optimize(tpipes.baseline(), thw.SystemConfig(
        n_servers=2, xpu=thw.XPU_C))
    server = RAGServer.from_plan(plan, _port(gen), _port(enc), corpus,
                                 topology="disagg", device="cpu",
                                 decode_slots=2, s_max=96, max_new_tokens=4)
    assert server.engine is None
    assert (len(server.cluster.prefill_engines),
            len(server.cluster.decode_engines)) == plan.group_sizes()
    with pytest.raises(ValueError, match="topology"):
        RAGServer.from_plan(plan, _port(gen), _port(enc), corpus,
                            topology="mesh", device="cpu")


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

def test_replay_trace_ends_every_request_done(stack, tmp_path):
    gen, enc, corpus, questions = stack
    plan = ServingPlan.optimize(tpipes.baseline(), thw.SystemConfig(
        n_servers=2, xpu=thw.XPU_C))
    server = RAGServer.from_plan(plan, _port(gen), _port(enc), corpus,
                                 device="cpu", decode_slots=2, s_max=96,
                                 max_new_tokens=4)
    entries = [ttrace.TraceEntry(arrival_s=0.01 * i, question=q,
                                 max_new_tokens=3 if i % 2 else None)
               for i, q in enumerate(questions)]
    path = tmp_path / "trace.jsonl"
    ttrace.save_trace(path, entries)
    handles = server.replay_trace(path)
    assert len(handles) == len(questions)
    assert all(h.state is State.DONE for h in handles)
    assert [len(h.output) for h in handles] == \
        [3 if i % 2 else 4 for i in range(len(questions))]
    assert server.replay_trace([]) == []


def _entries(entries) -> list:
    return [(e.arrival_s, e.question.tolist(), e.max_new_tokens,
             e.deadline_s, e.preset) for e in entries]


@pytest.mark.parametrize("make", [
    lambda m: m.synthesize_trace(40, 64, presets=("hyde", "iterative"),
                                 deadline_s=2.0, seed=3),
    lambda m: m.bursty_trace(30, 64, max_new_tokens=5, seed=3)],
    ids=["synthesize", "bursty"])
def test_trace_generators_match_jax(make, tmp_path):
    want, got = make(jtrace), make(ttrace)
    assert _entries(got) == _entries(want)
    ttrace.save_trace(tmp_path / "t.jsonl", got)
    jtrace.save_trace(tmp_path / "j.jsonl", want)
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert _entries(ttrace.load_trace(tmp_path / "j.jsonl")) == \
        _entries(jtrace.load_trace(tmp_path / "j.jsonl"))
