"""Port vs JAX: the live control plane on the CPU.

* ``DriftDetector`` makes the JAX detector's decisions on the same
  measurement sequences.
* ``measured_specs`` and ``replan_and_resize`` give the JAX controller's
  calibrated specs, re-plan and targets when both read the same engine
  metrics (the JAX controller is pointed at the port's cluster: it only
  reads counters and stage times).
* Make-before-break ``resize`` drops no request and keeps every output,
  a drain racing a crash is aborted (``undrain``), and the controller's
  loop re-plans and resizes on a load shift with zero drops.

The stack is ``tests/test_torch_engine.py``'s.
"""

import dataclasses
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.configs import rag_pipelines as jpipes
from repro.core import hardware as jhw
from repro.core.serving_plan import ServingPlan as JServingPlan
from repro.serving import controller as jctl
from repro_torch.configs import rag_pipelines as tpipes
from repro_torch.core import hardware as thw
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.serving import engine as te
from repro_torch.serving.cluster import RAGCluster
from repro_torch.serving.controller import (ClusterController, DriftDetector,
                                            TelemetrySample,
                                            collect_telemetry)
from repro_torch.serving.faults import (EngineHealth, FaultInjector,
                                        FaultPlan)
from repro_torch.serving.request import State
from repro_torch.serving.server import RAGServer
from test_torch_engine import _port, stack  # noqa: F401

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# DriftDetector against JAX's
# ---------------------------------------------------------------------------

def _sequence(seed: int, n: int = 60) -> list:
    """Measurements around a reference of 1.0: noise, regime shifts, gaps
    (None) and values inside the hysteresis band."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.integers(5)
        ref = None if rng.random() < 0.05 else 1.0
        if kind == 0:
            out.append((None, ref))
        elif kind == 1:
            out.append((float(rng.uniform(0.9, 1.1)), ref))
        elif kind == 2:
            out.append((float(rng.uniform(1.25, 1.45)), ref))
        else:
            out.append((float(rng.uniform(1.6, 4.0)), ref))
    return out


@pytest.mark.parametrize("band,clear,patience",
                         [(0.5, 0.2, 3), (1.0, 0.5, 3), (0.5, 0.2, 1),
                          (0.3, 0.1, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_detector_decides_as_jax(band, clear, patience, seed):
    t = DriftDetector(band=band, clear_band=clear, patience=patience)
    j = jctl.DriftDetector(band=band, clear_band=clear, patience=patience)
    for i, (m, ref) in enumerate(_sequence(seed)):
        assert t.update(m, ref) == j.update(m, ref), i
        assert (t.streak, t.last_deviation) == (j.streak, j.last_deviation)
        if i == 30:
            t.reset()
            j.reset()


def test_drift_detector_refuses_what_jax_refuses():
    for kw in ({"band": 0.3, "clear_band": 0.3},
               {"band": 0.3, "clear_band": 0.5}, {"patience": 0},
               {"band": 0.0}):
        with pytest.raises(ValueError):
            jctl.DriftDetector(**kw)
        with pytest.raises(ValueError):
            DriftDetector(**kw)


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

def _make_cluster(stack, injector=None, n_prefill=2, n_decode=2, **kw):
    gen, enc, corpus, _ = stack
    kw.setdefault("decode_slots", 2)
    kw.setdefault("s_max", 96)
    kw.setdefault("max_new_tokens", 4)
    cfg = te.EngineConfig(**kw)
    g, e = _port(gen), _port(enc)
    first = te.RAGEngine(g, e, corpus, replace(cfg, decode_slots=1),
                         device="cpu")
    shared = dict(db_vectors=first.db_vectors, backend=first.backend,
                  device="cpu")
    prefill = [first] + [te.RAGEngine(g, e, corpus,
                                      replace(cfg, decode_slots=1), **shared)
                         for _ in range(n_prefill - 1)]
    decode = [te.RAGEngine(g, e, corpus, cfg, **shared)
              for _ in range(n_decode)]
    cluster = RAGCluster(prefill, decode, injector=injector,
                         retry_backoff=0.001)

    def factory(group):
        return te.RAGEngine(g, e, corpus,
                            replace(cfg, decode_slots=1)
                            if group == "prefill" else cfg, **shared)
    return cluster, factory


def _assert_no_leaks(cluster):
    assert not cluster.queue and not cluster.handoff and not cluster.retrying
    for eng in (cluster.prefill_engines + cluster.decode_engines
                + [e for _g, _eid, e in cluster.retired]):
        assert not eng.active and not eng.pending_retrievals
        assert not eng.prefilling
        assert sorted(eng.pool.free) == list(range(eng.pool.n_slots))
        assert int(np.sum(eng.pool.ref)) == 0


@pytest.fixture(scope="module")
def baseline(stack):
    """Undisturbed 2+2 run: the outputs every resized run must match."""
    cluster, _ = _make_cluster(stack)
    server = RAGServer(cluster)
    handles = [server.submit(q) for q in stack[3]]
    server.run_until_idle(max_steps=5000)
    assert all(h.request.state is State.DONE for h in handles)
    return [h.request.output for h in handles]


def _systems():
    """``baseline`` on 4 XPU-C servers in both packages (as the JAX
    controller test plans it)."""
    return ((tpipes.baseline(), thw.SystemConfig(n_servers=4,
                                                 xpu=thw.XPU_C)),
            (jpipes.baseline(), jhw.SystemConfig(n_servers=4,
                                                 xpu=jhw.XPU_C)))


def _plan_fields(plan) -> dict:
    return {"placement": plan.placement, "group_chips": plan.group_chips,
            "decode_chips": plan.decode_chips, "n_servers": plan.n_servers,
            "stage_batches": plan.stage_batches,
            "iter_batch": plan.iter_batch, "predicted": plan.predicted,
            "detail": plan.detail, "describe": plan.describe(),
            "engine_config": dataclasses.asdict(plan.engine_config())}


class _JServer:
    """What the JAX controller reads of a server: the cluster."""

    def __init__(self, cluster):
        self.cluster = cluster


def test_measured_specs_and_replan_match_jax(stack):
    (tschema, tsys), (jschema, jsys) = _systems()
    cluster, factory = _make_cluster(stack, n_prefill=1, n_decode=1)
    server = RAGServer(cluster)
    for q in stack[3]:
        server.submit(q)
    server.run_until_idle()
    tplan = ServingPlan.optimize(tschema, tsys)
    ctl = ClusterController(server, tschema, tsys, tplan,
                            engine_factory=factory, reference_qps=1.0,
                            max_engines=2)
    jc = jctl.ClusterController(_JServer(cluster), jschema, jsys,
                                JServingPlan.optimize(jschema, jsys),
                                reference_qps=1.0, max_engines=2)
    txpu, thost, trec = ctl.measured_specs()
    jxpu, jhost, jrec = jc.measured_specs()
    assert trec == jrec == {"xpu_prefill": True, "xpu_decode": True,
                            "host": True}
    assert dataclasses.asdict(txpu) == dataclasses.asdict(jxpu)
    assert dataclasses.asdict(thost) == dataclasses.asdict(jhost)
    # the JAX controller's re-plan, its resize recorded instead of run
    sample = TelemetrySample(t=0.0, window_s=2.0, offered_qps=2.6,
                             goodput_qps=2.0, n_arrived=5, n_done=5,
                             ttft_p99=0.1, tpot_p99=0.01, queue_depth=0,
                             handoff_depth=0, retrying_depth=0, n_prefill=1,
                             n_decode=1)
    jtargets = []
    jc.resize = lambda p, d, now=None: jtargets.append((p, d))
    jc.replan_and_resize(sample, now=5.0, trigger="load")
    ctl.replan_and_resize(sample, now=5.0, trigger="load")
    assert _plan_fields(ctl.plan) == _plan_fields(jc.plan)
    assert ctl.plan.detail["calibration"]
    tev, jev = ctl.events[0], jc.events[0]
    assert tev == jev
    assert jtargets == [(tev["target"]["prefill"], tev["target"]["decode"])]
    # the port's resize ran: the targets stand, the new engines are idle
    assert len(cluster.decode_engines) == tev["target"]["decode"] == 2
    assert len(cluster.prefill_engines) == tev["target"]["prefill"]
    assert ctl.reference_qps == 2.6 and ctl.reference_ttft_p99 is None
    assert ctl.resizes == 1 and ctl.replans == 1


def test_drain_migrates_all_requests_bit_identical(stack, baseline):
    """Zero drop: drain a decode engine that holds mid-generation
    requests; all end DONE with the undisturbed outputs, no retry budget
    spent, and the engine is reaped."""
    cluster, _ = _make_cluster(stack)
    server = RAGServer(cluster)
    handles = [server.submit(q) for q in stack[3]]
    victim = cluster.decode_engines[1]
    for _ in range(200):
        server.step()
        if victim.active:
            break
    assert victim.active
    migrating = {r.rid for r in victim.active.values()}
    cluster.drain_engine(victim)
    assert victim.health is EngineHealth.DRAINING
    server.run_until_idle(max_steps=5000)
    assert [h.request.output for h in handles] == baseline
    assert all(h.request.state is State.DONE for h in handles)
    assert len(cluster.decode_engines) == 1
    assert cluster.retired and cluster.retired[0][:2] == ("decode", 1)
    assert cluster.metrics["engines_removed"] == 1
    assert cluster.metrics["requests_migrated"] >= len(migrating)
    assert all(h.request.retries == 0 for h in handles)
    assert all(h.request.migrations >= 1 for h in handles
               if h.rid in migrating)
    assert cluster.metrics["requests_retried"] == 0
    _assert_no_leaks(cluster)


def test_resize_make_before_break_drops_nothing(stack, baseline):
    """``resize(2, 3)`` after the first arrivals, ``resize(2, 2)`` later:
    one engine added, the newest drained and reaped, no request lost and
    the outputs undisturbed."""
    (tschema, tsys), _ = _systems()
    cluster, factory = _make_cluster(stack)
    server = RAGServer(cluster)
    ctl = ClusterController(server, tschema, tsys,
                            ServingPlan.optimize(tschema, tsys),
                            engine_factory=factory)
    handles = [server.submit(q) for q in stack[3][:2]]
    server.step()
    assert ctl.resize(2, 3) == {"added": {"prefill": 0, "decode": 1},
                                "drained": {"prefill": 0, "decode": 0}}
    handles += [server.submit(q) for q in stack[3][2:]]
    for _ in range(3):
        server.step()
    added = cluster.decode_engines[2]
    assert ctl.resize(2, 2)["drained"] == {"prefill": 0, "decode": 1}
    assert added.health is EngineHealth.DRAINING
    server.run_until_idle(max_steps=5000)
    assert [h.request.output for h in handles] == baseline
    m = cluster.metrics
    assert m["engines_added"] == m["engines_removed"] == 1
    assert cluster.retired == [("decode", 2, added)]
    assert sorted(added.pool.free) == list(range(added.pool.n_slots))
    assert ctl.resizes == 2 and len(ctl.events) == 2
    _assert_no_leaks(cluster)
    with pytest.raises(ValueError, match="engine_factory"):
        ClusterController(server, tschema, tsys, ctl.plan).resize(3, 2)


def test_drain_racing_a_crash_is_aborted(stack, baseline):
    """Engine 0 crashes; the drain of engine 1 lands in the same window:
    the sweep un-drains it (DRAINING -> DEGRADED) and every request ends
    terminal, the DONE ones with the undisturbed outputs."""
    inj = FaultInjector(FaultPlan.from_schedule(
        [{"point": "decode_crash", "at": 3, "engine": 0}], seed=7))
    cluster, _ = _make_cluster(stack, injector=inj)
    server = RAGServer(cluster)
    handles = [server.submit(q) for q in stack[3]]
    target = cluster.decode_engines[1]
    for _ in range(300):
        server.step()
        if inj.log:
            break
    assert cluster.decode_engines[0].health is EngineHealth.DEAD
    with pytest.raises(ValueError, match="last accepting"):
        cluster.drain_engine(target)
    cluster.drain_engine(target, force=True)
    server.run_until_idle(max_steps=5000)
    assert target.health is EngineHealth.DEGRADED
    assert cluster.metrics["drains_aborted"] >= 1
    assert len(cluster.decode_engines) == 2
    assert all(h.request.done for h in handles)
    assert any(h.request.state is State.DONE for h in handles)
    for h, ref in zip(handles, baseline):
        if h.request.state is State.DONE and not h.request.degraded:
            assert h.request.output == ref
    _assert_no_leaks(cluster)


def test_controller_drift_replan_resize_end_to_end(stack):
    """A burst far above the reference load trips the detector, the
    controller re-plans on calibrated specs and grows the cluster, and no
    request is dropped."""
    (tschema, tsys), _ = _systems()
    cluster, factory = _make_cluster(stack, n_prefill=1, n_decode=1)
    server = RAGServer(cluster)
    ctl = ClusterController(
        server, tschema, tsys, ServingPlan.optimize(tschema, tsys),
        engine_factory=factory, window_s=5.0, interval_s=0.0,
        reference_qps=0.25,
        load_detector=DriftDetector(band=0.5, clear_band=0.2, patience=2),
        max_engines=2, min_window_arrivals=2, settle_s=0.0)
    ctl.attach()
    handles = [server.submit(q) for q in stack[3]]
    server.run_until_idle(max_steps=5000)
    assert ctl.replans >= 1 and ctl.resizes >= 1
    replan = next(e for e in ctl.events if e["event"] == "replan")
    assert replan["trigger"] == "load"
    assert any(replan["calibrated"].values()) and replan["calibration"]
    assert len(cluster.decode_engines) == 2
    assert all(h.request.state is State.DONE for h in handles)
    assert cluster.metrics["retries_exhausted"] == 0
    assert ctl.history
    _assert_no_leaks(cluster)


def test_collect_telemetry_windows(stack):
    cluster, _ = _make_cluster(stack)
    server = RAGServer(cluster)
    handles = [server.submit(q) for q in stack[3]]
    server.run_until_idle(max_steps=5000)
    wide = collect_telemetry(server, window_s=3600.0)
    assert wide.n_arrived == wide.n_done == len(handles)
    assert wide.ttft_p99 > 0 and wide.tpot_p99 > 0
    assert (wide.n_prefill, wide.n_decode) == (2, 2)
    assert wide.health == {"prefill": ["healthy"] * 2,
                           "decode": ["healthy"] * 2}
    late = collect_telemetry(server, window_s=1e-9,
                             now=time.monotonic() + 100.0)
    assert late.n_arrived == late.n_done == 0 and late.ttft_p99 is None
    # a collocated server has no groups
    gen, enc, corpus, _ = stack
    single = RAGServer(te.RAGEngine(_port(gen), _port(enc), corpus,
                                    te.EngineConfig(decode_slots=2, s_max=96,
                                                    max_new_tokens=4),
                                    device="cpu"))
    single.submit(stack[3][0])
    single.run_until_idle()
    s = collect_telemetry(single, window_s=3600.0)
    assert s.n_done == 1 and s.health == {"engine": "healthy"}
    with pytest.raises(ValueError, match="disaggregated"):
        ClusterController(single, *_systems()[0], None)
