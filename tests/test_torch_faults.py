"""Port vs JAX: the fault injector, and the chaos matrix on a port
cluster on the CPU.

* The port's ``FaultInjector`` fires, logs and corrupts as the JAX one
  does for the same plan and the same call sequence (the same byte of a
  bf16 page flips: bf16 travels as int16 bits).
* Every ``CHAOS_SCHEDULES`` entry runs on a port 2-prefill + 2-decode
  cluster: every request ends in exactly one terminal state, no slot or
  page leaks, every non-degraded DONE request has the unfaulted run's
  tokens (retry parity), and the schedule fired.  Then one test per
  degradation path, as in ``tests/test_faults.py``.

The stack is ``tests/test_torch_engine.py``'s, on the engines' default
exact backend, as the JAX chaos matrix runs.
"""

import time
from dataclasses import replace

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro.serving import kv_cache as jkv
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as te
from repro_torch.serving import faults as tfaults
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.cluster import RAGCluster
from repro_torch.serving.faults import (CHAOS_SCHEDULES, EngineHealth,
                                        FaultInjector, FaultPlan)
from repro_torch.serving.request import TERMINAL_STATES, State
from repro_torch.serving.server import RAGServer
from test_torch_engine import _port, stack  # noqa: F401

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the injector against JAX's
# ---------------------------------------------------------------------------

CALLS = [("decode_crash", 0, None), ("decode_crash", 1, None),
         ("handoff_corrupt", 1, 3), ("stage_error", None, 7),
         ("decode_crash", 1, None), ("handoff_corrupt", 1, 4),
         ("retrieval_timeout", None, None), ("handoff_corrupt", 0, 5),
         ("handoff_corrupt", 1, 5), ("decode_crash", 0, None),
         ("retrieval_timeout", None, None), ("retrieval_blackout", None,
                                             None)]

PLANS = {**CHAOS_SCHEDULES,
         "filtered": [{"point": "handoff_corrupt", "at": 2, "count": 2,
                       "engine": 1},
                      {"point": "stage_error", "rid": 7},
                      {"point": "decode_crash", "at": 2, "engine": 0}]}


def _page(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 5, 2, 8)).astype(dtype)


def _jax_prefix(bf):
    """The JAX pool's payload for one bf16 page (ml_dtypes arrays)."""
    return jkv.PagedPrefix(4, 5, [None], {0: {"k": bf.copy(),
                                              "v": bf.copy()}})


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_injector_fires_and_corrupts_as_jax(plan):
    tinj = FaultInjector(FaultPlan.from_schedule(PLANS[plan], seed=11))
    jinj = jfaults.FaultInjector(jfaults.FaultPlan.from_schedule(
        PLANS[plan], seed=11))
    for point, eng, rid in CALLS:
        got = tinj.fire(point, engine=eng, rid=rid)
        want = jinj.fire(point, engine=eng, rid=rid)
        assert (got is None) == (want is None), (point, eng, rid)
    assert tinj.log == jinj.log
    # the same payload twice: the port's bf16 page as int16 bits, JAX's as
    # ml_dtypes bfloat16 of the same bits, and an f32 dense payload
    for _ in range(3):
        bf = _page(ml_dtypes.bfloat16)
        tpay = tkv.PagedPrefix(4, 5, [None], {0: {"k": bf.view(np.int16),
                                                 "v": bf.view(np.int16)}})
        jpay = _jax_prefix(bf)
        tinj.corrupt(tpay)
        jinj.corrupt(jpay)
        np.testing.assert_array_equal(
            tpay.pages[0]["k"].view(np.uint8),
            np.asarray(jpay.pages[0]["k"]).view(np.uint8))
        f32 = {"k": _page(np.float32, 1), "v": _page(np.float32, 2)}
        jf32 = {k: v.copy() for k, v in f32.items()}
        tinj.corrupt(f32)
        jinj.corrupt(jf32)
        np.testing.assert_array_equal(f32["k"], jf32["k"])
    assert not np.array_equal(f32["k"], _page(np.float32, 1))


def test_injector_refuses_bad_specs_as_jax():
    for bad in ([{"point": "not_a_point"}], [{"point": "stage_error",
                                              "at": 0}]):
        with pytest.raises(ValueError):
            jfaults.FaultInjector(jfaults.FaultPlan.from_schedule(bad))
        with pytest.raises(ValueError):
            FaultInjector(FaultPlan.from_schedule(bad))
    assert tfaults.CHAOS_SCHEDULES == jfaults.CHAOS_SCHEDULES
    assert tfaults.FaultInjector.POINTS == jfaults.FaultInjector.POINTS
    assert not FaultInjector(FaultPlan()).tracer.enabled


def test_checksum_catches_the_corruption_of_an_export():
    pool = tkv.PagedKVCachePool(
        tr.TransformerConfig(name="ck", n_layers=2, d_model=32, n_heads=4,
                             n_kv_heads=2, d_head=8, d_ff=64, vocab_size=64),
        2, 16, page_size=4, device="cpu")
    slot = pool.alloc(1)
    cache = {k: torch.randn(2, 1, 11, 2, 8).to(torch.bfloat16)
             for k in ("k", "v")}
    pool.write_prefix(slot, cache, 11)
    kv, _ = pool.export_slot(slot)
    before = tkv.payload_checksum(kv)
    assert tkv.payload_checksum(kv) == before
    FaultInjector(FaultPlan(seed=3)).corrupt(kv)
    assert tkv.payload_checksum(kv) != before


# ---------------------------------------------------------------------------
# the chaos matrix on a 2+2 port cluster
# ---------------------------------------------------------------------------

def _make_cluster(stack, injector=None, n_prefill=2, n_decode=2, **kw):
    gen, enc, corpus, _ = stack
    cluster_kw = {k: kw.pop(k) for k in
                  ("max_retries", "retry_backoff", "brownout_headroom")
                  if k in kw}
    cluster_kw.setdefault("retry_backoff", 0.001)
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
    return RAGCluster(prefill, decode, injector=injector, **cluster_kw)


def _serve(stack, injector=None, **kw):
    cluster = _make_cluster(stack, injector, **kw)
    server = RAGServer(cluster)
    handles = [server.submit(q, max_new_tokens=4) for q in stack[3]]
    server.run_until_idle(max_steps=5000)
    return cluster, server, handles


def _assert_no_leaks(cluster):
    """Every pool back to idle: no waiting or in-flight work and every
    page refcount zero."""
    assert not cluster.queue and not cluster.handoff and not cluster.retrying
    for eng in cluster.prefill_engines + cluster.decode_engines:
        assert not eng.active and not eng.pending_retrievals
        assert not eng.prefilling
        assert sorted(eng.pool.free) == list(range(eng.pool.n_slots))
        assert int(np.sum(eng.pool.ref)) == 0


@pytest.fixture(scope="module")
def unfaulted(stack):
    cluster, _, handles = _serve(stack)
    assert all(h.request.state is State.DONE for h in handles)
    _assert_no_leaks(cluster)
    return [h.request.output for h in handles]


@pytest.mark.parametrize("schedule", sorted(CHAOS_SCHEDULES))
def test_chaos_schedule_terminates_and_recovers(stack, unfaulted, schedule):
    inj = FaultInjector(
        FaultPlan.from_schedule(CHAOS_SCHEDULES[schedule], seed=7))
    cluster, _, handles = _serve(stack, inj)
    assert len(inj.log) > 0, "schedule never fired"
    fired = {entry[0] for entry in inj.log}
    assert fired <= {s["point"] for s in CHAOS_SCHEDULES[schedule]}
    for h in handles:
        assert h.request.state in TERMINAL_STATES
        assert sum(s in TERMINAL_STATES
                   for s in h.request.state_history) == 1
    _assert_no_leaks(cluster)
    for h, expected in zip(handles, unfaulted):
        if h.request.state is State.DONE and not h.request.degraded:
            assert h.request.output == expected    # retry parity


def test_decode_crash_recovers_via_reprefill(stack, unfaulted):
    inj = FaultInjector(
        FaultPlan.from_schedule(CHAOS_SCHEDULES["decode_crash"], seed=0))
    cluster, _, handles = _serve(stack, inj)
    assert cluster.metrics["engine_failures"] == 1
    assert cluster.metrics["requests_retried"] >= 1
    assert any(e.health is EngineHealth.DEAD
               for e in cluster.decode_engines)
    assert [h.request.output for h in handles] == unfaulted
    assert any(len(hist) > 1 for hist in cluster.decode_history.values())


def test_corrupt_handoff_never_decodes(stack, unfaulted):
    inj = FaultInjector(
        FaultPlan.from_schedule(CHAOS_SCHEDULES["handoff_corrupt"], seed=5))
    cluster, _, handles = _serve(stack, inj)
    assert cluster.metrics["handoff_corrupt"] == 2
    assert [h.request.output for h in handles] == unfaulted


def test_retrieval_blackout_yields_flagged_degraded_answer(stack):
    inj = FaultInjector(FaultPlan.from_schedule(
        CHAOS_SCHEDULES["retrieval_blackout"], seed=0))
    cluster, _, handles = _serve(stack, inj)
    assert all(h.request.state is State.DONE for h in handles)
    degraded = [h.request for h in handles if h.request.degraded]
    assert degraded
    summary = cluster.group_summary()["scheduler"]
    assert summary["retrieval_no_context"] >= 1
    assert summary["degraded_answers"] == len(degraded)


def test_retry_budget_exhaustion_fails_terminally(stack):
    inj = FaultInjector(FaultPlan.from_schedule(
        [{"point": "handoff_drop", "at": 1, "count": 10_000}]))
    cluster, _, handles = _serve(stack, inj, max_retries=2)
    assert all(h.request.state is State.FAILED for h in handles)
    assert all("retry budget exhausted" in h.request.fail_reason
               for h in handles)
    assert cluster.metrics["retries_exhausted"] == len(handles)
    _assert_no_leaks(cluster)


def test_all_decode_engines_dead_fails_waiting_requests(stack):
    cluster = _make_cluster(stack, n_decode=1)
    cluster.decode_engines[0].fail("pulled the plug")
    server = RAGServer(cluster)
    handles = [server.submit(q, max_new_tokens=4) for q in stack[3]]
    server.run_until_idle(max_steps=200)
    assert all(h.request.state is State.FAILED for h in handles)
    assert cluster.metrics["failed_no_capacity"] == len(handles)
    _assert_no_leaks(cluster)


def test_brownout_sheds_lowest_urgency_first(stack):
    cluster = _make_cluster(stack, n_decode=2, decode_slots=1,
                            brownout_headroom=2.0)
    cluster.decode_engines[1].fail("injected")
    server = RAGServer(cluster)
    now = time.monotonic()
    questions = stack[3]
    with_deadline = [server.submit(q, max_new_tokens=4, deadline=now + 60)
                     for q in questions[:2]]
    no_deadline = [server.submit(q, max_new_tokens=4)
                   for q in questions[2:]]
    server.run_until_idle(max_steps=5000)
    shed = [h for h in with_deadline + no_deadline
            if h.request.fail_reason == "brownout shed"]
    assert cluster.metrics["brownout_shed"] == len(shed) > 0
    assert all(h.request.deadline is None for h in shed)
    assert all(h.request.state is State.DONE for h in with_deadline)
    _assert_no_leaks(cluster)


def test_retry_backoff_pool_honors_deadline(stack):
    inj = FaultInjector(FaultPlan.from_schedule(
        [{"point": "handoff_drop", "at": 1, "count": 10_000}]))
    cluster = _make_cluster(stack, inj, max_retries=50, retry_backoff=30.0)
    server = RAGServer(cluster)
    h = server.submit(stack[3][0], max_new_tokens=4,
                      deadline=time.monotonic() + 1.0)
    while not h.done and time.monotonic() < h.request.deadline + 2.0:
        server.step()
        time.sleep(0.01)
    assert h.request.state is State.EXPIRED
    assert State.RETRYING in h.request.state_history
    assert cluster.metrics["expired_retrying"] >= 1
    _assert_no_leaks(cluster)


def test_faults_disabled_is_bit_transparent(stack, unfaulted):
    inj = FaultInjector(FaultPlan())
    cluster, _, handles = _serve(stack, inj)
    assert [h.request.output for h in handles] == unfaulted
    assert inj.log == []
    m = cluster.metrics
    assert (m["engine_failures"] == m["requests_retried"]
            == m["handoff_corrupt"] == m["handoff_dropped"]
            == m["brownout_shed"] == 0)
