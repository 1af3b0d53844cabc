"""Live control plane for the port (mirror of
``repro.serving.controller``): telemetry -> drift detection -> calibrated
re-plan -> zero-drop cluster resize.

RAGO's optimizer is an *offline* instrument: it searches placement /
allocation / batching once, against nominal hardware specs and an assumed
load, and the plan is frozen into the deployment.  Real RAG traffic
(RAGPulse) is nothing like an assumption: diurnal rate swings, bursts,
and heavy-tailed lengths move the operating point far from where any
single plan is optimal.  This module closes the loop at runtime:

1. **Windowed telemetry** (:func:`collect_telemetry`): rolling offered
   QPS, queue depths, and p99 TTFT / TPOT per engine group over the last
   ``window_s`` seconds -- the *current regime*, not lifetime aggregates
   that dilute a shift under hours of history.
2. **Drift detection** (:class:`DriftDetector`): a measured signal is
   compared against its reference with a hysteresis band -- deviation
   beyond ``band`` for ``patience`` consecutive windows trips the
   detector, and the streak only resets once the deviation falls back
   inside the tighter ``clear_band`` (values in the gap hold), so a
   single burst window or a noisy tail sample cannot flap the cluster.
3. **Calibrated re-plan**: before re-running ``ServingPlan.optimize``
   the controller *measures* the deployment -- prefill stage times fit
   ``flops_eff``/``mem_eff`` (``cost_model.calibrate_xpu``), the decode
   slowdown vs the roofline pins the achieved decode bandwidth
   (``calibrate_xpu_decode``), and retrieval scan traffic over
   ``stage_time_s['retrieve']`` yields the real host scan bandwidth
   (``retrieval_model.calibrate_host``) -- so the search prices plans on
   the machine it is actually running on.  ``plan.detail["calibration"]``
   records what was applied.
4. **Zero-drop resize** (:meth:`ClusterController.resize`):
   make-before-break -- new engines (built and warmed by the caller's
   ``engine_factory``) join their group *before* surplus engines are
   parked in ``EngineHealth.DRAINING``; the cluster's health sweep
   migrates their in-flight requests through the re-prefill path
   (``Request.migrations``, never charged against the fault-retry
   budget) and reaps them once empty.  A resize can delay a request; it
   can never drop one.

Scaling policy: replica counts scale with the *offered-load ratio*
against the regime the current plan was calibrated for (the classic
load-proportional rule), while the re-planned ``ServingPlan`` contributes
the prefill:decode *shape* of the cluster and the calibrated cost model
behind it.  Brownout shedding remains the only pressure valve while a
resize is in flight.

Wiring::

    controller = ClusterController(server, schema, system, plan,
                                   engine_factory=make_engine)
    controller.attach()          # hooks RAGServer.step()
    server.replay_trace(trace)   # control runs in-band with serving
    controller.events            # every replan/resize, auditable
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.cost_model import (calibrate_xpu, calibrate_xpu_decode,
                                         decode_tpot)
from repro_torch.core.retrieval_model import calibrate_host
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.serving.cluster import RAGCluster


@dataclass
class TelemetrySample:
    """One rolling-window snapshot of the serving regime."""
    t: float                         # engine clock (time.monotonic)
    window_s: float
    offered_qps: float               # arrivals/s in window (shed or not)
    goodput_qps: float               # completions/s in window
    n_arrived: int
    n_done: int
    ttft_p99: float | None           # prefill group tail, window
    tpot_p99: float | None           # decode group tail, window
    queue_depth: int
    handoff_depth: int
    retrying_depth: int
    n_prefill: int
    n_decode: int
    health: dict = field(default_factory=dict)


def collect_telemetry(server, *, window_s: float,
                      now: float | None = None) -> TelemetrySample:
    """Sample the current regime from a running :class:`RAGServer` over a
    rolling window: offered load by arrival time, completions and TPOT by
    finish time, TTFT by first-token time (the windowed ``summary`` /
    ``group_summary`` semantics), plus instantaneous queue depths."""
    now = time.monotonic() if now is None else now
    s = server.summary(window_s=window_s, now=now)
    cluster: RAGCluster | None = server.cluster
    if cluster is not None:
        g = cluster.group_summary(window_s=window_s, now=now)
        depths = g["depths"]
        return TelemetrySample(
            t=now, window_s=window_s,
            offered_qps=s["offered_qps"], goodput_qps=s["qps"],
            n_arrived=s["n_arrived"], n_done=s["n_done"],
            ttft_p99=g["prefill"]["ttft_s"]["p99"],
            tpot_p99=g["decode"]["tpot_s"]["p99"],
            queue_depth=depths["queue"], handoff_depth=depths["handoff"],
            retrying_depth=depths["retrying"],
            n_prefill=g["prefill"]["n_engines"],
            n_decode=g["decode"]["n_engines"],
            health=g["health"])
    return TelemetrySample(
        t=now, window_s=window_s,
        offered_qps=s["offered_qps"], goodput_qps=s["qps"],
        n_arrived=s["n_arrived"], n_done=s["n_done"],
        ttft_p99=s["ttft_p99_s"], tpot_p99=s["tpot_p99_s"],
        queue_depth=len(server.engine.queue), handoff_depth=0,
        retrying_depth=0, n_prefill=0, n_decode=0,
        health={"engine": server.engine.health.value})


class DriftDetector:
    """Hysteresis drift detector over one measured-vs-reference signal.

    ``update(measured, reference)`` computes the relative deviation
    ``|measured - reference| / reference`` and returns True once the
    deviation has exceeded ``band`` for ``patience`` *consecutive*
    samples.  The streak resets only when the deviation falls back inside
    the tighter ``clear_band``; deviations in the gap between the two
    bands hold the streak where it is.  The asymmetry is the point: a
    signal hovering at the trigger threshold cannot alternately arm and
    disarm the detector (flapping), and a single outlier window cannot
    trigger a resize on its own (patience).
    """

    def __init__(self, *, band: float = 0.5, clear_band: float = 0.2,
                 patience: int = 3):
        if band <= 0 or clear_band < 0:
            raise ValueError("bands must be positive")
        if clear_band >= band:
            raise ValueError(
                f"clear_band ({clear_band}) must be tighter than the "
                f"trigger band ({band}) -- equal bands lose hysteresis")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.band = band
        self.clear_band = clear_band
        self.patience = patience
        self.streak = 0
        self.last_deviation: float | None = None

    def update(self, measured: float | None,
               reference: float | None) -> bool:
        """Feed one window's measurement; True when drift is confirmed.
        ``None`` on either side (no samples yet / no reference) is a
        no-op that holds the streak."""
        if measured is None or reference is None or reference <= 0:
            return self.streak >= self.patience
        dev = abs(measured - reference) / reference
        self.last_deviation = dev
        if dev > self.band:
            self.streak += 1
        elif dev <= self.clear_band:
            self.streak = 0
        # clear_band < dev <= band: hysteresis gap -- hold
        return self.streak >= self.patience

    def reset(self) -> None:
        self.streak = 0
        self.last_deviation = None


class ClusterController:
    """Drives a live :class:`RAGCluster` toward its current workload.

    The controller owns the loop *policy*; the mechanisms live below it
    (windowed summaries in server/cluster, DRAINING + migration in the
    cluster, calibration in the cost models).  ``engine_factory(group)``
    must return a fresh :class:`RAGEngine` sharing the cluster's corpus
    encode/backend -- engine construction (weights, device, warm-up) is
    deployment-specific, so the controller never builds engines itself.

    Call :meth:`attach` to hook the server's step loop (control decisions
    then run in-band, rate-limited to ``interval_s``), or drive
    :meth:`control_step` manually from a test.
    """

    def __init__(self, server, schema, system, plan, *,
                 engine_factory=None,
                 window_s: float = 2.0, interval_s: float = 0.5,
                 reference_qps: float | None = None,
                 load_detector: DriftDetector | None = None,
                 tail_detector: DriftDetector | None = None,
                 min_engines: int = 1, max_engines: int = 4,
                 min_window_arrivals: int = 4,
                 settle_s: float | None = None,
                 objective: str = "qps_per_chip"):
        if server.cluster is None:
            raise ValueError("ClusterController needs a disaggregated "
                             "RAGServer (cluster topology)")
        self.server = server
        self.cluster: RAGCluster = server.cluster
        self.schema = schema
        self.system = system
        self.plan = plan
        self.engine_factory = engine_factory
        self.window_s = window_s
        self.interval_s = interval_s
        self.objective = objective
        # reference regime: offered load the current deployment was sized
        # for; None = learn from the first representative window
        self.reference_qps = reference_qps
        self.reference_ttft_p99: float | None = None
        self.load_detector = load_detector or DriftDetector(
            band=0.5, clear_band=0.2, patience=3)
        self.tail_detector = tail_detector or DriftDetector(
            band=1.0, clear_band=0.5, patience=3)
        self.min_engines = min_engines
        self.max_engines = max_engines
        # windows with fewer arrivals than this are not evidence of a
        # regime (trace tail / idle): skip them so offered->0 at drain
        # time cannot trigger a spurious scale-down
        self.min_window_arrivals = min_window_arrivals
        self.settle_s = settle_s if settle_s is not None else 2 * window_s
        self._settle_until = 0.0
        self._last_check: float | None = None
        self.history: list[TelemetrySample] = []
        self.events: list[dict] = []       # replans + resizes, in order
        self.replans = 0
        self.resizes = 0

    # ---------------- wiring -------------------------------------------------

    def attach(self) -> "ClusterController":
        """Hook the server's step loop; control runs in-band, at most
        once per ``interval_s``."""
        self.server.add_step_hook(self._on_step)
        return self

    def _on_step(self, _server) -> None:
        now = time.monotonic()
        if (self._last_check is not None
                and now - self._last_check < self.interval_s):
            return
        self._last_check = now
        self.control_step(now)

    # ---------------- the control loop --------------------------------------

    def control_step(self, now: float | None = None) -> TelemetrySample:
        """One controller decision: sample telemetry, update the drift
        detectors, and -- when drift is confirmed -- re-plan (calibrated)
        and resize.  Returns the sample either way."""
        now = time.monotonic() if now is None else now
        sample = collect_telemetry(self.server, window_s=self.window_s,
                                   now=now)
        self.history.append(sample)
        if sample.n_arrived < self.min_window_arrivals:
            return sample                  # idle / trace tail: no regime
        if self.reference_qps is None:
            self.reference_qps = sample.offered_qps
        if self.reference_ttft_p99 is None and sample.ttft_p99 is not None:
            self.reference_ttft_p99 = sample.ttft_p99
        if now < self._settle_until:
            return sample                  # post-resize migration settling
        load_drift = self.load_detector.update(sample.offered_qps,
                                               self.reference_qps)
        tail_drift = self.tail_detector.update(sample.ttft_p99,
                                               self.reference_ttft_p99)
        if load_drift or tail_drift:
            self.replan_and_resize(
                sample, now,
                trigger=("load" if load_drift else "tail"))
        return sample

    # ---------------- calibration -------------------------------------------

    def measured_specs(self) -> tuple:
        """Fit hardware specs to what the cluster actually measured:
        ``(xpu_or_None, host_or_None, record)``.  Each calibration is
        applied only when its measurement exists (a cold cluster
        calibrates nothing); ``record`` says which ran."""
        engines = (self.cluster.prefill_engines
                   + self.cluster.decode_engines
                   + [e for _g, _eid, e in self.cluster.retired])
        prefill_t = sum(e.metrics["stage_time_s"].get("prefill", 0.0)
                        for e in engines)
        n_prefills = sum(e.metrics["prefills"] for e in engines)
        retrieve_t = sum(e.metrics["stage_time_s"].get("retrieve", 0.0)
                         for e in engines)
        n_queries = sum(e.metrics["retrieved_queries"] for e in engines)
        record = {"xpu_prefill": False, "xpu_decode": False, "host": False}
        xpu = None
        if n_prefills > 0 and prefill_t > 0:
            xpu = calibrate_xpu(self.system.xpu, self.schema,
                                {"prefill": prefill_t}, n_prefills)
            record["xpu_prefill"] = True
        # decode: the achieved HBM bandwidth is the roofline bandwidth
        # scaled by predicted/measured TPOT (decode is memory-bound, so
        # running k x slower than the roofline means k x less bandwidth)
        g = self.cluster.group_summary()
        measured_tpot = g["decode"]["tpot_s"]["p50"]
        if measured_tpot:
            base = xpu if xpu is not None else self.system.xpu
            slots = max(self.cluster.cfg.decode_slots, 1)
            ctx = self.schema.prefix_len + self.schema.decode_len // 2
            predicted = decode_tpot(self.schema.generative,
                                    self.system.xpu, 1, slots, ctx)
            bw = (self.system.xpu.eff_mem_bw
                  * max(predicted / measured_tpot, 1e-9))
            xpu = calibrate_xpu_decode(base, bw)
            record["xpu_decode"] = True
        host = None
        if n_queries > 0 and retrieve_t > 0:
            backend = self.cluster.decode_engines[0].backend
            bpq = getattr(backend, "bytes_per_query", 0.0)
            if bpq and bpq > 0:
                host = calibrate_host(self.system.host,
                                      n_queries * bpq / retrieve_t)
                record["host"] = True
        return xpu, host, record

    # ---------------- re-plan + resize ---------------------------------------

    def replan_and_resize(self, sample: TelemetrySample,
                          now: float | None = None, *,
                          trigger: str = "manual") -> None:
        """Confirmed drift: re-run the RAGO search over calibrated specs,
        then resize load-proportionally toward the new regime with the
        re-planned prefill:decode shape."""
        now = time.monotonic() if now is None else now
        xpu, host, calibrated = self.measured_specs()
        new_plan = ServingPlan.optimize(
            self.schema, self.system, self.objective, xpu=xpu, host=host,
            **self.plan.engine_overrides)
        self.replans += 1
        # load-proportional sizing: scale the decode fleet by the
        # offered-load ratio vs the regime the old plan served, keep the
        # re-planned prefill:decode shape
        ratio = (sample.offered_qps / self.reference_qps
                 if self.reference_qps else 1.0)
        cur_d = len(self.cluster.decode_engines)
        plan_p, plan_d = new_plan.group_sizes(
            max_per_group=self.max_engines)
        target_d = int(min(max(round(cur_d * ratio), self.min_engines),
                           self.max_engines))
        target_p = int(min(max(round(target_d * plan_p / plan_d),
                               self.min_engines), self.max_engines))
        self.events.append({
            "event": "replan", "t": now, "trigger": trigger,
            "offered_qps": sample.offered_qps,
            "reference_qps": self.reference_qps,
            "calibrated": calibrated,
            "calibration": new_plan.detail.get("calibration", {}),
            "target": {"prefill": target_p, "decode": target_d},
        })
        tracer = getattr(self.server, "tracer", None)
        if tracer is not None and tracer.enabled:
            # cluster-scope instant (no rid/engine -> controller track)
            tracer.event("CONTROL:replan", t=now,
                         attrs={"trigger": trigger,
                                "offered_qps": sample.offered_qps,
                                "target_prefill": target_p,
                                "target_decode": target_d})
        self.plan = new_plan
        self.resize(target_p, target_d, now)
        # the new deployment defines the new reference regime
        self.reference_qps = sample.offered_qps
        self.reference_ttft_p99 = None     # re-learn post-resize
        self.load_detector.reset()
        self.tail_detector.reset()
        self._settle_until = now + self.settle_s

    def resize(self, target_prefill: int, target_decode: int,
               now: float | None = None) -> dict:
        """Make-before-break resize to the target group sizes.  Additions
        land first (the factory's engines start taking work immediately);
        only then are surplus engines drained -- the health sweep
        migrates their in-flight requests and reaps them once empty.
        Returns a summary of what changed."""
        now = time.monotonic() if now is None else now
        added = {"prefill": 0, "decode": 0}
        drained = {"prefill": 0, "decode": 0}
        for group, engines, target in (
                ("prefill", self.cluster.prefill_engines, target_prefill),
                ("decode", self.cluster.decode_engines, target_decode)):
            while len(engines) < target:
                if self.engine_factory is None:
                    raise ValueError("scale-up needs an engine_factory")
                eng = self.engine_factory(group)
                if group == "prefill":
                    self.cluster.add_prefill_engine(eng)
                else:
                    self.cluster.add_decode_engine(eng)
                added[group] += 1
        # break only after make: drain newest-first among accepting
        # engines, never below the target (and drain_engine itself
        # refuses to empty a group)
        for group, engines, ids, target in (
                ("prefill", self.cluster.prefill_engines,
                 self.cluster._prefill_ids, target_prefill),
                ("decode", self.cluster.decode_engines,
                 self.cluster._decode_ids, target_decode)):
            accepting = [(eid, e) for eid, e in zip(ids, engines)
                         if e.accepting]
            surplus = len(accepting) - target
            for eid, eng in sorted(accepting, reverse=True)[:max(surplus,
                                                                 0)]:
                self.cluster.drain_engine(eng)
                drained[group] += 1
        if any(added.values()) or any(drained.values()):
            self.resizes += 1
            self.events.append({"event": "resize", "t": now,
                                "added": added, "drained": drained,
                                "target": {"prefill": target_prefill,
                                           "decode": target_decode}})
            tracer = getattr(self.server, "tracer", None)
            if tracer is not None and tracer.enabled:
                tracer.event("CONTROL:resize", t=now,
                             attrs={"added": dict(added),
                                    "drained": dict(drained),
                                    "target_prefill": target_prefill,
                                    "target_decode": target_decode})
        return {"added": added, "drained": drained}
