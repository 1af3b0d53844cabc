"""ServingPlan: the executable bridge from optimizer output to a deployed
serving configuration -- the piece that closes RAGO's schema -> plan ->
server loop.

``enumerate_plans`` emits analytical :class:`~repro_torch.core.optimizer.
PlanPoint` schedules; ``RAGEngine`` consumes an ``EngineConfig``.  A
``ServingPlan`` maps one onto the other:

* the *schema* drives stage enabling/sizing via the stage registry
  (``EngineConfig.from_schema``), so nothing the schema already says is
  re-encoded by hand;
* the *plan point* contributes the schedule RAGO chose: the decode batch
  becomes ``decode_slots`` (continuous-batching slot count), the
  iterative-retrieval batch (paper §6.1[III]) becomes ``retrieval_batch``,
  and the retrieval regime picks the engine backend (full-scan schemas
  deploy exact kNN, sub-linear scan fractions deploy the IVF-PQ index);
* *overrides* carry whatever the analytical model does not describe
  (test-scale clamps, an explicit backend, ...) and always win last.

One call chain runs the paper's whole workflow::

    plan = ServingPlan.optimize(schema, system)       # search + pick
    server = RAGServer.from_plan(plan, generative=..., encoder=...,
                                 corpus_tokens=corpus)
    handle = server.submit(question)

This module stays import-light (no torch): ``engine_config`` imports the
serving engine lazily, so the optimizer stack can build plans on machines
that never deploy them.

Copied from ``src/repro/core/serving_plan.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.ragschema import RAGSchema


@dataclass
class ServingPlan:
    """Deployable serving schedule for one RAGSchema."""
    schema: RAGSchema
    placement: tuple = ()              # pre-decode stage groups
    group_chips: tuple = ()            # XPUs per pre-decode group
    decode_chips: int = 0
    n_servers: int = 1                 # retrieval host servers
    stage_batches: dict[str, int] = field(default_factory=dict)
    iter_batch: int | None = None      # iterative retrieval batch (b_it)
    predicted: dict[str, float] = field(default_factory=dict)
    engine_overrides: dict[str, Any] = field(default_factory=dict)
    detail: dict[str, Any] = field(default_factory=dict)  # provenance
    # (e.g. which measured calibration produced the specs the search ran
    # on -- ``detail["calibration"]`` -- so a live re-plan is auditable)

    # ---------------- construction -----------------------------------------

    @classmethod
    def from_plan_point(cls, schema: RAGSchema, point,
                        **engine_overrides) -> "ServingPlan":
        """Turn one optimizer PlanPoint into a deployable plan."""
        detail = point.detail or {}
        batches = {m["stage"]: m["batch"]
                   for m in detail.get("stages", []) if "batch" in m}
        return cls(
            schema=schema,
            placement=tuple(tuple(g) for g in point.placement),
            group_chips=tuple(detail.get("group_chips", ())),
            decode_chips=int(detail.get("decode_chips", 0)),
            n_servers=int(detail.get("n_servers", 1)),
            stage_batches=batches,
            iter_batch=detail.get("iter_batch"),
            predicted={"ttft": point.ttft, "qps": point.qps,
                       "qps_per_chip": point.qps_per_chip},
            engine_overrides=dict(engine_overrides))

    @classmethod
    def optimize(cls, schema: RAGSchema, system,
                 objective: str = "qps_per_chip", *,
                 xpu=None, host=None,
                 **engine_overrides) -> "ServingPlan":
        """The full paper workflow in one call: run the RAGO search over
        the schema on ``system`` and return the chosen plan
        (``objective``: ``"qps_per_chip"`` -- most cost-efficient plan
        meeting capacity, Table 4 -- or ``"ttft"``).

        ``xpu`` / ``host`` substitute *calibrated* hardware specs (from
        ``cost_model.calibrate_xpu`` / ``calibrate_xpu_decode`` /
        ``retrieval_model.calibrate_host``) for the system's nominal
        ones before the search runs -- the live control plane's
        measured-not-assumed re-planning path.  Which substitutions were
        applied (and how far each calibrated spec moved from nominal) is
        recorded in ``plan.detail["calibration"]``, so every re-plan is
        auditable after the fact."""
        from dataclasses import replace as dc_replace

        from repro_torch.core import optimizer as opt
        calibration: dict[str, Any] = {}
        if xpu is not None:
            from repro_torch.core.cost_model import calibration_delta
            calibration["xpu"] = calibration_delta(system.xpu, xpu)
            system = dc_replace(system, xpu=xpu)
        if host is not None:
            nominal_bw = system.host.pq_scan_bw_per_core
            calibration["host"] = {
                "pq_scan_bw_per_core": host.pq_scan_bw_per_core,
                "nominal_bw_per_core": nominal_bw,
                "ratio": (host.pq_scan_bw_per_core / nominal_bw
                          if nominal_bw > 0 else None),
            }
            system = dc_replace(system, host=host)
        plans = opt.enumerate_plans(schema, system)
        if objective == "qps_per_chip":
            best = opt.best_qps_per_chip(plans)
        elif objective == "ttft":
            best = opt.best_ttft(plans)
        else:
            raise ValueError(f"unknown objective {objective!r}")
        plan = cls.from_plan_point(schema, best, **engine_overrides)
        if calibration:
            plan.detail["calibration"] = calibration
        return plan

    # ---------------- deployment -------------------------------------------

    def engine_config(self, **overrides):
        """Materialize the EngineConfig: schema-derived stage fields
        (registry), plan-derived schedule fields, then overrides."""
        from repro_torch.serving.engine import EngineConfig
        derived: dict[str, Any] = {}
        if "decode" in self.stage_batches:
            derived["decode_slots"] = int(self.stage_batches["decode"])
        if self.iter_batch:
            derived["retrieval_batch"] = int(self.iter_batch)
        # retrieval regime -> backend: a full-scan schema (long-context
        # Case II builds its DB on the fly) deploys brute-force kNN; a
        # sub-linear scan fraction deploys the IVF-PQ index
        if self.schema.db_vectors > 0:
            derived["retrieval_backend"] = (
                "exact" if self.schema.scan_fraction >= 1.0 else "ivfpq")
        merged = {**derived, **self.engine_overrides, **overrides}
        return EngineConfig.from_schema(self.schema, **merged)

    def group_sizes(self, max_per_group: int = 4) -> tuple[int, int]:
        """Map the plan's chip split onto disaggregated engine-group sizes
        ``(n_prefill, n_decode)`` for a disaggregated cluster (the JAX
        package's ``repro.serving.cluster.RAGCluster``; not ported yet).

        The optimizer allocates XPUs to pre-decode groups
        (``group_chips``) and to the decode group (``decode_chips``); a
        test-scale cluster cannot instantiate hundreds of chips, so the
        *ratio* of the split is kept (reduced by gcd) and clamped to
        ``max_per_group`` engines per group.  A plan with no allocation
        detail deploys the minimal 1+1 cluster."""
        pre = int(sum(self.group_chips)) or 1
        dec = int(self.decode_chips) or 1
        g = math.gcd(pre, dec)
        n_p, n_d = pre // g, dec // g
        scale = max(n_p, n_d)
        if scale > max_per_group:
            n_p = max(1, round(n_p * max_per_group / scale))
            n_d = max(1, round(n_d * max_per_group / scale))
        return n_p, n_d

    # ---------------- reporting --------------------------------------------

    def describe(self) -> str:
        groups = " | ".join(
            f"{'+'.join(g)}@{c}" for g, c in
            zip(self.placement, self.group_chips)) or "-"
        pred = self.predicted
        return (f"ServingPlan[{groups} || decode@{self.decode_chips} "
                f"chips, {self.n_servers} retrieval servers; "
                f"batches {self.stage_batches}"
                + (f", iter_batch {self.iter_batch}" if self.iter_batch
                   else "")
                + (f"; predicted {pred.get('qps', 0):.1f} QPS @ "
                   f"{pred.get('ttft', 0) * 1e3:.1f} ms TTFT" if pred
                   else "") + "]")
