"""Registry-driven stage abstraction: ONE pipeline description shared by the
RAGO optimizer, the analytical stage models, the iterative-decode simulator,
and the executable serving engine.

The StageSpec contract
----------------------
A pipeline stage is fully described by a :class:`StageSpec`:

* ``name``       -- stable identifier used in schedules, plans and metrics.
* ``placement``  -- where the stage may run: ``"xpu"`` (accelerator stage,
  participates in collocate/disaggregate placement search), ``"host"``
  (CPU-host-only, e.g. vector search; never enters the XPU placement
  enumeration), or ``"decode"`` (anchored to the continuous-batching decode
  group; handled by the decode frontier, never a pre-decode group member).
* ``order``      -- pipeline position; ``RAGSchema.stages()`` is the
  ``order``-sorted list of enabled specs.
* ``enabled``    -- ``f(schema) -> bool``: does this schema instantiate the
  stage?  Enablement is data-driven (a schema field), never an if/elif
  chain in the optimizer or engine.
* ``load``       -- ``f(schema) -> float``: passes through the stage per
  served request (e.g. ``retrieval_frequency`` for retrieval).
* ``weights_bytes`` -- ``f(schema) -> float``: accelerator memory the stage
  pins (model weights); used by the optimizer's HBM-fit pruning.
* ``points``     -- ``f(schema, sys, n, batch, tp_only) -> [StagePerf]``:
  analytical (latency, throughput) operating points on ``n`` chips (or
  ``n`` servers for host stages) at one batch size, one point per
  parallelism factorization.  This is the per-stage cost model the
  frontier search composes.
* ``decode_stall`` -- optional ``f(schema, sys, n, batch) -> seconds``:
  latency this stage injects into a decode-anchored iterative event
  (paper §5.3: retrieval + iteration prefill; extensible, e.g. a safety
  screen over iteratively retrieved content).
* ``make_executor`` -- optional ``f(engine) -> StageExecutor | None``:
  factory for the *real* serving-engine executor.  Returns ``None`` when
  the engine's components/config do not activate the stage.  The engine
  composes its request pipeline exclusively from these factories, so the
  analytical model and the executable engine consume the same
  description.
* ``engine_knobs`` -- optional ``f(schema) -> dict``: the EngineConfig
  fields this stage derives from the schema when it is enabled
  (``EngineConfig.from_schema`` merges them).  This is what makes the
  schema the single source of truth for the executable engine: a stage's
  enabling/config fields are never hand-set twice (once in the schema,
  once in an EngineConfig) -- the registry maps one onto the other.

Adding a stage therefore requires exactly one ``register()`` call (plus the
schema field that enables it) -- no edits to ``stages.py``,
``optimizer.py`` or ``engine.py``.  The two proof-of-extensibility stages
(``multi_query`` fan-out and the encoder-based ``safety_filter``) at the
bottom of this module are registered that way.

This module keeps all heavyweight imports (cost model, retrieval model,
serving executors) inside the spec callables so that importing the registry
is cheap and cycle-free.

Copied from ``src/repro/core/stage_registry.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

XPU = "xpu"          # accelerator stage, placement-searchable
HOST = "host"        # CPU-host-only (vector search)
DECODE = "decode"    # decode-anchored (continuous batching group)

PLACEMENTS = (XPU, HOST, DECODE)


@dataclass(frozen=True)
class StageSpec:
    """Complete description of one pipeline stage (see module docstring)."""
    name: str
    placement: str
    order: float
    enabled: Callable[[Any], bool]
    load: Callable[[Any], float]
    weights_bytes: Callable[[Any], float]
    points: Callable[..., list] | None = None
    decode_stall: Callable[..., float] | None = None
    make_executor: Callable[[Any], Any] | None = None
    engine_knobs: Callable[[Any], dict] | None = None

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENTS}")


class StageRegistry:
    """Order-aware name -> StageSpec mapping."""

    def __init__(self):
        self._specs: dict[str, StageSpec] = {}

    def register(self, spec: StageSpec, replace: bool = False) -> StageSpec:
        if spec.name in self._specs and not replace:
            raise ValueError(f"stage {spec.name!r} already registered")
        self._specs[spec.name] = spec
        return spec

    def get(self, name: str) -> StageSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise ValueError(f"unknown stage {name!r}; registered: "
                             f"{sorted(self._specs)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def ordered(self) -> list[StageSpec]:
        return sorted(self._specs.values(), key=lambda s: s.order)

    def pipeline(self, schema) -> list[str]:
        """Ordered stage names the schema enables."""
        return [s.name for s in self.ordered() if s.enabled(schema)]

    def xpu_stages(self, schema) -> list[str]:
        """Enabled placement-searchable stages (the pre-decode XPU chain)."""
        return [s.name for s in self.ordered()
                if s.placement == XPU and s.enabled(schema)]

    def group_for(self, name: str) -> str:
        """Disaggregated-cluster routing: which engine group runs a stage.

        Pre-decode stages (``xpu`` and ``host`` placements) execute on the
        prefill group; ``decode``-anchored stages on the decode group.
        Stages with a ``decode_stall`` (iterative retrieval, safety screen
        over iteratively retrieved content) additionally re-run *inside*
        the decode group mid-generation -- that recurrence is priced by
        ``decode_stall`` and executed by the decode engines' iterative
        dispatch, not by this initial-pass routing."""
        spec = self.get(name)
        return "decode" if spec.placement == DECODE else "prefill"

    def route_groups(self, schema) -> dict[str, list[str]]:
        """Ordered stage names per engine group for one schema -- the
        cluster's placement contract
        (:class:`~repro_torch.serving.cluster.RAGCluster` instantiates one
        engine group per key)."""
        out: dict[str, list[str]] = {"prefill": [], "decode": []}
        for spec in self.ordered():
            if spec.enabled(schema):
                out[self.group_for(spec.name)].append(spec.name)
        return out

    def engine_executors(self, engine) -> list:
        """Instantiate the executable pipeline for one engine: each spec's
        ``make_executor`` decides activation from the engine's components
        and config."""
        out = []
        for spec in self.ordered():
            if spec.make_executor is None:
                continue
            ex = spec.make_executor(engine)
            if ex is not None:
                out.append(ex)
        return out

    def engine_config_fields(self, schema) -> dict:
        """Merged EngineConfig fields derived from the schema: every
        enabled stage contributes its ``engine_knobs`` mapping (the
        registry-driven half of ``EngineConfig.from_schema``)."""
        fields: dict = {}
        for spec in self.ordered():
            if spec.engine_knobs is not None and spec.enabled(schema):
                fields.update(spec.engine_knobs(schema))
        return fields


REGISTRY = StageRegistry()


# ---------------------------------------------------------------------------
# Built-in stage specs (paper Fig. 3 pipeline).  All model/cost imports are
# lazy so core modules can import the registry without cycles.
# ---------------------------------------------------------------------------

def _model_bytes(model) -> float:
    if model is None:
        return 0.0
    from repro_torch.core import cost_model as cmod
    return model.params * cmod.BYTES_W


def _encode_points(schema, sys, n, batch, tp_only=False):
    from repro_torch.core import cost_model as cmod
    return list(cmod.encoder_points(schema.encoder, sys.xpu, n, batch,
                                    schema.encode_context_len,
                                    schema.chunk_size, tp_only=tp_only))


def _rewrite_points(schema, sys, n, batch, tp_only=False):
    from repro_torch.core import cost_model as cmod
    tpot = cmod.decode_tpot(schema.rewriter, sys.xpu, n, batch,
                            schema.question_len)
    out = []
    for p in cmod.prefill_points(schema.rewriter, sys.xpu, n, batch,
                                 schema.question_len, tp_only=tp_only):
        lat = p.latency + schema.rewriter_out_len * tpot
        out.append(cmod.StagePerf(lat, batch / lat))
    return out


def _retrieval_points(schema, sys, n, batch, tp_only=False):
    from repro_torch.core import cost_model as cmod
    from repro_torch.core.retrieval_model import retrieval_perf
    perf = retrieval_perf(schema, sys.host, n, batch)
    return [cmod.StagePerf(perf.latency, perf.throughput)]


def _retrieval_stall(schema, sys, n, batch):
    from repro_torch.core.retrieval_model import retrieval_perf
    return retrieval_perf(schema, sys.host, n, batch).latency


def _rerank_points(schema, sys, n, batch, tp_only=False):
    from repro_torch.core import cost_model as cmod
    tokens = schema.rerank_candidates * schema.rerank_doc_tokens
    return list(cmod.encoder_points(schema.reranker, sys.xpu, n, batch,
                                    tokens, schema.rerank_doc_tokens,
                                    tp_only=tp_only))


def _prefill_points(schema, sys, n, batch, tp_only=False):
    from repro_torch.core import cost_model as cmod
    return list(cmod.prefill_points(schema.generative, sys.xpu, n, batch,
                                    schema.prefix_len, tp_only=tp_only))


def _prefill_stall(schema, sys, n, batch):
    from repro_torch.core import cost_model as cmod
    return cmod.prefill_perf(schema.generative, sys.xpu, n, batch,
                             schema.prefix_len).latency


# -- engine executor factories (lazy: serving pulls in torch) ---------------
# Each executor gets the engine's attention ops: the full-sequence op
# (``engine.seq_attn``) for prefill and the encoder, the dense decode op
# (``engine.dense_attn``) for greedy generation.

def _rewrite_executor(engine):
    from repro_torch.serving import executors as ex
    if engine.cfg.rewrite_tokens and engine.rewriter is not None:
        return ex.RewriteExecutor(engine.rewriter, engine.seq_attn,
                                  engine.dense_attn)
    return None


def _retrieval_executor(engine):
    from repro_torch.serving import executors as ex
    return ex.RetrieveExecutor()


def _rerank_executor(engine):
    from repro_torch.serving import executors as ex
    if engine.cfg.rerank and engine.reranker is not None:
        return ex.RerankExecutor(engine.reranker, engine.seq_attn)
    return None


# -- EngineConfig fields each stage derives from the schema -----------------
# (consumed by ``EngineConfig.from_schema`` via
# ``REGISTRY.engine_config_fields``; deployment/resource knobs such as
# decode_slots or the retrieval backend come from the ServingPlan, not from
# per-stage knobs)

def _rewrite_knobs(s) -> dict:
    return {"rewrite_tokens": s.rewriter_out_len}


def _retrieval_knobs(s) -> dict:
    # iterative retrieval (paper S5.3): retrieval_frequency events spread
    # over the decode length; the first retrieval happens at admission
    return {"iterative_interval":
            (max(1, s.decode_len // s.retrieval_frequency)
             if s.retrieval_frequency > 1 else None)}


def _rerank_knobs(s) -> dict:
    return {"rerank": True, "rerank_candidates": s.rerank_candidates}


def _prefill_knobs(s) -> dict:
    return {"s_max": s.prefix_len + s.decode_len}


def _decode_knobs(s) -> dict:
    return {"max_new_tokens": s.decode_len}


REGISTRY.register(StageSpec(
    name="encode", placement=XPU, order=10,
    enabled=lambda s: s.encoder is not None,
    load=lambda s: 1.0,
    weights_bytes=lambda s: _model_bytes(s.encoder),
    points=_encode_points,
    engine_knobs=lambda s: {},      # the encoder is a constructor component
))

REGISTRY.register(StageSpec(
    name="rewrite", placement=XPU, order=20,
    enabled=lambda s: s.rewriter is not None,
    load=lambda s: 1.0,
    weights_bytes=lambda s: _model_bytes(s.rewriter),
    points=_rewrite_points,
    make_executor=_rewrite_executor,
    engine_knobs=_rewrite_knobs,
))

REGISTRY.register(StageSpec(
    name="retrieval", placement=HOST, order=30,
    enabled=lambda s: s.db_vectors > 0,
    load=lambda s: float(s.retrieval_frequency),
    weights_bytes=lambda s: 0.0,
    points=_retrieval_points,
    decode_stall=_retrieval_stall,
    make_executor=_retrieval_executor,
    engine_knobs=_retrieval_knobs,
))

REGISTRY.register(StageSpec(
    name="rerank", placement=XPU, order=40,
    enabled=lambda s: s.reranker is not None,
    load=lambda s: 1.0,
    weights_bytes=lambda s: _model_bytes(s.reranker),
    points=_rerank_points,
    make_executor=_rerank_executor,
    engine_knobs=_rerank_knobs,
))

REGISTRY.register(StageSpec(
    name="prefill", placement=XPU, order=50,
    enabled=lambda s: True,
    load=lambda s: 1.0 + (s.retrieval_frequency - 1),
    weights_bytes=lambda s: _model_bytes(s.generative),
    points=_prefill_points,
    decode_stall=_prefill_stall,
    engine_knobs=_prefill_knobs,
))

REGISTRY.register(StageSpec(
    name="decode", placement=DECODE, order=60,
    enabled=lambda s: True,
    load=lambda s: 1.0,
    weights_bytes=lambda s: _model_bytes(s.generative),
    engine_knobs=_decode_knobs,
))


# ---------------------------------------------------------------------------
# Extensibility proof: two stages added purely as registry entries.  Nothing
# in stages.py / optimizer.py / engine.py names them.
# ---------------------------------------------------------------------------

def _multi_query_points(schema, sys, n, batch, tp_only=False):
    """Generate ``queries_per_retrieval`` query variants with a small
    generative model: one prefill of the question, then the variants decode
    as a fused batch (batch x Q sequences)."""
    from repro_torch.core import cost_model as cmod
    model = schema.fanout_model
    q = schema.queries_per_retrieval
    tpot = cmod.decode_tpot(model, sys.xpu, n, batch * q,
                            schema.question_len + schema.fanout_out_len)
    out = []
    for p in cmod.prefill_points(model, sys.xpu, n, batch,
                                 schema.question_len, tp_only=tp_only):
        lat = p.latency + schema.fanout_out_len * tpot
        out.append(cmod.StagePerf(lat, batch / lat))
    return out


def _multi_query_executor(engine):
    from repro_torch.serving import executors as ex
    if engine.cfg.fanout_queries > 1:
        model = engine.rewriter if engine.rewriter is not None else engine.gen
        return ex.MultiQueryExecutor(model, engine.seq_attn,
                                     engine.dense_attn)
    return None


# Enabled only when the schema names a fan-out model: plain
# queries_per_retrieval > 1 keeps the paper's semantics (multiple query
# vectors as pure retrieval-side load, Fig. 6) so the benchmark anchors
# are untouched; setting fanout_model opts into generating the variants
# as a real pipeline stage.
REGISTRY.register(StageSpec(
    name="multi_query", placement=XPU, order=25,
    enabled=lambda s: s.queries_per_retrieval > 1
    and s.fanout_model is not None,
    load=lambda s: 1.0,
    weights_bytes=lambda s: _model_bytes(s.fanout_model),
    points=_multi_query_points,
    make_executor=_multi_query_executor,
    engine_knobs=lambda s: {"fanout_queries": s.queries_per_retrieval,
                            "fanout_tokens": s.fanout_out_len},
))


def _safety_points(schema, sys, n, batch, tp_only=False):
    """Encoder screen over the assembled prompt (question + retrieved
    docs): chunked bidirectional encoding of ``prefix_len`` tokens."""
    from repro_torch.core import cost_model as cmod
    return list(cmod.encoder_points(schema.safety_model, sys.xpu, n, batch,
                                    schema.prefix_len, schema.chunk_size,
                                    tp_only=tp_only))


def _safety_stall(schema, sys, n, batch):
    """Iteratively retrieved content is screened before cache append."""
    from repro_torch.core import cost_model as cmod
    return cmod.encoder_perf(schema.safety_model, sys.xpu, n, batch,
                             schema.chunk_size, schema.chunk_size).latency


def _safety_executor(engine):
    from repro_torch.serving import executors as ex
    if engine.safety is not None:
        return ex.SafetyFilterExecutor(engine.safety, engine.seq_attn)
    return None


REGISTRY.register(StageSpec(
    name="safety_filter", placement=XPU, order=45,
    enabled=lambda s: s.safety_model is not None,
    load=lambda s: 1.0,
    weights_bytes=lambda s: _model_bytes(s.safety_model),
    points=_safety_points,
    decode_stall=_safety_stall,
    make_executor=_safety_executor,
    engine_knobs=lambda s: {"safety_threshold": s.safety_threshold},
))
