"""Stage executors of the port's serving engine (mirror of
``repro.serving.executors`` and of the executor half of
``repro.core.stage_registry``).

``EXECUTOR_FACTORIES`` lists the stages in the JAX registry's order, each
with the activation rule of its ``make_executor`` factory
(``stage_registry.py``).  Only retrieval is ported: a configuration that
activates rewrite, multi-query fan-out, rerank or the safety filter
raises ``NotImplementedError`` at engine construction instead of being
skipped.

Executor contract: ``run(engine, request)`` mutates the request in place
(state transitions + stage outputs) and may call engine primitives.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.request import State


def _query(req) -> np.ndarray:
    return req.rewritten if req.rewritten is not None else req.question


class RetrieveExecutor:
    """Embed the query (or every fan-out variant) and fetch candidate doc
    ids; variants' result lists are rank-interleaved and deduplicated."""
    name = "retrieval"

    def run(self, eng, req) -> None:
        req.state = State.RETRIEVING
        k = (eng.cfg.rerank_candidates if eng.has_executor("rerank")
             else eng.cfg.retrieval_k)
        queries = req.query_variants or [_query(req)]
        per_query = [eng.retrieve(queries[0][None], k)[0]]
        eng.note_retrieval_degraded(req)
        if len(queries) > 1:
            per_query += list(eng.retrieve(np.stack(queries[1:]), k))
            eng.note_retrieval_degraded(req)
        seen, ids = set(), []
        for rank in range(k):
            for cand in per_query:
                d = int(cand[rank])
                if d >= 0 and d not in seen:    # skip ANN padding ids
                    seen.add(d)
                    ids.append(d)
        req.candidate_ids = np.asarray(ids[:k], np.int64)


def _not_ported(stage: str):
    raise NotImplementedError(
        f"the {stage!r} stage executor is not ported to repro_torch yet "
        f"(ROADMAP queue 1: executors)")


def _rewrite(engine):
    if engine.cfg.rewrite_tokens and engine.rewriter is not None:
        _not_ported("rewrite")


def _multi_query(engine):
    if engine.cfg.fanout_queries > 1:
        _not_ported("multi_query")


def _retrieval(engine):
    return RetrieveExecutor()


def _rerank(engine):
    if engine.cfg.rerank and engine.reranker is not None:
        _not_ported("rerank")


def _safety_filter(engine):
    if engine.safety is not None:
        _not_ported("safety_filter")


#: (stage name, factory) in the JAX registry's order (``order=`` 20, 25,
#: 30, 40, 45); a factory returns an executor or None when inactive.
EXECUTOR_FACTORIES = (
    ("rewrite", _rewrite),
    ("multi_query", _multi_query),
    ("retrieval", _retrieval),
    ("rerank", _rerank),
    ("safety_filter", _safety_filter),
)


def engine_executors(engine) -> list:
    """The executable pipeline for one engine, in registry order."""
    return [ex for _, make in EXECUTOR_FACTORIES
            if (ex := make(engine)) is not None]
