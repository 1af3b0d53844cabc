"""Stage executors of the port's serving engine (mirror of
``repro.serving.executors`` and of the executor half of
``repro.core.stage_registry``).

``EXECUTOR_FACTORIES`` lists the stages in the JAX registry's order, each
with the activation rule of its ``make_executor`` factory
(``stage_registry.py``): rewrite, multi-query fan-out, retrieval, rerank,
safety filter.

Executor contract: ``run(engine, request)`` mutates the request in place
(state transitions + stage outputs) and may call engine primitives.
PyTorch runs eagerly, so where the JAX executors jit one generation
program per prompt bucket or one encode per input shape, these call the
model functions directly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tr
from repro_torch.serving.request import State


class GreedyGenerator:
    """Batched greedy generation (``tr.greedy_generate``): prompts are
    right-padded to a power-of-two bucket and all rows decode together."""

    def __init__(self, comp):
        self.comp = comp

    def __call__(self, prompts: list[np.ndarray],
                 n_tokens: int) -> np.ndarray:
        from repro_torch.serving.engine import bucket_len
        bucket = bucket_len(max(len(p) for p in prompts))
        tokens = np.zeros((len(prompts), bucket), np.int32)
        lengths = np.empty(len(prompts), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lengths[i] = len(p)
        dev = self.comp.params.device
        out = tr.greedy_generate(self.comp.params,
                                 torch.from_numpy(tokens).to(dev),
                                 torch.from_numpy(lengths).to(dev),
                                 self.comp.cfg, n_tokens)
        return out.cpu().numpy()


class Encoder:
    """The rerank / safety stages' encoder call: host ids are checked
    against the embedding table (``tr.check_ids``) and embedded on the
    component's device."""

    def __init__(self, comp):
        self.comp = comp

    def __call__(self, tokens) -> torch.Tensor:
        tokens = np.asarray(tokens)
        tr.check_ids(tokens, self.comp.cfg)
        return tr.encode(self.comp.params,
                         torch.from_numpy(np.ascontiguousarray(tokens)).to(
                             self.comp.params.device), self.comp.cfg)


def _query(req) -> np.ndarray:
    return req.rewritten if req.rewritten is not None else req.question


class RewriteExecutor:
    """Autoregressive query rewrite: question -> question + generated
    expansion tokens."""
    name = "rewrite"

    def __init__(self, comp):
        self._gen = GreedyGenerator(comp)

    def run(self, eng, req) -> None:
        req.state = State.REWRITING
        extra = self._gen([req.question], eng.cfg.rewrite_tokens)[0]
        req.rewritten = np.concatenate([req.question, extra])


class MultiQueryExecutor:
    """Multi-query fan-out: expand the (possibly rewritten) question into
    ``fanout_queries`` variants, each the base query plus a short greedy
    continuation from a distinct seed token, generated as one batch;
    retrieval searches with every variant and unions the candidates."""
    name = "multi_query"

    def __init__(self, comp):
        self._gen = GreedyGenerator(comp)

    def run(self, eng, req) -> None:
        base = _query(req)
        vocab = self._gen.comp.cfg.vocab_size
        seeds = [np.append(base, np.int32(i % vocab))
                 for i in range(1, eng.cfg.fanout_queries)]
        extras = self._gen(seeds, eng.cfg.fanout_tokens)
        req.query_variants = [base] + [np.concatenate([base, e])
                                       for e in extras]


class RetrieveExecutor:
    """Embed the query (or every fan-out variant) and fetch candidate doc
    ids; variants' result lists are rank-interleaved and deduplicated."""
    name = "retrieval"

    def run(self, eng, req) -> None:
        req.state = State.RETRIEVING
        k = (eng.cfg.rerank_candidates if eng.has_executor("rerank")
             else eng.cfg.retrieval_k)
        queries = req.query_variants or [_query(req)]
        # the base query keeps its own length; generated variants all share
        # one length, so they batch into a single database scan
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


class RerankExecutor:
    """Score retrieval candidates with the reranker encoder; keep top-k."""
    name = "rerank"

    def __init__(self, comp):
        self._encode = Encoder(comp)

    def run(self, eng, req) -> None:
        cand = req.candidate_ids
        qv = self._encode(np.asarray(_query(req))[None])[0]
        dv = self._encode(eng.corpus[cand])
        scores = dv @ qv
        # jnp.argsort is stable: equal scores keep candidate order
        order = torch.argsort(-scores, stable=True)[:eng.cfg.retrieval_k]
        req.candidate_ids = cand[order.cpu().numpy()]


class SafetyFilterExecutor:
    """Encoder-based screen over retrieved documents: each candidate doc
    gets a score from the safety encoder (first hidden dim through a
    sigmoid -- the stand-in for a trained safety head); docs scoring below
    ``cfg.safety_threshold`` are dropped from the prompt.  With threshold
    ``None`` the stage only records scores."""
    name = "safety_filter"

    def __init__(self, comp):
        self._encode = Encoder(comp)

    def _score(self, eng, doc_ids) -> np.ndarray:
        dv = self._encode(eng.corpus[doc_ids])
        return torch.sigmoid(dv[:, 0].float()).cpu().numpy()

    def run(self, eng, req) -> None:
        cand = req.candidate_ids
        if cand is None or len(cand) == 0:
            req.safety_scores = []
            return
        scores = self._score(eng, cand)
        req.safety_scores = [float(s) for s in scores]
        thr = eng.cfg.safety_threshold
        if thr is not None:
            req.candidate_ids = cand[scores >= thr]

    def filter_iterative(self, eng, req, doc_ids):
        """Screen iteratively retrieved docs before the cache append."""
        if len(doc_ids) == 0:
            return doc_ids
        scores = self._score(eng, doc_ids)
        if req.safety_scores is None:
            req.safety_scores = []
        req.safety_scores.extend(float(s) for s in scores)
        thr = eng.cfg.safety_threshold
        if thr is None:
            return doc_ids
        return doc_ids[scores >= thr]


def _rewrite(engine):
    if engine.cfg.rewrite_tokens and engine.rewriter is not None:
        return RewriteExecutor(engine.rewriter)
    return None


def _multi_query(engine):
    if engine.cfg.fanout_queries > 1:
        model = engine.rewriter if engine.rewriter is not None else engine.gen
        return MultiQueryExecutor(model)
    return None


def _retrieval(engine):
    return RetrieveExecutor()


def _rerank(engine):
    if engine.cfg.rerank and engine.reranker is not None:
        return RerankExecutor(engine.reranker)
    return None


def _safety_filter(engine):
    if engine.safety is not None:
        return SafetyFilterExecutor(engine.safety)
    return None


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
