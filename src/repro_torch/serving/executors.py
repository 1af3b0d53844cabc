"""Stage executors of the port's serving engine (mirror of
``repro.serving.executors``).

The stage registry (``repro_torch.core.stage_registry``) decides which
executors an engine gets and builds them with the engine's attention
ops: ``attn_impl`` is the full-sequence op of the generation prefill and
the encoder (the flash kernel on a CUDA engine), ``decode_attn_impl``
the dense decode op of greedy generation; ``None`` keeps the reference
attention.

Executor contract: ``run(engine, request)`` mutates the request in place
(state transitions + stage outputs) and may call engine primitives.
With tracing on, each annotates its stage's span with payload sizes as
plain Python ints: a tensor there would force a device read, and the
exporters' ``json.dumps`` would refuse it.
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

    def __init__(self, comp, attn_impl=None, decode_attn_impl=None):
        self.comp = comp
        self.attn_impl = attn_impl
        self.decode_attn_impl = decode_attn_impl

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
                                 self.comp.cfg, n_tokens,
                                 attn_impl=self.attn_impl,
                                 decode_attn_impl=self.decode_attn_impl)
        return out.cpu().numpy()


class Encoder:
    """The rerank / safety stages' encoder call: host ids are checked
    against the embedding table (``tr.check_ids``) and embedded on the
    component's device."""

    def __init__(self, comp, attn_impl=None):
        self.comp = comp
        self.attn_impl = attn_impl

    def __call__(self, tokens) -> torch.Tensor:
        tokens = np.asarray(tokens)
        tr.check_ids(tokens, self.comp.cfg)
        return tr.encode(self.comp.params,
                         torch.from_numpy(np.ascontiguousarray(tokens)).to(
                             self.comp.params.device), self.comp.cfg,
                         attn_impl=self.attn_impl)


def _query(req) -> np.ndarray:
    return req.rewritten if req.rewritten is not None else req.question


class RewriteExecutor:
    """Autoregressive query rewrite: question -> question + generated
    expansion tokens."""
    name = "rewrite"

    def __init__(self, comp, attn_impl=None, decode_attn_impl=None):
        self._gen = GreedyGenerator(comp, attn_impl, decode_attn_impl)

    def run(self, eng, req) -> None:
        req.state = State.REWRITING
        extra = self._gen([req.question], eng.cfg.rewrite_tokens)[0]
        req.rewritten = np.concatenate([req.question, extra])
        if eng.tracer.enabled:
            eng.tracer.annotate(req.rid, in_tokens=int(len(req.question)),
                                out_tokens=int(len(req.rewritten)))


class MultiQueryExecutor:
    """Multi-query fan-out: expand the (possibly rewritten) question into
    ``fanout_queries`` variants, each the base query plus a short greedy
    continuation from a distinct seed token, generated as one batch;
    retrieval searches with every variant and unions the candidates."""
    name = "multi_query"

    def __init__(self, comp, attn_impl=None, decode_attn_impl=None):
        self._gen = GreedyGenerator(comp, attn_impl, decode_attn_impl)

    def run(self, eng, req) -> None:
        base = _query(req)
        vocab = self._gen.comp.cfg.vocab_size
        seeds = [np.append(base, np.int32(i % vocab))
                 for i in range(1, eng.cfg.fanout_queries)]
        extras = self._gen(seeds, eng.cfg.fanout_tokens)
        req.query_variants = [base] + [np.concatenate([base, e])
                                       for e in extras]
        if eng.tracer.enabled:
            eng.tracer.annotate(req.rid,
                                variants=len(req.query_variants),
                                variant_tokens=sum(int(len(v)) for v in
                                                   req.query_variants))


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
        if eng.tracer.enabled:
            eng.tracer.annotate(req.rid, queries=len(queries), k=k,
                                candidates=int(len(req.candidate_ids)))


class RerankExecutor:
    """Score retrieval candidates with the reranker encoder; keep top-k."""
    name = "rerank"

    def __init__(self, comp, attn_impl=None):
        self._encode = Encoder(comp, attn_impl)

    def run(self, eng, req) -> None:
        cand = req.candidate_ids
        qv = self._encode(np.asarray(_query(req))[None])[0]
        dv = self._encode(eng.corpus[cand])
        scores = dv @ qv
        # jnp.argsort is stable: equal scores keep candidate order
        order = torch.argsort(-scores, stable=True)[:eng.cfg.retrieval_k]
        req.candidate_ids = cand[order.cpu().numpy()]
        if eng.tracer.enabled:
            eng.tracer.annotate(req.rid, scored=int(len(cand)),
                                kept=int(len(req.candidate_ids)))


class SafetyFilterExecutor:
    """Encoder-based screen over retrieved documents: each candidate doc
    gets a score from the safety encoder (first hidden dim through a
    sigmoid -- the stand-in for a trained safety head); docs scoring below
    ``cfg.safety_threshold`` are dropped from the prompt.  With threshold
    ``None`` the stage only records scores."""
    name = "safety_filter"

    def __init__(self, comp, attn_impl=None):
        self._encode = Encoder(comp, attn_impl)

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
        if eng.tracer.enabled:
            eng.tracer.annotate(req.rid, screened=int(len(cand)),
                                kept=int(len(req.candidate_ids)))

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

