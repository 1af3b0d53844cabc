"""Extended RAG pipeline presets built on the stage registry.

The paper's four case studies live in ``repro_torch.core.ragschema``; these
presets exercise the registry-only stages (multi-query fan-out, encoder
safety filter) and combinations the paper does not enumerate -- each is
just a RAGSchema instance, so ``optimizer.enumerate_plans`` can search it
and ``RAGEngine`` can execute the same shape.

Copied from ``src/repro/configs/rag_pipelines.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

from repro_torch.core.ragschema import (ENCODER_120M, LLAMA3_1B, MODELS,
                                        RAGSchema)


def baseline(generative: str = "8B") -> RAGSchema:
    """Plain retrieve -> prefill -> decode RAG (paper Case I shape); the
    anchor the serving benchmark measures every optional stage against."""
    return RAGSchema(generative=MODELS[generative])


def multi_query(generative: str = "8B", queries: int = 4) -> RAGSchema:
    """Multi-query fan-out RAG: a small LLM expands every question into
    ``queries`` search variants before hyperscale retrieval."""
    return RAGSchema(generative=MODELS[generative],
                     queries_per_retrieval=queries,
                     fanout_model=LLAMA3_1B)


def iterative(generative: str = "8B", frequency: int = 4) -> RAGSchema:
    """Iterative retrieval during decode (paper §5.3): ``frequency``
    retrieval events spread over the generation.  The shape where the
    disaggregated cluster's decode group does real mid-generation work
    (retrieve + chunk append land on the decode engines, priced by the
    stage's ``decode_stall``)."""
    return RAGSchema(generative=MODELS[generative],
                     retrieval_frequency=frequency)


def safety_screened(generative: str = "70B") -> RAGSchema:
    """Encoder safety screen over the assembled prompt before prefill.
    The screening threshold lives in the schema (single source of truth):
    ``EngineConfig.from_schema`` deploys it, the engine drops docs
    scoring below it."""
    return RAGSchema(generative=MODELS[generative],
                     safety_model=ENCODER_120M, safety_threshold=0.0)


def full_pipeline(generative: str = "70B", queries: int = 2) -> RAGSchema:
    """Every optional stage at once: rewrite -> fan-out -> retrieval ->
    rerank -> safety -> prefill/decode."""
    return RAGSchema(generative=MODELS[generative],
                     rewriter=MODELS["8B"], reranker=ENCODER_120M,
                     queries_per_retrieval=queries, fanout_model=LLAMA3_1B,
                     safety_model=ENCODER_120M, safety_threshold=0.0)


PRESETS = {
    "baseline": baseline,
    "iterative": iterative,
    "multi_query": multi_query,
    "safety_screened": safety_screened,
    "full_pipeline": full_pipeline,
}
