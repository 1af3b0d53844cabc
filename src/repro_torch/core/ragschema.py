"""RAGSchema (paper §3.2, Table 1): the workload abstraction.

Captures (1) pipeline structure -- which optional stages exist -- and
(2) per-component configuration.  Model sizes are parameter counts; the
paper assumes 8-bit weights so bytes == params.  ``ModelShape`` carries the
concrete transformer dimensions the operator-level cost model needs.

The pipeline itself is not hard-coded here: ``RAGSchema.stages()`` asks the
stage registry (``repro_torch.core.stage_registry``) which registered
stages the schema's fields enable, so new stages become schedulable by
registering a StageSpec -- no schema edits beyond the enabling field.

Copied from ``src/repro/core/ragschema.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.stage_registry import REGISTRY


@dataclass(frozen=True)
class ModelShape:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int = 128256
    n_ffn_mats: int = 3            # SwiGLU

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def params(self) -> float:
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
        ffn = self.n_ffn_mats * d * self.d_ff
        return self.n_layers * (attn + ffn) + 2 * self.vocab * d

    @property
    def kv_bytes_per_token(self) -> float:
        """int8 KV cache bytes per token (paper assumes 8-bit)."""
        return 2 * self.n_layers * self.n_kv_heads * self.d_head


# Llama-3 family (paper §4) + sentence-transformer encoder/reranker (120M).
LLAMA3_1B = ModelShape("llama3-1b", 16, 2048, 32, 8, 8192, 128256)
LLAMA3_8B = ModelShape("llama3-8b", 32, 4096, 32, 8, 14336, 128256)
LLAMA3_70B = ModelShape("llama3-70b", 80, 8192, 64, 8, 28672, 128256)
LLAMA3_405B = ModelShape("llama3-405b", 126, 16384, 128, 8, 53248, 128256)
ENCODER_120M = ModelShape("st-120m", 12, 768, 12, 12, 3072, 30522)

MODELS = {"1B": LLAMA3_1B, "8B": LLAMA3_8B, "70B": LLAMA3_70B,
          "405B": LLAMA3_405B, "120M": ENCODER_120M}


def model_for_params(params_b: float) -> ModelShape:
    """Nearest standard shape for a parameter count given in billions."""
    table = {1: LLAMA3_1B, 8: LLAMA3_8B, 70: LLAMA3_70B, 405: LLAMA3_405B,
             0.12: ENCODER_120M}
    key = min(table, key=lambda k: abs(k - params_b))
    return table[key]


@dataclass(frozen=True)
class RAGSchema:
    """Paper Table 1 attributes + sequence-length workload parameters."""
    generative: ModelShape = LLAMA3_8B
    encoder: ModelShape | None = None         # document/database encoder
    rewriter: ModelShape | None = None        # generative query rewriter
    reranker: ModelShape | None = None        # encoder-only reranker
    # retrieval configuration
    db_vectors: float = 64e9
    vector_dim: int = 768
    bytes_per_vec: int = 96                   # PQ: 1 byte / 8 dims
    scan_fraction: float = 0.001              # 0.1% default (§4)
    retrieval_frequency: int = 1              # per generated sequence
    queries_per_retrieval: int = 1
    # sequence lengths (§4 methodology)
    question_len: int = 32
    prefix_len: int = 512                     # question + retrieved content
    decode_len: int = 256
    rewriter_out_len: int = 32
    rerank_candidates: int = 16
    rerank_doc_tokens: int = 100
    # long-context (Case II): raw context tokens to encode, else None
    encode_context_len: int | None = None
    chunk_size: int = 128
    # multi-query fan-out stage: set fanout_model (with
    # queries_per_retrieval > 1) to generate the query variants as a real
    # pipeline stage; leave None to keep the paper's retrieval-load-only
    # semantics for multiple query vectors (Fig. 6)
    fanout_model: ModelShape | None = None
    fanout_out_len: int = 16               # generated tokens per variant
    # encoder-based safety screen over the assembled prompt, else None;
    # docs scoring below safety_threshold are dropped (None = score only)
    safety_model: ModelShape | None = None
    safety_threshold: float | None = None

    @property
    def has_iterative(self) -> bool:
        return self.retrieval_frequency > 1

    def stages(self) -> list[str]:
        """Ordered pipeline stage names, derived from the stage registry
        (every registered stage whose enabling schema field is set)."""
        return REGISTRY.pipeline(self)

    def xpu_stages_before_decode(self) -> list[str]:
        """Placement-searchable accelerator stages (excludes the host-only
        retrieval stage and the decode-anchored stage)."""
        return REGISTRY.xpu_stages(self)


# ---------------------------------------------------------------------------
# Paper case studies (Table 3)
# ---------------------------------------------------------------------------

def case_I(generative="8B", queries_per_retrieval=1) -> RAGSchema:
    """Hyperscale retrieval."""
    return RAGSchema(generative=MODELS[generative],
                     queries_per_retrieval=queries_per_retrieval)


def case_II(generative="70B", context_tokens=1_000_000) -> RAGSchema:
    """Long-context processing: small DB built on the fly, brute-force kNN."""
    n_vec = context_tokens // 128
    return RAGSchema(generative=MODELS[generative], encoder=ENCODER_120M,
                     db_vectors=float(n_vec), bytes_per_vec=768 * 2,
                     scan_fraction=1.0, encode_context_len=context_tokens)


def case_III(generative="70B", retrieval_frequency=4) -> RAGSchema:
    """Iterative retrievals during decode."""
    return RAGSchema(generative=MODELS[generative],
                     retrieval_frequency=retrieval_frequency)


def case_IV(generative="70B") -> RAGSchema:
    """Query rewriter + reranker."""
    return RAGSchema(generative=MODELS[generative], rewriter=LLAMA3_8B,
                     reranker=ENCODER_120M)


def llm_only(generative="70B") -> RAGSchema:
    """LLM-only baseline: no retrieval, question-only prompt."""
    return RAGSchema(generative=MODELS[generative], db_vectors=0.0,
                     prefix_len=32)
