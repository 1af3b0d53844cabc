"""RAG serving engine on PyTorch/CUDA (mirror of ``repro.serving.engine``).

Pipeline per request, on one device:

  [rewrite] -> [multi-query fan-out] -> embed -> retrieve -> [rerank]
  -> [safety filter] -> prefill (question + docs) -> continuous-batched
  decode [-> iterative retrieval during decode]

The pre-prefill stages are the executors of ``repro_torch.serving.
executors``, chosen by the stage registry (``repro_torch.core.
stage_registry``, a copy of the JAX one) from the engine's components and
config; ``EngineConfig.from_schema`` derives the stage fields from a
``RAGSchema`` through the same registry.

Hot path, as in the JAX engine:

* Retrieval goes through a pluggable backend (``repro_torch.retrieval.
  backend``): exact kNN or IVF-PQ, whose ADC scan is the CUDA ``pq_scan``
  kernel on a CUDA device.
* KV state lives in the paged pool by default (``repro_torch.serving.
  kv_cache``); prompts are bucketed to powers of two, and content-
  addressed full pages are shared between requests that retrieved the
  same documents.  ``paged=False`` (implied by ``fused_decode=False``)
  keeps the dense slot pool.
* The decode step is one forward + argmax with one (B,)-token
  device->host copy per step; slots that are not stepping write nothing
  (on the dense pool that replaces JAX's whole-cache step-mask merge).
  Decode attention is a CUDA kernel on a CUDA device (``attn_impl=
  "cuda"``: paged-decode on the paged pool, dense decode on the dense
  one) or the reference masked softmax (``"ref"``).  With ``"cuda"``
  full-sequence attention -- prefill, the encoder (corpus and query
  embedding, rerank, safety screen) and the executors' greedy
  generation -- runs the flash attention kernel too; ``"ref"`` keeps the
  einsum paths that mirror JAX.  ``fused_decode=
  False`` keeps the pre-fusion path: argmax on the host, and the
  whole-cache copy JAX makes there counted in ``cache_copy_bytes``.
* Iteratively retrieved context and chunked prompt prefill share one
  bucketed chunk-extend forward (``tr.paged_chunk_extend``; dense:
  ``tr.chunk_extend``), with plain attention: a chunk attending to a
  cache at an offset is not the flash kernel's function.

PyTorch runs eagerly, so where the JAX engine jit-compiles one program
per prompt bucket, the port just runs the forward; ``prefill_compiles``
and ``append_compiles`` still count distinct buckets so the metrics read
the same.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.stage_registry import REGISTRY
from repro_torch.models import transformer as tr
from repro_torch.retrieval.backend import (ExactBackend, FallbackBackend,
                                           make_backend)
from repro_torch.serving.faults import EngineCrash, EngineHealth
from repro_torch.serving.kv_cache import KVCachePool, PagedKVCachePool
from repro_torch.serving.request import Request, State
from repro_torch.serving.telemetry import (NULL_TRACER, MetricsRegistry,
                                           stage_kind)

ATTN_IMPLS = ("auto", "ref", "cuda")


def bucket_len(n: int, floor: int = 8) -> int:
    """Next power of two >= n (shared prefill / chunk-append bucketing)."""
    return int(2 ** np.ceil(np.log2(max(n, floor))))


@dataclass
class EngineConfig:
    decode_slots: int = 4
    s_max: int = 256
    retrieval_k: int = 2
    max_new_tokens: int = 16
    iterative_interval: int | None = None  # tokens between retrievals
    retrieval_batch: int = 1               # iterative batch size (§5.3)
    rewrite_tokens: int = 0                # >0 enables the rewriter stage
    rerank: bool = False
    rerank_candidates: int = 8
    eos_token: int | None = None
    fanout_queries: int = 1                # >1 enables multi-query fan-out
    fanout_tokens: int = 4                 # generated tokens per variant
    safety_threshold: float | None = None  # drop docs scoring below this
    # retrieval backend (repro_torch.retrieval.backend)
    retrieval_backend: str = "exact"       # "exact" | "ivfpq"
    nprobe: int = 8                        # IVF lists probed per query
    use_pq_kernel: bool | None = None      # None = CUDA kernel on a GPU
    # graceful degradation: primary -> exact scan -> no-context chain
    retrieval_fallback: bool = True
    fused_decode: bool = True
    # decode attention: "auto" resolves at engine construction to the CUDA
    # kernels on a CUDA device and to the reference masked softmax on the
    # CPU
    attn_impl: str = "auto"              # "auto" | "ref" | "cuda"
    attn_num_buffers: int = 2            # page-load pipelining depth (unused
                                         # by the first CUDA kernel)
    # paged KV cache + continuous batching
    paged: bool = True                   # page-table pool (False: dense slots)
    page_size: int = 16                  # tokens per KV page
    kv_spare_pages: int | None = None    # extra pages kept as prefix cache
    prefill_chunk: int | None = None     # >0: chunk prefill across ticks
    iter_query_tokens: int = 8           # fixed iterative-query width

    def __post_init__(self):
        # the prompt budget s_max - max_new_tokens - 1 must be positive,
        # otherwise _assemble_prompt's prompt[-budget:] keeps the WHOLE
        # prompt and decode overflows the cache
        if self.s_max <= self.max_new_tokens + 1:
            raise ValueError(
                f"s_max={self.s_max} must exceed max_new_tokens + 1 = "
                f"{self.max_new_tokens + 1}: the prompt budget "
                f"(s_max - max_new_tokens - 1) would be empty and decode "
                f"would overflow the KV cache")
        if self.page_size <= 0:
            raise ValueError(f"page_size={self.page_size} must be positive")
        if self.iter_query_tokens <= 0:
            raise ValueError("iter_query_tokens must be positive")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl={self.attn_impl!r} must be one of "
                "'auto', 'ref', 'cuda'")
        if self.attn_num_buffers < 2:
            raise ValueError(
                f"attn_num_buffers={self.attn_num_buffers} must be >= 2 "
                "(one page in flight while computing another)")
        if not self.fused_decode:
            # the pre-fusion parity path decodes against the dense pool
            self.paged = False
        if self.prefill_chunk is not None:
            if self.prefill_chunk <= 0:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be positive")
            if not self.paged:
                raise ValueError(
                    "chunked prefill requires the paged KV pool "
                    "(paged=True with fused_decode=True)")

    @classmethod
    def from_schema(cls, schema, **overrides) -> "EngineConfig":
        """Derive an EngineConfig from a RAGSchema via the stage registry
        (``REGISTRY.engine_config_fields``): every enabled stage sets the
        fields it derives from the schema, so those are never hand-set
        beside a schema.  ``overrides`` carry deployment knobs the schema
        does not describe (``decode_slots``, the retrieval backend, ...)
        and win over derived values."""
        fields = REGISTRY.engine_config_fields(schema)
        fields.update(overrides)
        return cls(**fields)


@dataclass
class Component:
    cfg: tr.TransformerConfig
    params: tr.TransformerParams


class RAGEngine:
    def __init__(self, generative: Component, encoder: Component,
                 corpus_tokens: np.ndarray, cfg: EngineConfig,
                 rewriter: Component | None = None,
                 reranker: Component | None = None,
                 safety: Component | None = None,
                 db_vectors=None, backend=None, device="cuda"):
        """corpus_tokens: (n_docs, doc_len) int32 database passages.

        ``db_vectors`` / ``backend`` share one offline corpus encode and
        one built retrieval index (e.g. an index carried across from the
        JAX package).  ``device`` is where the models, the KV pool and the
        index live; the component weights are moved there."""
        self.device = resolve_device(device)
        for comp in (generative, encoder, rewriter, reranker, safety):
            if comp is not None:
                comp.params.to(self.device)
        self.gen = generative
        self.enc = encoder
        self.rewriter = rewriter
        self.reranker = reranker
        self.safety = safety
        self.cfg = cfg
        self.corpus = np.asarray(corpus_tokens)
        self.pool = (PagedKVCachePool(generative.cfg, cfg.decode_slots,
                                      cfg.s_max, page_size=cfg.page_size,
                                      spare_pages=cfg.kv_spare_pages,
                                      device=self.device)
                     if cfg.paged else
                     KVCachePool(generative.cfg, cfg.decode_slots, cfg.s_max,
                                 device=self.device))
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}     # slot -> request
        self.prefilling: dict[int, int] = {}     # slot -> prompt cursor
        self.pending_retrievals: list[Request] = []
        self.metrics = MetricsRegistry(
            {"decode_steps": 0, "idle_slot_steps": 0,
             "retrieval_batches": 0, "retrieved_queries": 0,
             "prefills": 0,
             "prefill_compiles": 0, "append_compiles": 0,
             "host_syncs": 0, "decode_host_syncs": 0,
             "cache_copy_bytes": 0, "capacity_stops": 0,
             "degraded_answers": 0, "stage_time_s": {}})
        self.tracer = NULL_TRACER
        self.trace_name = "engine0"
        self.tick_no = 0
        self.health = EngineHealth.HEALTHY
        self.fail_reason: str | None = None
        self.injector = None
        self._retrieval_degraded = False
        # resolved attention implementation ("auto" picks by device)
        self.attn_impl = cfg.attn_impl if cfg.attn_impl != "auto" else (
            "cuda" if self.device.type == "cuda" else "ref")
        self.paged_attn, self.dense_attn, self.seq_attn = \
            self._make_attn_impls()
        self._prefill_buckets: set[int] = set()
        self._append_buckets: set[int] = set()
        # database embeddings (the paper's offline encode step)
        self.db_vectors = (torch.as_tensor(db_vectors).to(self.device)
                           if db_vectors is not None
                           else self._embed_batched(self.corpus))
        primary = backend if backend is not None else make_backend(
            cfg.retrieval_backend, self.db_vectors, nprobe=cfg.nprobe,
            use_pq_kernel=cfg.use_pq_kernel, device=self.device)
        if cfg.retrieval_fallback and not isinstance(primary,
                                                     FallbackBackend):
            # degradation ladder: primary -> exact scan -> no-context
            chain = [primary]
            if primary.name != "exact":
                chain.append(ExactBackend(self.db_vectors,
                                          device=self.device))
            primary = FallbackBackend(chain)
        self.backend = primary
        self.executors = REGISTRY.engine_executors(self)

    # ---------------- health / fault API ------------------------------------

    @property
    def healthy(self) -> bool:
        """Alive (not DEAD); a DRAINING engine is alive but not accepting."""
        return self.health is not EngineHealth.DEAD

    @property
    def accepting(self) -> bool:
        """Eligible for NEW dispatch (HEALTHY or DEGRADED)."""
        return self.health in (EngineHealth.HEALTHY, EngineHealth.DEGRADED)

    def fail(self, reason: str = "injected") -> None:
        """Declare this engine dead; any further use raises EngineCrash."""
        self.health = EngineHealth.DEAD
        self.fail_reason = reason

    def degrade(self) -> None:
        """Record a survived transient fault (still serving)."""
        if self.health is EngineHealth.HEALTHY:
            self.health = EngineHealth.DEGRADED

    def drain(self) -> None:
        """Park this engine in DRAINING: no new work.  Idempotent; raises
        on a DEAD engine (no DEAD -> DRAINING edge)."""
        if self.health is EngineHealth.DRAINING:
            return
        if self.health is EngineHealth.DEAD:
            raise EngineCrash(
                f"cannot drain a dead engine ({self.fail_reason})")
        self.health = EngineHealth.DRAINING

    def undrain(self) -> None:
        """Abort a drain: re-enter service as DEGRADED."""
        if self.health is EngineHealth.DRAINING:
            self.health = EngineHealth.DEGRADED

    def check_alive(self) -> None:
        if self.health is EngineHealth.DEAD:
            raise EngineCrash(f"engine is dead ({self.fail_reason})")

    def set_injector(self, injector) -> None:
        """Thread a fault injector through the retrieval fallback chain."""
        self.injector = injector
        if isinstance(self.backend, FallbackBackend):
            self.backend.injector = injector

    def note_retrieval_degraded(self, req: Request) -> None:
        """Flag ``req`` as degraded if its last retrieval was served with
        no context at all; counted once per request."""
        if self._retrieval_degraded and not req.degraded:
            req.degraded = True
            self.metrics["degraded_answers"] += 1

    # ---------------- shared primitives -----------------------------------

    def _make_attn_impls(self):
        """The (paged decode, dense decode, full-sequence) attention
        callables for the resolved ``attn_impl``; ``(None, None, None)``
        keeps the model functions' built-in references."""
        if self.attn_impl == "ref":
            return None, None, None
        from repro_torch.kernels.decode_attention.ops import decode_attention
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.paged_attention.ops import (
            paged_decode_attention)
        return paged_decode_attention, decode_attention, flash_attention

    def has_executor(self, name: str) -> bool:
        return any(ex.name == name for ex in self.executors)

    def set_tracer(self, tracer) -> None:
        self.tracer = tracer if tracer is not None else NULL_TRACER

    @contextmanager
    def _timed(self, stage: str, req: Request | None = None, attrs=None):
        """Accumulate wall time into ``metrics['stage_time_s'][stage]`` and
        a per-stage latency histogram.  Work queued on the device inside
        the stage counts where its result is read back (each stage below
        ends in a host copy of its result)."""
        t0 = time.monotonic()
        tracer = self.tracer
        span = None
        if tracer.enabled and req is not None:
            span = tracer.begin(stage_kind(stage), rid=req.rid,
                                engine=self.trace_name, t=t0,
                                tick=self.tick_no,
                                attempt=req.retries + req.migrations,
                                attrs=attrs)
        try:
            yield
        finally:
            t1 = time.monotonic()
            acc = self.metrics["stage_time_s"]
            acc[stage] = acc.get(stage, 0.0) + t1 - t0
            self.metrics.observe("stage_seconds:" + stage, t1 - t0)
            if span is not None:
                tracer.end(span, t=t1)
            elif tracer.enabled:
                tracer.record(stage_kind(stage), t0, t1,
                              engine=self.trace_name, tick=self.tick_no,
                              attrs=attrs)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _embed_batched(self, tokens: np.ndarray, bs: int = 32) -> torch.Tensor:
        """Encode rows in fixed-size batches; the final ragged chunk is
        padded to ``bs`` rows and the pad rows are sliced off (each row
        embeds independently).  Raises ``ValueError`` for an id past the
        encoder's embedding table (``tr.check_ids``; JAX gives NaN)."""
        tokens = np.asarray(tokens)
        tr.check_ids(tokens, self.enc.cfg)
        outs = []
        for i in range(0, tokens.shape[0], bs):
            chunk = tokens[i:i + bs]
            valid = chunk.shape[0]
            if valid < bs:
                chunk = np.pad(chunk, ((0, bs - valid), (0, 0)))
            h = tr.encode(self.enc.params, self._tensor(chunk), self.enc.cfg,
                          attn_impl=self.seq_attn)
            outs.append(h[:valid])
        return torch.cat(outs)

    def retrieve(self, queries: np.ndarray, k: int) -> np.ndarray:
        """queries: (B, T) -> (B, k) doc indices via the retrieval backend.
        Approximate backends may pad the id tail with -1."""
        with self._timed("embed"):
            qv = self._embed_batched(queries)
        with self._timed("retrieve"):
            _, idx = self.backend.search(qv, k)
        self.metrics["retrieved_queries"] += len(queries)
        self._retrieval_degraded = \
            getattr(self.backend, "last_level", 0) == -1
        self.metrics["host_syncs"] += 1
        return np.asarray(idx)

    # ---------------- admission / prefill ----------------------------------

    def _assemble_prompt(self, req: Request) -> np.ndarray:
        q = req.rewritten if req.rewritten is not None else req.question
        ids = req.candidate_ids if req.candidate_ids is not None \
            else np.asarray([], np.int64)
        req.retrieved_ids.append(list(map(int, ids)))
        docs = self.corpus[ids].reshape(-1)
        prompt = np.concatenate([docs, q])
        max_prompt = self.cfg.s_max - self.cfg.max_new_tokens - 1
        return prompt[-max_prompt:].astype(np.int32)

    def _prefill(self, req: Request, slot: int) -> None:
        self.prefill_compute(req, slot)
        req.state = State.DECODE
        req.slot = slot

    def prefill_compute(self, req: Request, slot: int) -> None:
        """Bucketed prefill: pad the prompt to the next power of two and
        run one full-logits forward.  Causality makes tail padding inert;
        the first token is read at position len(prompt)-1 and only the
        valid cache prefix is installed in the slot."""
        req.state = State.PREFILL
        prompt = req.prompt
        length = len(prompt)
        bucket = bucket_len(length)
        if bucket not in self._prefill_buckets:
            self._prefill_buckets.add(bucket)
            self.metrics["prefill_compiles"] += 1
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :length] = prompt
        logits, _aux, cache = tr.forward(self.gen.params,
                                         self._tensor(padded), self.gen.cfg,
                                         collect_cache=True,
                                         attn_impl=self.seq_attn)
        # the bucket salts the page keys: pages are shared only between
        # prefills that ran the same shapes on the same inputs
        self.pool.write_prefix(slot, cache, length, tokens=prompt,
                               key_salt=str(bucket).encode())
        tok = int(torch.argmax(logits[0, length - 1,
                                      :self.gen.cfg.vocab_size]))
        self.metrics["host_syncs"] += 1
        req.output.append(tok)
        req.t_first_token = time.monotonic()
        self.metrics["prefills"] += 1

    def _admit(self) -> None:
        while self.queue and self.pool.free:
            req = self.queue.pop(0)
            for ex in self.executors:
                with self._timed(ex.name, req=req):
                    ex.run(self, req)
            req.prompt = self._assemble_prompt(req)
            slot = self.pool.alloc(req.rid)
            if self.cfg.prefill_chunk:
                # the prompt streams in chunk by chunk across decode ticks
                req.state = State.PREFILL
                req.slot = slot
                self.prefilling[slot] = 0
                self.active[slot] = req
            else:
                with self._timed("prefill", req=req):
                    self._prefill(req, slot)
                self.active[req.slot] = req

    def _prefill_tick(self) -> None:
        """Advance every chunk-prefilling slot by one prompt chunk; the
        final chunk's logits give the request's first token."""
        if not self.prefilling:
            return
        chunk = self.cfg.prefill_chunk
        with self._timed("prefill"):
            for slot, cursor in list(self.prefilling.items()):
                req = self.active[slot]
                piece = req.prompt[cursor:cursor + chunk]
                logits = self._paged_extend(slot, piece)
                cursor += len(piece)
                if cursor >= len(req.prompt):
                    del self.prefilling[slot]
                    tok = int(torch.argmax(logits[:self.gen.cfg.vocab_size]))
                    self.metrics["host_syncs"] += 1
                    req.output.append(tok)
                    req.t_first_token = time.monotonic()
                    self.metrics["prefills"] += 1
                    req.state = State.DECODE
                else:
                    self.prefilling[slot] = cursor

    # ---------------- decode loop ------------------------------------------

    def _append_tokens(self, slot: int, tokens: np.ndarray) -> None:
        """Append retrieved content into a slot's cache (iteration
        prefill) with one bucketed chunk-extend forward."""
        t = len(tokens)
        if t == 0:
            return
        if isinstance(self.pool, PagedKVCachePool):
            self._paged_extend(slot, np.asarray(tokens, np.int32))
            return
        bucket = bucket_len(t)
        if bucket not in self._append_buckets:
            self._append_buckets.add(bucket)
            self.metrics["append_compiles"] += 1
        padded = np.zeros(bucket, np.int32)
        padded[:t] = tokens
        self.pool.cache = tr.chunk_extend(
            self.gen.params, self.pool.cache, slot, self._tensor(padded),
            int(self.pool.lengths[slot]), t, self.gen.cfg)
        self.pool.lengths[slot] += t

    def _paged_extend(self, slot: int, tokens: np.ndarray) -> torch.Tensor:
        """Allocate/COW the pages the write range touches, then one
        ``tr.paged_chunk_extend`` per power-of-two bucket writes the
        chunk.  Returns the last valid row's logits (left on the device;
        only chunked prefill's final chunk reads them)."""
        t = len(tokens)
        self.pool.prepare_append(slot, t)
        bucket = bucket_len(t)
        if bucket not in self._append_buckets:
            self._append_buckets.add(bucket)
            self.metrics["append_compiles"] += 1
        padded = np.zeros(bucket, np.int32)
        padded[:t] = tokens
        self.pool.cache, logits = tr.paged_chunk_extend(
            self.gen.params, self.pool.cache,
            self._tensor(self.pool.block_row(slot)), self._tensor(padded),
            int(self.pool.lengths[slot]), t, self.gen.cfg)
        self.pool.lengths[slot] += t
        return logits

    def _iter_query(self, req: Request) -> np.ndarray:
        """Fixed-width iterative-retrieval query: the last
        ``iter_query_tokens`` generated tokens, falling back to the tail
        of the question, left-padded to a constant width."""
        w = self.cfg.iter_query_tokens
        src = (np.asarray(req.output[-w:], np.int32)
               if len(req.output) >= w
               else np.asarray(req.question[-w:], np.int32))
        if len(src) < w:
            src = np.pad(src, (w - len(src), 0))
        return src

    def _dispatch_iterative(self, force: bool = False) -> None:
        r = self.cfg.retrieval_batch
        while (len(self.pending_retrievals) >= r
               or (force and self.pending_retrievals)):
            batch = self.pending_retrievals[:r]
            self.pending_retrievals = self.pending_retrievals[r:]
            qs = np.stack([self._iter_query(req) for req in batch])
            ids = self.retrieve(qs, 1)
            self.metrics["retrieval_batches"] += 1
            for req in batch:
                self.note_retrieval_degraded(req)
            for req, docs in zip(batch, ids):
                if req.state is not State.WAIT_RETRIEVAL:
                    continue                    # finished (EOS) while queued
                docs = docs[docs >= 0]          # drop ANN padding ids
                for ex in self.executors:
                    fi = getattr(ex, "filter_iterative", None)
                    if fi is not None:
                        with self._timed(ex.name):
                            docs = fi(self, req, docs)
                req.retrieved_ids.append(list(map(int, docs)))
                req.retrievals_done += 1
                if len(docs):
                    new_ctx = self.corpus[docs[0]]
                    # reserve one cache position per remaining decode step
                    remaining = req.max_new_tokens - len(req.output)
                    room = (self.pool.s_max
                            - int(self.pool.lengths[req.slot]) - remaining)
                    if room > 0:
                        with self._timed("append"):
                            self._append_tokens(req.slot, new_ctx[:room])
                req.state = State.DECODE

    def _decode_step(self) -> None:
        token_vec = np.zeros(self.pool.n_slots, np.int32)
        stepping, at_capacity = [], []
        for slot, req in self.active.items():
            if req.state is not State.DECODE:
                continue
            if self.pool.lengths[slot] >= self.pool.s_max:
                at_capacity.append(slot)
                continue
            token_vec[slot] = req.output[-1]
            stepping.append(slot)
        for slot in at_capacity:
            req = self.active.pop(slot)
            req.state = State.DONE
            req.t_done = time.monotonic()
            self.metrics["capacity_stops"] += 1
            self.pool.release(slot)
        self.metrics["decode_steps"] += 1
        self.metrics["idle_slot_steps"] += self.pool.n_slots - len(stepping)
        self.tick_no += 1
        if not stepping:
            return
        with self._timed("decode"):
            self._decode_active(token_vec, stepping)

    def decode_logits(self, token_vec: np.ndarray,
                      step_mask: np.ndarray) -> torch.Tensor:
        """One decode step over every slot of the pool: (B, V) logits on
        the device.  Slots with ``step_mask`` False write nothing and
        their logits are to be ignored."""
        if isinstance(self.pool, PagedKVCachePool):
            logits, self.pool.cache = tr.paged_decode_step(
                self.gen.params, self.pool.cache, self._tensor(token_vec),
                self.pool.positions(),
                self._tensor(self.pool.block_tables()), self.gen.cfg,
                attn_impl=self.paged_attn,
                write_mask=self._tensor(step_mask))
        else:
            logits, self.pool.cache = tr.decode_step(
                self.gen.params, self.pool.cache, self._tensor(token_vec),
                self.pool.positions(), self.gen.cfg,
                attn_impl=self.dense_attn,
                write_mask=self._tensor(step_mask))
        return logits[:, :self.gen.cfg.vocab_size]

    def _decode_active(self, token_vec, stepping) -> None:
        if isinstance(self.pool, PagedKVCachePool):
            for slot in stepping:        # allocate/COW each write target
                self.pool.prepare_append(slot, 1)
        step_mask = np.zeros(self.pool.n_slots, bool)
        step_mask[stepping] = True
        logits = self.decode_logits(token_vec, step_mask)
        if self.cfg.fused_decode:
            # the step's one sync: (B,) tokens
            new_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            # pre-fusion path (kept for parity tests): argmax on the host;
            # JAX rebuilds the whole cache here, and the count says so
            new_tokens = np.argmax(logits.float().cpu().numpy(), axis=-1)
            self.metrics["cache_copy_bytes"] += sum(
                v.numel() * v.element_size()
                for v in self.pool.cache.values())
        self.metrics["host_syncs"] += 1
        self.metrics["decode_host_syncs"] += 1
        self.pool.advance(stepping)
        done_slots = []
        for slot in stepping:
            req = self.active[slot]
            tok = int(new_tokens[slot])
            req.output.append(tok)
            n_out = len(req.output)
            it = self.cfg.iterative_interval
            if (it and n_out % it == 0
                    and n_out < req.max_new_tokens
                    and req.state is State.DECODE):
                req.state = State.WAIT_RETRIEVAL
                self.pending_retrievals.append(req)
            if (n_out >= req.max_new_tokens
                    or (self.cfg.eos_token is not None
                        and tok == self.cfg.eos_token)):
                req.state = State.DONE
                req.t_done = time.monotonic()
                done_slots.append(slot)
        for slot in done_slots:
            self.active.pop(slot)
            self.pool.release(slot)

    # ---------------- public API ------------------------------------------

    def tick(self) -> None:
        """One continuous-batching iteration: admit, advance chunked
        prefills by one chunk, dispatch due iterative retrievals, take one
        decode step."""
        self.check_alive()
        self._admit()
        self._prefill_tick()
        self._dispatch_iterative(
            force=not any(r.state is State.DECODE
                          for r in self.active.values()))
        self._decode_step()

    def metrics_snapshot(self) -> dict:
        """Engine counters merged with the KV pool's page counters; a fully
        detached copy."""
        out = self.metrics.snapshot()
        out["attn_impl"] = self.attn_impl
        out["health"] = self.health.value
        if isinstance(self.backend, FallbackBackend):
            out["retrieval_fallbacks"] = self.backend.metrics["fallbacks"]
            out["retrieval_no_context"] = self.backend.metrics["no_context"]
        out.update(dict(getattr(self.pool, "metrics", {})))
        return out

    def abort_request(self, req: Request, reason: str,
                      now: float | None = None) -> None:
        """Force ``req`` to FAILED and release everything it holds here."""
        if req.done:
            return
        self.queue[:] = [r for r in self.queue if r is not req]
        self.pending_retrievals = [r for r in self.pending_retrievals
                                   if r is not req]
        for slot, r in list(self.active.items()):
            if r is req:
                self.active.pop(slot)
                self.prefilling.pop(slot, None)
                self.pool.release(slot)
        req.state = State.FAILED
        req.fail_reason = reason
        req.t_done = now if now is not None else time.monotonic()

    def serve(self, requests: list[Request],
              max_steps: int = 10000) -> list[Request]:
        """Closed-batch wrapper: submit every request to a throwaway
        :class:`~repro_torch.serving.server.RAGServer` and drain it."""
        from repro_torch.serving.server import RAGServer
        server = RAGServer(self)
        for r in requests:
            server.submit_request(r)
        server.run_until_idle(max_steps=max_steps)
        return requests
