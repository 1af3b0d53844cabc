"""Port vs JAX: the serving engine end to end on the CPU.

The stack is the one of ``tests/test_paged_attention.py`` (a 2-layer
generator, a bidirectional encoder, a 48-document topical corpus), with
the JAX weights carried across by ``repro_torch.bridge``.  The port's
engine must retrieve the same documents and emit the same greedy token
streams as the JAX engine's ``attn_impl="ref"`` path (which the Pallas
kernel matches token for token), both computing in bf16.

A bf16 logit near-tie could in principle flip a greedy token between two
frameworks that round the same products in different orders.  Such a flip
is never waved through silently: the test reports the request, the step
and the JAX top-2 margin, and holds the teacher-forced logits of both
frameworks at that step to the bf16 tolerance; only then does it accept
the streams up to the flip.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import topical_corpus
from repro.models import transformer as jtr
from repro.serving.engine import Component as JComponent
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import RAGEngine as JRAGEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.models import transformer as tr
from repro_torch.retrieval.backend import IVFPQBackend
from repro_torch.serving import engine as te
from repro_torch.serving.request import Request, State

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

VOCAB = 128
BF16_TOL = 6e-2          # see tests/test_torch_model.py
NEAR_TIE = 4 * 2 ** -7   # a few bf16 steps of a logit of order one


def _component(seed, causal=True, d=48):
    cfg = jtr.TransformerConfig(name=f"pa{seed}", n_layers=2, d_model=d,
                                n_heads=4, n_kv_heads=2, d_head=16, d_ff=64,
                                vocab_size=VOCAB, causal=causal)
    return JComponent(cfg, jtr.init_params(jax.random.PRNGKey(seed), cfg))


def _port(comp: JComponent) -> te.Component:
    return te.Component(
        bridge.config_from_jax(dataclasses.asdict(comp.cfg)),
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      comp.params),
                               device="cpu"))


@pytest.fixture(scope="module")
def stack():
    gen, enc = _component(0), _component(1, causal=False, d=32)
    corpus, _, make_q = topical_corpus(48, 10, VOCAB, n_topics=4)
    questions = [make_q(i % 4) for i in range(5)]
    return gen, enc, corpus, questions


def _teacher_forced(stack, prompt, prefix):
    """Next-token logits after ``prompt + prefix`` from both frameworks."""
    gen = stack[0]
    toks = np.concatenate([prompt, prefix]).astype(np.int32)[None]
    jl, _ = jtr.forward(gen.params, jnp.asarray(toks), gen.cfg)
    pg = _port(gen)
    tl, _ = tr.forward(pg.params, torch.tensor(toks), pg.cfg)
    return (np.asarray(jl[0, -1, :VOCAB], np.float32),
            bridge.tensor_to_numpy(tl[0, -1, :VOCAB]))


def _same_up_to_near_tie(stack, prompt, jout, tout, label):
    """Greedy streams ``jout`` (JAX) and ``tout`` (port) after ``prompt``
    are equal, or equal up to a bf16 near-tie flip (module docstring)."""
    jout, tout = list(map(int, jout)), list(map(int, tout))
    if tout == jout:
        return
    step = next(t for t, (a, b) in enumerate(zip(jout, tout)) if a != b)
    jl, tl = _teacher_forced(stack, prompt, np.asarray(jout[:step]))
    top2 = np.sort(jl)[-2:]
    margin = float(top2[1] - top2[0])
    msg = (f"{label} step {step}: JAX token {jout[step]}, port token "
           f"{tout[step]}, JAX top-2 margin {margin}")
    print(msg)
    np.testing.assert_allclose(tl, jl, rtol=BF16_TOL, atol=BF16_TOL,
                               err_msg=msg)
    assert margin <= NEAR_TIE, "not a near-tie: " + msg
    warnings.warn("bf16 near-tie flip: " + msg)


def _compare_streams(stack, jreqs, treqs):
    for i, (jr, trq) in enumerate(zip(jreqs, treqs)):
        assert trq.state is State.DONE
        assert trq.retrieved_ids == jr.retrieved_ids, f"request {i}"
        _same_up_to_near_tie(stack, jr.prompt, jr.output, trq.output,
                             f"request {i}")


#: the stack's component that plays each optional stage's model
STAGE_MODELS = {"rewriter": 0, "reranker": 1, "safety": 1}


def _serve_both(stack, stages=(), **kw):
    """Serve the stack's questions on the JAX ``"ref"`` engine and on the
    port's engine with the same config; ``stages`` names the optional
    stage models (``rewriter``, ``reranker``, ``safety``) to give both."""
    gen, enc, corpus, questions = stack
    base = {"decode_slots": 3, "s_max": 96, "max_new_tokens": 6, **kw}
    jstages = {s: stack[STAGE_MODELS[s]] for s in stages}
    jeng = JRAGEngine(gen, enc, corpus, JEngineConfig(attn_impl="ref",
                                                      **base), **jstages)
    jreqs = [JRequest(question=q.copy()) for q in questions]
    jeng.serve(jreqs)
    backend = None
    if base.get("retrieval_backend") == "ivfpq":
        # the JAX index, carried across: k-means seeds differ by framework
        idx = jeng.backend.chain[0].index
        backend = IVFPQBackend.from_index(
            bridge.index_from_jax(idx.centroids, idx.codebooks,
                                  idx.list_ids, idx.list_codes,
                                  idx.n_vectors, device="cpu"),
            nprobe=base.get("nprobe", 8), device="cpu")
    teng = te.RAGEngine(_port(gen), _port(enc), corpus,
                        te.EngineConfig(**base), backend=backend,
                        device="cpu",
                        **{s: _port(c) for s, c in jstages.items()})
    treqs = [Request(question=q.copy()) for q in questions]
    teng.serve(treqs)
    np.testing.assert_allclose(teng.db_vectors.numpy(), jeng.db_vectors,
                               rtol=1e-5, atol=1e-5)
    return jeng, jreqs, teng, treqs


PRESETS = {
    "exact": {},
    "ivfpq": {"retrieval_backend": "ivfpq", "nprobe": 4},
    "prefill_chunk": {"prefill_chunk": 8},
    "iterative": {"iterative_interval": 3, "retrieval_batch": 2,
                  "max_new_tokens": 9},
    # every slot retrieves at once: a batch's rows append in one call
    "iterative_batch": {"iterative_interval": 3, "retrieval_batch": 3,
                        "max_new_tokens": 9},
}


def _appends(snap) -> int:
    """The engine's ``append`` stages: one a request that appended in the
    JAX engine, one a retrieval batch that appended in the port's."""
    h = snap["histograms"].get("stage_seconds:append")
    return h["count"] if h else 0


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_engine_matches_jax_ref(stack, preset):
    jeng, jreqs, teng, treqs = _serve_both(stack, **PRESETS[preset])
    _compare_streams(stack, jreqs, treqs)
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert ts["attn_impl"] == "ref"
    for key in ("decode_steps", "idle_slot_steps", "prefills",
                "retrieved_queries", "retrieval_batches", "host_syncs",
                "decode_host_syncs", "capacity_stops", "prefill_compiles",
                "append_compiles", "pages_allocated", "pages_shared",
                "pages_cow", "pages_evicted"):
        assert ts[key] == js[key], key
    assert set(ts["stage_time_s"]) == set(js["stage_time_s"])
    # a retrieval batch's appends are one chunk-extend forward (its rows'
    # documents share one bucket here)
    assert ts["append_rows"] == _appends(js)
    assert ts["append_calls"] == _appends(ts)
    if PRESETS[preset].get("retrieval_batch", 1) >= 3:
        assert ts["append_calls"] < ts["append_rows"]


def test_kernel_wrapper_as_attention_gives_the_same_tokens(stack):
    """``attn_impl="cuda"`` on CPU tensors runs the kernel's plain version
    (f32 probabilities): same tokens as "ref" on this stack."""
    gen, enc, corpus, questions = stack
    outs = []
    for impl in ("ref", "cuda"):
        eng = te.RAGEngine(_port(gen), _port(enc), corpus,
                           te.EngineConfig(decode_slots=3, s_max=96,
                                           max_new_tokens=6,
                                           attn_impl=impl), device="cpu")
        reqs = [Request(question=q.copy()) for q in questions]
        eng.serve(reqs)
        assert eng.metrics_snapshot()["attn_impl"] == impl
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
