"""The engine's ``attn_impl="splitk"``: decode through the distributed
split-K attention (``repro_torch.distributed.decode_attn``) on the 1 x 1
host mesh, on the CPU.

The stack is ``test_torch_engine.py``'s.  The port's ``"splitk"`` engine
must retrieve the same documents and emit the same greedy tokens as the
JAX engine's ``attn_impl="ref"`` (the reference's own ``"splitk"`` fails
that parity, ``tests/test_paged_attention.py``, so it is not the
yardstick) and as the port's ``"ref"`` engine, under the near-tie rule of
``test_torch_engine.py`` (a flip is reported with its step and JAX's
top-2 margin).  Paged and dense pools both.
"""

import numpy as np
import pytest
import torch

from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import RAGEngine as JRAGEngine
from repro.serving.request import Request as JRequest
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.serving import engine as te
from repro_torch.serving.request import Request
from test_torch_engine import (_compare_streams, _port, _same_up_to_near_tie,
                               stack)  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("pool", ["paged", "dense"])
def test_splitk_engine_matches_jax_ref(stack, pool):
    gen, enc, corpus, questions = stack
    base = {"decode_slots": 3, "s_max": 96, "max_new_tokens": 6,
            "paged": pool == "paged"}
    jeng = JRAGEngine(gen, enc, corpus, JEngineConfig(attn_impl="ref",
                                                      **base))
    jreqs = [JRequest(question=q.copy()) for q in questions]
    jeng.serve(jreqs)
    teng = te.RAGEngine(_port(gen), _port(enc), corpus,
                        te.EngineConfig(attn_impl="splitk", **base),
                        device="cpu")
    treqs = [Request(question=q.copy()) for q in questions]
    before = da.decode_attention_partial.launches
    teng.serve(treqs)
    _compare_streams(stack, jreqs, treqs)
    snap = teng.metrics_snapshot()
    assert snap["attn_impl"] == "splitk"
    for key in ("decode_steps", "prefills", "retrieved_queries"):
        assert snap[key] == jeng.metrics_snapshot()[key], key
    # CPU tensors take the partial's plain version: no kernel launch
    assert da.decode_attention_partial.launches == before


def test_splitk_engine_matches_port_ref(stack):
    gen, enc, corpus, questions = stack
    outs = {}
    for impl in ("ref", "splitk"):
        eng = te.RAGEngine(_port(gen), _port(enc), corpus,
                           te.EngineConfig(decode_slots=3, s_max=96,
                                           max_new_tokens=6,
                                           attn_impl=impl), device="cpu")
        reqs = [Request(question=q.copy()) for q in questions]
        eng.serve(reqs)
        assert eng.metrics_snapshot()["attn_impl"] == impl
        outs[impl] = reqs
    for i, (a, b) in enumerate(zip(outs["ref"], outs["splitk"])):
        assert a.retrieved_ids == b.retrieved_ids
        _same_up_to_near_tie(stack, a.prompt, np.asarray(a.output),
                             np.asarray(b.output), f"request {i}")


def test_splitk_is_an_engine_option():
    assert "splitk" in te.ATTN_IMPLS
    assert te.EngineConfig(attn_impl="splitk").attn_impl == "splitk"
