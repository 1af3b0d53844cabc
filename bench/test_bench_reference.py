"""The plain reference against the program at the configurations' toy
widths, on seeded weights, on the CPU: ``tr.forward``, a
``tr.paged_decode_step`` through a paged cache, the encoder and exact
retrieval.  Both sides compute in float32 here, so they agree to float32
rounding (a tolerance of 1e-4 of the largest value)."""

import json

import numpy as np
import pytest
import torch

from bench import tiny
from bench.core import model as M
from bench.core import spec
from bench.reference import knn
from bench.reference import lm as ref

CONFIGS = sorted(p.stem for p in (spec.BENCH_DIR / "configs").glob("*.json"))


def tiny_cfg(name):
    path = spec.BENCH_DIR / "configs" / f"{name}.json"
    return tiny.tiny_config(json.loads(path.read_text()))


def close(a, b, tol=1e-4):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * scale, float(
        (a - b).abs().max() / scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_matches_program_forward(name):
    from repro_torch.models import transformer as tr
    m = tiny_cfg(name)["model"]
    cfg = M.program_config(m, name)
    w = M.draw_weights(m, cfg.padded_vocab, 3, "cpu", dtype=torch.float32)
    toks = torch.randint(0, m["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    logits, _ = tr.forward(tr.TransformerParams(w), toks, cfg,
                           compute_dtype=torch.float32)
    got = ref.decoder_logits(w, m, [toks[0]], [torch.arange(40)])[0]
    close(got, logits[0, :, :m["vocab_size"]])


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_matches_paged_decode_step(name):
    """Prefill 10 tokens, lay the cache out in pages of 4 through a
    shuffled block table, decode token 11 through the pool."""
    from repro_torch.models import transformer as tr
    m = tiny_cfg(name)["model"]
    cfg = M.program_config(m, name)
    w = M.draw_weights(m, cfg.padded_vocab, 4, "cpu", dtype=torch.float32)
    params = tr.TransformerParams(w)
    seq = torch.randint(0, m["vocab_size"], (11,),
                        generator=torch.Generator().manual_seed(1))
    _, cache = tr.prefill(params, seq[None, :10], cfg,
                          compute_dtype=torch.float32)
    page, table = 4, [2, 0, 1]
    pool = tr.make_paged_cache(cfg, 3, page, dtype=torch.float32,
                               device="cpu")
    for key in ("k", "v"):
        for pos in range(10):
            pool[key][:, table[pos // page], pos % page] = cache[key][:, 0,
                                                                      pos]
    logits, _ = tr.paged_decode_step(
        params, pool, seq[10:11].to(torch.int32),
        torch.tensor([10], dtype=torch.int32),
        torch.tensor([table], dtype=torch.int32), cfg,
        compute_dtype=torch.float32)
    got = ref.decoder_logits(w, m, [seq], [torch.tensor([10])])[0]
    close(got, logits[:, :m["vocab_size"]])


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_and_exact_retrieval_match_the_program(name):
    from repro_torch.models import transformer as tr
    from repro_torch.retrieval.backend import ExactBackend
    e = tiny_cfg(name)["encoder"]
    cfg = M.program_config(e, name)
    w = M.draw_weights(e, cfg.padded_vocab, 5, "cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    docs = torch.randint(0, e["vocab_size"], (48, 16), generator=g)
    queries = torch.randint(0, e["vocab_size"], (6, 5), generator=g)
    params = tr.TransformerParams(w)
    db_prog = tr.encode(params, docs, cfg)
    db_ref = ref.encode(w, e, docs, block=16)
    close(db_ref, db_prog)
    q_prog = tr.encode(params, queries, cfg)
    q_ref = ref.encode(w, e, queries)
    _, ids = ExactBackend(db_prog, device="cpu").search(q_prog, 3)
    scores = knn.cosine_scores(q_ref, db_ref)
    assert np.array_equal(knn.top_k(scores, 3).numpy(), ids)
    for row, got in zip(scores, ids):
        assert knn.retrieval_gap(row, got, 3) == 0.0


def test_retrieval_gap_measures_how_far_below_the_kth():
    row = torch.tensor([0.9, 0.5, 0.8, 0.1])
    assert knn.retrieval_gap(row, [0, 2], 2) == 0.0
    assert knn.retrieval_gap(row, [2, 0], 2) == 0.0      # order is free
    assert knn.retrieval_gap(row, [0, 1], 2) == pytest.approx(0.3)
    assert knn.retrieval_gap(row, [0, 0], 2) == float("inf")
    assert knn.retrieval_gap(row, [0], 2) == float("inf")
    assert knn.retrieval_gap(row, [0, 7], 2) == float("inf")
    # ties go to the lower index
    assert knn.top_k(torch.tensor([1.0, 2.0, 2.0]), 2).tolist() == [1, 2]


def test_tiny_copy_keeps_every_cell(tmp_path):
    bm = tiny.make(tmp_path)
    for w in bm["workloads"]:
        cfg = json.loads((tmp_path / spec.config_entry(
            bm, w["config"])["file"]).read_text())
        assert cfg["model"]["hidden_size"] == 64
