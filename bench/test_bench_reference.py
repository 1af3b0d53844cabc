"""The plain reference against the program at the configurations' toy
widths, on seeded weights, on the CPU: ``tr.forward`` and a
``tr.paged_decode_step`` through the program's paged pool, each served
model through its family (``spec.family``: weights, program, reference),
then the encoder and exact retrieval.  Both sides compute in float32
here, so they agree to float32 rounding (a tolerance of 1e-4 of the
largest value)."""

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


def served_f32(name, seed):
    """A configuration's toy model through its family: the ``model``
    group, the family, the drawn weights in float32, the program's config
    and parameters of them."""
    cfg = tiny_cfg(name)
    fam = spec.family(cfg)
    m = cfg["model"]
    w = f32(fam.draw_weights(m, fam.program_config(m, name), seed, "cpu"))
    prog, params = fam.program_component(m, w, name, False)
    return m, fam, w, prog, params


def f32(tree: dict) -> dict:
    return {k: f32(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_matches_program_forward(name):
    from repro_torch.models import transformer as tr
    m, fam, w, prog, params = served_f32(name, 3)
    toks = torch.randint(0, m["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    logits, _ = tr.forward(params, toks, prog, compute_dtype=torch.float32)
    got = fam.reference.decoder_logits(w, m, [toks[0]],
                                       [torch.arange(40)])[0]
    close(got, logits[0, :, :m["vocab_size"]])


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_matches_paged_decode_step(name):
    """Prefill 10 tokens, install them in the program's paged pool in
    pages of 4 (two one-page slots taken and freed first, so the slot's
    pages come out of order), decode token 11 through its block table."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.kv_cache import PagedKVCachePool
    m, fam, w, prog, params = served_f32(name, 4)
    seq = torch.randint(0, m["vocab_size"], (11,),
                        generator=torch.Generator().manual_seed(1))
    _, cache = tr.prefill(params, seq[None, :10], prog,
                          compute_dtype=torch.float32)
    pool = PagedKVCachePool(prog, 3, 12, page_size=4, spare_pages=2,
                            dtype=torch.float32, device="cpu")
    fillers = [pool.alloc(rid) for rid in (1, 2)]
    for slot in fillers:
        pool.write_prefix(slot, cache, 4)
    for slot in fillers:
        pool.release(slot)
    slot = pool.alloc(0)
    pool.write_prefix(slot, cache, 10)
    pool.prepare_append(slot, 1)
    table = pool.page_tables[slot]
    assert len(table) == 3 and table != sorted(table), table
    logits, _ = tr.paged_decode_step(
        params, pool.cache, seq[10:11].to(torch.int32),
        pool.positions()[slot:slot + 1],
        torch.as_tensor(pool.block_tables()[slot:slot + 1]), prog,
        compute_dtype=torch.float32)
    got = fam.reference.decoder_logits(w, m, [seq], [torch.tensor([10])])[0]
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
    """Every cell's configuration at its family's toy sizes."""
    bm = tiny.make(tmp_path)
    for w in bm["workloads"]:
        cfg = json.loads((tmp_path / spec.config_entry(
            bm, w["config"])["file"]).read_text())
        toy = spec.family(cfg, tmp_path / "bench").TINY
        assert {k: cfg["model"][k] for k in toy} == toy, w["name"]
