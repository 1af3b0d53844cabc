"""The traffic: the same seed gives the same requests; another seed other
data (corpus, question tokens), but the same schedule: arrivals and each
request's lengths."""

import numpy as np
import pytest

from bench.core import spec
from bench.core import traffic as TR

BM = spec.load_benchmark()
CELLS = [w["name"] for w in BM["workloads"]]


def make(cell, seed, seconds=30.0):
    wl = spec.workload(BM, cell)
    cfg = spec.load_config(BM, wl["config"])
    corpus = dict(cfg["corpus"], n_docs=64)   # the generator, not its size
    return TR.make_traffic(spec.load_traffic(wl["traffic"]), corpus,
                           cfg["model"]["vocab_size"], seed, seconds)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_traffic(cell):
    a, b = make(cell, 2 ** 31 + 12345), make(cell, 2 ** 31 + 12345)
    assert np.array_equal(a.corpus, b.corpus)
    assert all(np.array_equal(x, y) for x, y in zip(a.questions,
                                                     b.questions))
    assert np.array_equal(a.out_lens, b.out_lens)
    for x, y in ((a.offsets, b.offsets),
                 (a.first_out_lens, b.first_out_lens)):
        assert (x is None and y is None) or np.array_equal(x, y)


@pytest.mark.parametrize("cell", CELLS)
def test_other_seed_same_work_other_data(cell):
    a, b = make(cell, 7), make(cell, 8)
    assert not np.array_equal(a.corpus, b.corpus)
    assert [len(q) for q in a.questions] == [len(q) for q in b.questions]
    assert not all(np.array_equal(x, y) for x, y in zip(a.questions,
                                                         b.questions))
    assert np.array_equal(a.out_lens, b.out_lens)
    if a.offsets is not None:
        assert np.array_equal(a.offsets, b.offsets)
    else:
        assert np.array_equal(a.first_out_lens, b.first_out_lens)


@pytest.mark.parametrize("cell", CELLS)
def test_lengths_within_the_mix(cell):
    mix = spec.load_traffic(spec.workload(BM, cell)["traffic"])
    t = make(cell, 3)
    q_lo, q_hi = mix["question_tokens"]["range"]
    assert all(q_lo <= len(q) <= q_hi for q in t.questions)
    out = mix["output_tokens"]
    lo, hi = out.get("range", [out.get("value")] * 2)
    assert lo <= t.out_lens.min() and t.out_lens.max() <= hi
    if t.first_out_lens is not None:
        assert t.first_out_lens.min() >= 2 and t.first_out_lens.max() <= hi
    vocab = spec.load_config(BM, spec.workload(BM, cell)["config"])[
        "model"]["vocab_size"]
    assert t.corpus.max() < vocab


def test_open_arrivals_are_poisson_at_the_rate():
    mix = {"loop": "open", "rate_qps": 10.0, "lead_in_s": 0.0,
           "question_tokens": {"dist": "uniform", "range": [4, 8]},
           "output_tokens": {"dist": "uniform", "range": [4, 8]},
           "trace_seed": 0}
    t = TR.make_traffic(mix, {"n_docs": 8, "doc_len": 4, "n_topics": 2},
                        64, 0, 1000.0)
    in_window = np.sum(t.offsets < 1000.0)
    assert abs(in_window - 10_000) < 400          # 4 standard deviations
    gaps = np.diff(t.offsets)
    assert abs(gaps.mean() - 0.1) < 0.005
