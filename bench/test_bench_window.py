"""The window arithmetic on hand-made request timestamps."""

import pytest

from bench.core import window as W


def stamp(due, first, done, n_out, n_want=None, ok=True):
    return W.Stamp(due, first, done, n_out, n_want or n_out, ok)


def test_quantile_interpolates_like_numpy():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert W.quantile(xs, 0.0) == 1.0
    assert W.quantile(xs, 1.0) == 5.0
    assert W.quantile(xs, 0.5) == 3.0
    # position 0.95 * 4 = 3.8 between 4 and 5
    assert W.quantile(xs, 0.95) == pytest.approx(4.8)
    assert W.quantile([], 0.95) is None


def test_p95_over_every_request_not_chunk_medians():
    # 19 fast requests and one slow: the p95 sits between them
    stamps = [stamp(float(i), i + 0.1, i + 1.0, 10) for i in range(19)]
    stamps.append(stamp(19.0, 29.0, 30.0, 10))
    ttfts = [W.ttft(s) for s in stamps]
    assert W.p95(ttfts) == pytest.approx(0.1 + 0.05 * (10.0 - 0.1))


def test_ttft_from_due_time_and_tpot_per_request():
    s = stamp(due=10.0, first=10.5, done=12.5, n_out=5)
    assert W.ttft(s) == pytest.approx(0.5)
    assert W.tpot(s) == pytest.approx(0.5)       # 2 s over 4 gaps
    assert W.tpot(stamp(0.0, 1.0, 1.0, 1)) is None  # one token: no gap
    assert W.tpot(stamp(0.0, 1.0, 2.0, 3, ok=False)) is None
    assert W.ttft(stamp(0.0, None, None, 0, 4, ok=False)) is None


def test_rate_counts_answers_done_in_window_over_the_whole_window():
    stamps = [stamp(0.0, 0.5, t, 4) for t in (0.9, 1.0, 2.0, 5.99, 6.0)]
    stamps.append(stamp(0.0, 0.5, 3.0, 2, 4, ok=False))   # not whole
    # [1, 6): 1.0, 2.0, 5.99 -> 3 answers over 5 s
    assert W.rate(stamps, 1.0, 6.0) == pytest.approx(0.6)
    assert len(W.done_in(stamps, 1.0, 6.0)) == 3
