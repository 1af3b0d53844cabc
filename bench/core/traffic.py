"""The one traffic generator: a mix's parameters and a seed -> requests.

A mix (``bench/workloads/<traffic>.json``) gives the loop (open Poisson
arrivals at a fixed rate, or a closed loop of clients), the question and
output lengths, the documents a question retrieves and the iterative
retrieval fields.  ``trace_seed`` in the mix fixes the schedule: the
arrival times and each request's question and output lengths (a closed
loop's clients' first, residual lengths too); ``--seed`` draws the
corpus and the questions' tokens and topics.  So every seed offers the
same work, on other data.

``topical_corpus`` and ``poisson_offsets`` are copies of the program's
``repro_torch.data.synthetic.topical_corpus`` and
``repro_torch.serving.server.poisson_offsets``: the yardstick does not move
when the program does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# requests made beyond the window: arrivals keep coming while the harness
# waits for the window's last answers (at most this long past its close)
DRAIN_S = 60.0
# requests served whole before the window (prefill, decode and appends
# warmed on questions no request of the window asks)
WARMUP_REQUESTS = 2


def topical_corpus(n_docs: int, doc_len: int, vocab: int, n_topics: int = 8,
                   seed: int = 0):
    """Docs cluster around topic-specific token distributions; questions
    drawn from a topic retrieve same-topic docs.

    Returns (corpus (n_docs, doc_len), doc_topics (n_docs,),
    make_question(topic, q_len) -> (q_len,))."""
    rng = np.random.default_rng(seed)
    topic_vocab = vocab // n_topics
    doc_topics = rng.integers(0, n_topics, n_docs)

    def sample(topic, n):
        base = topic * topic_vocab
        core = rng.integers(base, base + topic_vocab, n)
        noise = rng.integers(0, vocab, n)
        return np.where(rng.random(n) < 0.85, core, noise).astype(np.int32)

    corpus = np.stack([sample(t, doc_len) for t in doc_topics])

    def make_question(topic: int, q_len: int = 8) -> np.ndarray:
        return sample(topic, q_len)

    return corpus, doc_topics, make_question


def poisson_offsets(rate_qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


def draw_lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from ``{"dist": "uniform" | "loguniform" | "fixed",
    "range": [lo, hi]}`` (bounds inclusive) or ``{"dist": "fixed",
    "value": v}``."""
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    lo, hi = (int(v) for v in dist["range"])
    if kind == "uniform":
        return rng.integers(lo, hi + 1, n)
    if kind == "loguniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), n))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def residual_lengths(dist: dict, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """What is left of the requests a client finds in flight at a random
    instant: a length drawn in proportion to itself (a longer request is
    in flight longer), then a uniform share of it still to come; at least
    2 tokens, so each has a time per output token."""
    pool = draw_lengths(dist, 64 * n, rng)
    keep = rng.random(pool.size) < pool / pool.max()
    biased = pool[keep][:n]
    if biased.size < n:
        raise ValueError("residual draw came up short; widen the pool")
    left = np.ceil(rng.random(n) * biased).astype(np.int64)
    return np.clip(left, 2, biased)


@dataclass
class Traffic:
    corpus: np.ndarray          # (n_docs, doc_len) int32
    questions: list             # the requests' questions, in order of use
    out_lens: np.ndarray        # their output lengths, in the same order
    offsets: np.ndarray | None  # open loop: arrival offsets (s)
    first_out_lens: np.ndarray | None  # closed loop: each client's first
    warmup: list                # questions served before the window


def make_traffic(mix: dict, corpus_spec: dict, vocab: int, seed: int,
                 seconds: float) -> Traffic:
    """The requests of one run: ``mix`` is the traffic file,
    ``corpus_spec`` the configuration's ``corpus`` group."""
    fixed = np.random.default_rng(int(mix["trace_seed"]))
    run = np.random.default_rng(seed)
    corpus, _topics, make_question = topical_corpus(
        int(corpus_spec["n_docs"]), int(corpus_spec["doc_len"]), vocab,
        int(corpus_spec["n_topics"]), seed=seed)
    offsets = first = None
    if mix["loop"] == "open":
        rate = float(mix["rate_qps"])
        horizon = float(mix["lead_in_s"]) + seconds + DRAIN_S
        n_max = int(rate * horizon * 1.5) + 64
        offsets = poisson_offsets(rate, n_max, seed=int(mix["trace_seed"]))
        offsets = offsets[offsets < horizon]
        n = offsets.size
    elif mix["loop"] == "closed":
        clients = int(mix["clients"])
        n = clients * int(mix["requests_per_client"])
        first = residual_lengths(mix["output_tokens"], clients, fixed)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    q_lens = draw_lengths(mix["question_tokens"], n, fixed)
    out_lens = draw_lengths(mix["output_tokens"], n, fixed)
    topics = run.integers(0, int(corpus_spec["n_topics"]), n)
    questions = [make_question(int(t), int(q))
                 for t, q in zip(topics, q_lens)]
    warmup = [make_question(int(t), int(q)) for t, q in zip(
        run.integers(0, int(corpus_spec["n_topics"]), WARMUP_REQUESTS),
        q_lens[:WARMUP_REQUESTS])]
    return Traffic(corpus, questions, out_lens, offsets, first, warmup)
