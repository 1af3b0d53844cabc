"""Synthetic data: RAG corpora with topical structure, so retrieval quality
is measurable, and LM token streams for training.  Copies of
``repro.data.synthetic.topical_corpus`` and ``lm_batches`` (numpy only):
the port and the JAX package draw the same data from a seed."""

from __future__ import annotations

import numpy as np


def topical_corpus(n_docs: int, doc_len: int, vocab: int, n_topics: int = 8,
                   seed: int = 0):
    """Docs cluster around topic-specific token distributions; questions
    drawn from a topic retrieve same-topic docs (ground truth for recall).

    Returns (corpus (n_docs, doc_len), doc_topics (n_docs,),
    make_question(topic) -> (q_len,))."""
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


def lm_batches(vocab: int, batch: int, seq: int, steps: int, seed: int = 0):
    """Markov-ish token stream: next-token structure a tiny LM can learn.
    A copy of ``repro.data.synthetic.lm_batches``: the same seed gives the
    same int32 tokens."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, size=(vocab,))
    for _ in range(steps):
        first = rng.integers(0, vocab, size=(batch, 1))
        toks = [first[:, 0]]
        for _ in range(seq):
            nxt = trans[toks[-1]]
            nxt = np.where(rng.random(batch) < 0.1,
                           rng.integers(0, vocab, batch), nxt)
            toks.append(nxt)
        arr = np.stack(toks, 1).astype(np.int32)
        yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
