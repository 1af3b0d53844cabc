"""Synthetic RAG corpora with topical structure, so retrieval quality is
measurable.  A copy of ``repro.data.synthetic.topical_corpus`` (numpy
only): the port and the JAX package draw the same corpus from a seed."""

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
