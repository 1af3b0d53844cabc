"""Synthetic data: RAG corpora with topical structure, so retrieval quality
is measurable, LM token streams for training, a GraphSAGE-style neighbour
sampler and recsys batches.  Copies of ``repro.data.synthetic``'s
generators (numpy only): the port and the JAX package draw the same data
from a seed, with the same rng calls in the same order."""

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


def graph_neighbor_sampler(edges: np.ndarray, n_nodes: int,
                           fanout: tuple[int, ...], batch_nodes: int,
                           seed: int = 0):
    """GraphSAGE-style layered neighbor sampler over a CSR adjacency.

    Yields subgraph dicts: ``nodes`` (the sorted unique global ids of the
    targets and every sampled hop), ``edges`` (2, E) int32 relabelled
    into ``nodes`` (src = sampled neighbour, dst = the node it was sampled
    for), ``targets`` int32 relabelled.  A copy of the reference's sampler,
    equal for the same seed; the CSR ``indptr`` comes from ``np.bincount``
    and the relabelling from ``np.searchsorted`` (the same arrays as the
    reference's ``np.add.at`` and dict, much faster at Reddit's 114.6 M
    edges)."""
    rng = np.random.default_rng(seed)
    # CSR build (dst-major: in-neighbors of each node)
    order = np.argsort(edges[1], kind="stable")
    src_sorted = edges[0][order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(edges[1], minlength=n_nodes))

    def neighbors(v, k):
        lo, hi = indptr[v], indptr[v + 1]
        if hi == lo:
            return np.empty(0, np.int64)
        idx = rng.integers(lo, hi, size=k)
        return src_sorted[idx]

    while True:
        targets = rng.choice(n_nodes, batch_nodes, replace=False)
        layers = [targets]
        sub_edges = []
        frontier = targets
        for f in fanout:
            nbrs, e_src, e_dst = [], [], []
            for v in frontier:
                ns = neighbors(v, f)
                nbrs.append(ns)
                e_src.append(ns)
                e_dst.append(np.full(len(ns), v))
            frontier = np.concatenate(nbrs) if nbrs else np.empty(0, np.int64)
            layers.append(frontier)
            sub_edges.append((np.concatenate(e_src), np.concatenate(e_dst)))
        # relabel: every id is in the sorted unique ``all_nodes``
        all_nodes = np.unique(np.concatenate(layers))
        es = np.concatenate([s for s, _ in sub_edges])
        ed = np.concatenate([d for _, d in sub_edges])
        es = np.searchsorted(all_nodes, es).astype(np.int32)
        ed = np.searchsorted(all_nodes, ed).astype(np.int32)
        yield {"nodes": all_nodes.astype(np.int64),
               "edges": np.stack([es, ed]),
               "targets": np.searchsorted(all_nodes, targets).astype(
                   np.int32)}


def recsys_batches(n_fields: int, vocab: int, batch: int, steps: int,
                   n_dense: int = 0, seed: int = 0):
    """``steps`` batches of ``sparse`` (batch, n_fields) int32 ids in
    [0, vocab), ``labels`` (batch,) float32 positives at rate 0.3 and,
    with ``n_dense``, ``dense`` (batch, n_dense) float32 normals."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        out = {"sparse": rng.integers(0, vocab,
                                      (batch, n_fields)).astype(np.int32),
               "labels": (rng.random(batch) < 0.3).astype(np.float32)}
        if n_dense:
            out["dense"] = rng.normal(size=(batch, n_dense)).astype(
                np.float32)
        yield out
