"""What a served request feeds its model, worked out from its inputs.

The serving contract of a RAG request (paper Fig. 3, as the engine's
configuration states it): the prompt is the retrieved documents in rank
order followed by the question, keeping its last ``s_max -
max_new_tokens - 1`` tokens; each answer token is fed back in turn; with
iterative retrieval, every ``interval`` answer tokens (while more are due)
the top document of a retrieval on the last ``iter_query_tokens`` answer
tokens is appended to the context before the latest token is fed, cut to
the room the cache has left for the answer's remaining tokens.
"""

from __future__ import annotations

import numpy as np


def prompt_budget(serving: dict) -> int:
    return serving["s_max"] - serving["max_new_tokens"] - 1


def prompt_tokens(corpus, ids, question, budget: int) -> np.ndarray:
    docs = corpus[np.asarray(ids, np.int64)].reshape(-1)
    return np.concatenate([docs, question])[-budget:]


def append_len(s_max: int, cache_len: int, remaining: int,
               doc_len: int) -> int:
    """Tokens of a retrieved document appended to a cache of
    ``cache_len`` positions that must keep ``remaining`` for the answer."""
    return max(0, min(doc_len, s_max - cache_len - remaining))


def retrieval_points(n_out: int, n_want: int, interval) -> list[int]:
    """The answer lengths at which an iterative retrieval was due."""
    if not interval:
        return []
    return [i for i in range(interval, min(n_out, n_want - 1) + 1, interval)]


def iter_query(out, n: int, width: int) -> np.ndarray:
    """The query of the retrieval at answer length ``n``: its last
    ``width`` answer tokens."""
    return np.asarray(out[n - width:n], np.int32)


def fed_sequence(prompt, out, appended, interval, corpus, n_want: int,
                 s_max: int):
    """(tokens, positions): the sequence the model saw, and the position
    whose logits chose each served token.  ``appended[j]`` is the document
    id of the j-th iterative retrieval (``None`` where it found none)."""
    seq = [int(t) for t in prompt]
    want = [len(seq) - 1]
    points = retrieval_points(len(out), n_want, interval)
    doc_len = corpus.shape[1]
    for i in range(1, len(out)):
        if i in points:
            doc = appended[points.index(i)]
            if doc is not None:
                n = append_len(s_max, len(seq), n_want - i, doc_len)
                seq.extend(int(t) for t in corpus[doc][:n])
        seq.append(int(out[i - 1]))
        want.append(len(seq) - 1)
    return np.asarray(seq, np.int64), np.asarray(want, np.int64)
