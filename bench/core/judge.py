"""Decide ``correct``: the served outputs against the plain reference.

Run once the window has closed, the peak memory has been read and the
program's state is freed.  Three numbers, each held to a limit of the
cell's traffic file (``judge.limits``):

* ``retrieval_gap``: over every retrieval of the judged requests (the
  admission's k documents and each iterative retrieval's one), how far
  below the reference's k-th best cosine score the worst document the
  program retrieved lies; 0 when it retrieved the reference's top k;
* ``logit_gap_mean``: over every served token of a sample of the judged
  requests drawn from the seed, the longest among them, the mean of how
  far the token's logit lies below the reference's best at the position
  that chose it (prefill, decode through the paged cache and, with
  iterative retrieval, the appended context);
* ``unanswered``: requests that never came back whole (limit 0).

Beside them it reads the widest of those gaps (``logit_gap``) and the
share of sampled tokens that were not the reference's best, which no
limit holds: the widest gap is the tail of a few near-tie flips, and
separates the bf16 program from its int8 control by less than 3x, where
the mean, which weighs how often and how far tokens flip, separates them
by 4x or more (``PERF.md`` §2).

The reference recomputes the database embeddings, the queries and the
whole fed sequence from the benchmark's own inputs (weights, corpus,
questions) and reads the program's outputs (documents and tokens) only
to judge them.  The encoder's reference is ``reference/lm.py``; the
served model's is its family's (``bench/blocks/<block>.py`` names it).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from bench.core import prompt as P
from bench.reference import knn
from bench.reference import lm as ref


@dataclass
class Served:
    """One judged request: what it was asked and what it answered."""
    question: np.ndarray
    n_want: int
    out: list
    retrieved: list          # retrieved_ids: admission's, then iterative


def pick_sample(served: list[Served], n: int, seed: int) -> list[int]:
    """``n`` indices drawn from the seed, the longest answer among them."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i].out))
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[int(j)] for j in pick)


def token_gaps(ref_logits, tokens):
    """How far each token's reference logit lies below the reference's
    best at its position: (n, V) logits, (n,) tokens -> (n,)."""
    chosen = ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
    return ref_logits.max(dim=-1).values - chosen


def _encode_queries(enc_w, enc_m, queries, device):
    """Reference embeddings of token rows of any lengths, grouped by
    length."""
    by_len = defaultdict(list)
    for i, q in enumerate(queries):
        by_len[len(q)].append(i)
    out = [None] * len(queries)
    for idx in by_len.values():
        toks = torch.as_tensor(np.stack([queries[i] for i in idx]),
                               dtype=torch.long, device=device)
        for i, v in zip(idx, ref.encode(enc_w, enc_m, toks)):
            out[i] = v
    return torch.stack(out) if out else None


def judge(cfg: dict, mix: dict, gen_w: dict, enc_w: dict, corpus,
          served: list[Served], seed: int, device, model_ref) -> dict:
    """The numbers compared, with how much each covered.  ``model_ref``
    is the served model's reference module (its ``decoder_logits``)."""
    serving, k = cfg["serving"], int(mix["k"])
    interval = mix.get("iterative_interval")
    width = int(cfg["serving"]["iter_query_tokens"])
    budget = P.prompt_budget(serving)
    corpus_t = torch.as_tensor(corpus, dtype=torch.long, device=device)
    # retrieval: every judged request's admission and iterative queries
    queries, got, ks = [], [], []
    for s in served:
        queries.append(np.asarray(s.question, np.int32))
        got.append(s.retrieved[0] if s.retrieved else [])
        ks.append(k)
        for j, n in enumerate(P.retrieval_points(len(s.out), s.n_want,
                                                 interval)):
            if j + 1 < len(s.retrieved):
                queries.append(P.iter_query(s.out, n, width))
                got.append(s.retrieved[j + 1])
                ks.append(1)
    gaps = {"retrieval_gap": 0.0, "logit_gap": 0.0}
    with ref.fp32_exact(), torch.no_grad():
        if queries:
            db = ref.encode(enc_w, cfg["encoder"], corpus_t)
            qv = _encode_queries(enc_w, cfg["encoder"], queries, device)
            scores = knn.cosine_scores(qv, db)
            del db
            for row, ids, kk in zip(scores, got, ks):
                gaps["retrieval_gap"] = max(
                    gaps["retrieval_gap"], knn.retrieval_gap(row, ids, kk))
            del scores
        # generation: a sample of whole answers, teacher-forced
        sample = [served[i] for i in pick_sample(
            served, int(mix["judge"]["sample_requests"]), seed)]
        seqs, wants = [], []
        for s in sample:
            prompt = P.prompt_tokens(corpus, s.retrieved[0], s.question,
                                     budget)
            appended = [r[0] if r else None for r in s.retrieved[1:]]
            seq, want = P.fed_sequence(prompt, s.out, appended, interval,
                                       corpus, s.n_want, serving["s_max"])
            seqs.append(torch.as_tensor(seq, device=device))
            wants.append(torch.as_tensor(want, device=device))
        n_tokens, gap_sum, missed = 0, 0.0, 0
        logits_all = (model_ref.decoder_logits(gen_w, cfg["model"], seqs,
                                               wants) if sample else [])
        for s, logits in zip(sample, logits_all):
            gap = token_gaps(logits, torch.as_tensor(s.out, device=device))
            gaps["logit_gap"] = max(gaps["logit_gap"], float(gap.max()))
            gap_sum += float(gap.sum())
            missed += int((gap > 0).sum())
            n_tokens += len(s.out)
    return {**gaps, "logit_gap_mean": gap_sum / max(1, n_tokens),
            "argmax_missed": missed / max(1, n_tokens),
            "retrievals_judged": len(queries), "tokens_judged": n_tokens,
            "requests_sampled": len(sample)}
