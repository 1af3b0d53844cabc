"""Request lifecycle for the RAG serving engine (a copy of
``repro.serving.request``; the port imports nothing of the JAX package).

Every assignment to ``Request.state`` is recorded in ``state_history``, so
tests (and debugging) can assert the lifecycle against
``LEGAL_TRANSITIONS`` -- the full transition graph of the serving engine:

    QUEUED -> [REWRITING] -> [RETRIEVING] -> PREFILL -> DECODE
           -> (WAIT_RETRIEVAL -> DECODE)* -> DONE
    QUEUED -> EXPIRED            (deadline passed before admission)
    PREFILL -> HANDOFF -> DECODE | EXPIRED
                                 (disaggregated cluster: prefill finished
                                  on the prefill group, awaiting a decode
                                  slot on the decode group)
    any non-terminal -> RETRYING -> QUEUED      (fault recovery: the
                                  request re-enters the pipeline after an
                                  exponential backoff; bounded by the
                                  retry budget)
    RETRYING -> EXPIRED          (deadline passed during backoff)
    any non-terminal -> FAILED   (retry budget exhausted, brownout shed,
                                  no healthy engines, or an abort when the
                                  step budget runs out)

``EXPIRED`` requests are terminal and are never decoded.  A request that
expires from ``QUEUED`` was never prefilled either; one that expires from
``HANDOFF`` (deadline passed while queued between prefill completion and
decode-slot assignment) carries its prefill-produced first token but no
decode output.  ``FAILED`` is the fault-layer terminal: serving gave up on
the request (every submitted request still reaches exactly ONE terminal
state -- DONE, EXPIRED, or FAILED -- under any fault schedule).

Terminal states are FINAL: re-assigning the state of a terminal request
raises, so a request can never be double-completed (e.g. expired in a
queue sweep and then "finished" by a stale slot).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field

import numpy as np

_ids = itertools.count()


class State(enum.Enum):
    QUEUED = "queued"
    REWRITING = "rewriting"
    RETRIEVING = "retrieving"
    PREFILL = "prefill"
    HANDOFF = "handoff"                 # prefill done, awaiting decode slot
    DECODE = "decode"
    WAIT_RETRIEVAL = "wait_retrieval"   # iterative retrieval stall (§5.3)
    RETRYING = "retrying"               # fault recovery backoff
    DONE = "done"
    EXPIRED = "expired"                 # deadline passed before decode
    FAILED = "failed"                   # fault layer gave up (terminal)


#: Legal state transitions (rewrite / retrieval stages are optional, so
#: QUEUED may jump straight to PREFILL; EOS can finish a sequence on the
#: same step an iterative retrieval was scheduled, hence
#: WAIT_RETRIEVAL -> DONE).  Every non-terminal state can enter RETRYING
#: (fault recovery) and FAILED (the fault layer giving up): a crash can
#: strike a request wherever it is.
LEGAL_TRANSITIONS: dict[State, frozenset[State]] = {
    State.QUEUED: frozenset({State.REWRITING, State.RETRIEVING,
                             State.PREFILL, State.EXPIRED,
                             State.RETRYING, State.FAILED}),
    State.REWRITING: frozenset({State.RETRIEVING, State.PREFILL,
                                State.RETRYING, State.FAILED}),
    State.RETRIEVING: frozenset({State.PREFILL, State.RETRYING,
                                 State.FAILED}),
    State.PREFILL: frozenset({State.DECODE, State.HANDOFF, State.RETRYING,
                              State.FAILED}),
    State.HANDOFF: frozenset({State.DECODE, State.EXPIRED, State.RETRYING,
                              State.FAILED}),
    State.DECODE: frozenset({State.WAIT_RETRIEVAL, State.DONE,
                             State.RETRYING, State.FAILED}),
    State.WAIT_RETRIEVAL: frozenset({State.DECODE, State.DONE,
                                     State.RETRYING, State.FAILED}),
    State.RETRYING: frozenset({State.QUEUED, State.EXPIRED, State.FAILED}),
    State.DONE: frozenset(),
    State.EXPIRED: frozenset(),
    State.FAILED: frozenset(),
}

TERMINAL_STATES = frozenset({State.DONE, State.EXPIRED, State.FAILED})


@dataclass
class Request:
    question: np.ndarray                  # (q_len,) int32 token ids
    max_new_tokens: int = 32
    rid: int = field(default_factory=lambda: next(_ids))
    state: State = State.QUEUED
    deadline: float | None = None         # absolute engine-clock seconds
    rewritten: np.ndarray | None = None
    query_variants: list | None = None    # multi-query fan-out variants
    candidate_ids: np.ndarray | None = None  # retrieval/rerank candidates
    safety_scores: list | None = None     # safety-filter doc scores
    retrieved_ids: list = field(default_factory=list)
    prompt: np.ndarray | None = None      # question + retrieved content
    output: list = field(default_factory=list)
    slot: int | None = None               # decode batch slot
    retrievals_done: int = 0
    # fault recovery
    retries: int = 0                      # recovery attempts so far
    migrations: int = 0                   # drain-induced re-prefills (resize)
    t_retry: float | None = None          # backoff expiry (engine clock)
    degraded: bool = False                # served without full retrieval
    fail_reason: str | None = None        # why FAILED, for reports
    # timestamps (engine clock, seconds)
    t_arrive: float = 0.0
    t_first_token: float | None = None
    t_decode: float | None = None         # decode-slot assignment
    t_done: float | None = None
    # telemetry: set by the server at submit; the terminal-state hook below
    # closes any still-open spans and emits the single TERMINAL event, so
    # span well-formedness rides on the exactly-one-terminal invariant.
    tracer: object = field(default=None, repr=False, compare=False)

    def __setattr__(self, name, value):
        if name == "state":
            prev = self.__dict__.get("state")
            if prev in TERMINAL_STATES and value is not prev:
                raise RuntimeError(
                    f"request {self.__dict__.get('rid')} is terminal "
                    f"({prev}); cannot transition to {value} -- every "
                    f"request reaches exactly one terminal state")
            self.__dict__.setdefault("state_history", []).append(value)
            object.__setattr__(self, name, value)
            if value in TERMINAL_STATES:
                tr = self.__dict__.get("tracer")
                if tr is not None and tr.enabled:
                    tr.terminal(self.__dict__.get("rid"), value.value)
            return
        object.__setattr__(self, name, value)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrive

    @property
    def latency(self) -> float | None:
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrive

    def reset_for_retry(self, now: float, backoff: float, *,
                        migration: bool = False) -> None:
        """Clear every per-attempt field so the retry re-runs the full
        pipeline from admission.  Greedy decode + deterministic stages
        mean the recovered request's tokens are bit-identical to an
        unfaulted run (the retry-parity guarantee); only the latency
        timestamps keep history (``t_arrive`` is the original arrival, so
        TTFT honestly includes the recovery delay).

        ``migration=True`` marks a drain-induced move (live resize): the
        request was healthy work evicted by an operator decision, so it
        is counted in ``migrations`` and does NOT consume the bounded
        fault-retry budget -- a resize must never be able to fail a
        request by exhausting its retries (the zero-drop invariant)."""
        if migration:
            self.migrations += 1
        else:
            self.retries += 1
        tr = self.tracer
        if tr is not None and tr.enabled:
            # Close the failed attempt's open spans *before* the new one
            # starts, so per-attempt span sequences are disjoint in time.
            tr.close_open(self.rid, t=now,
                          outcome="migrate" if migration else "retry")
            tr.event("MIGRATE" if migration else "RETRY", rid=self.rid,
                     t=now, attempt=self.retries + self.migrations,
                     attrs={"backoff_s": backoff, "retries": self.retries,
                            "migrations": self.migrations})
        self.t_retry = now + backoff
        self.state = State.RETRYING
        self.rewritten = None
        self.query_variants = None
        self.candidate_ids = None
        self.safety_scores = None
        self.retrieved_ids = []
        self.prompt = None
        self.output = []
        self.slot = None
        self.retrievals_done = 0
        self.t_first_token = None
        self.t_decode = None
