"""Arrival-trace files for open-loop replay (RAGPulse-style).

Format: JSON Lines, one request per line::

    {"arrival_s": 0.12, "question": [17, 3, ...],
     "max_new_tokens": 8, "deadline_s": 2.0}

``arrival_s`` is the offset (seconds) from replay start; ``question`` is
the int token-id sequence; ``max_new_tokens`` and ``deadline_s`` (relative
seconds from the request's arrival) are optional and fall back to the
replay call's defaults.  Entries must be sorted by ``arrival_s``.

``RAGServer.replay_trace(path_or_entries)`` replays a trace against the
wall clock on either topology (single engine or disaggregated cluster);
:func:`bursty_trace` synthesizes the on/off burst traffic real RAG serving
sees (RAGPulse observes arrival processes far burstier than Poisson --
only tail latency measured under such a trace validates a plan), and
:func:`synthesize_trace` generates the full RAGPulse workload shape:
diurnal rate curve x bursts, heavy-tailed lognormal prompt/output
lengths, and mixed pipeline presets tagged per entry (``preset``) -- the
traffic the live control plane's drift detector watches for regime
changes.

Copied from ``src/repro/serving/trace.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class TraceEntry:
    arrival_s: float
    question: np.ndarray                 # (q_len,) int32 token ids
    max_new_tokens: int | None = None
    deadline_s: float | None = None      # relative to this entry's arrival
    preset: str | None = None            # pipeline preset this request ran
    #                                      (mixed-workload traces tag each
    #                                      request with its RAG pipeline)

    def to_json(self) -> str:
        rec = {"arrival_s": round(float(self.arrival_s), 6),
               "question": [int(t) for t in self.question]}
        if self.max_new_tokens is not None:
            rec["max_new_tokens"] = int(self.max_new_tokens)
        if self.deadline_s is not None:
            rec["deadline_s"] = float(self.deadline_s)
        if self.preset is not None:
            rec["preset"] = str(self.preset)
        return json.dumps(rec)


def load_trace(path) -> list[TraceEntry]:
    """Parse a JSONL arrival trace; validates ordering and field types."""
    entries: list[TraceEntry] = []
    for ln, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        try:
            entry = TraceEntry(
                arrival_s=float(rec["arrival_s"]),
                question=np.asarray(rec["question"], np.int32),
                max_new_tokens=(int(rec["max_new_tokens"])
                                if "max_new_tokens" in rec else None),
                deadline_s=(float(rec["deadline_s"])
                            if "deadline_s" in rec else None),
                preset=(str(rec["preset"])
                        if "preset" in rec else None))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}:{ln}: bad trace entry: {e}") from e
        if entry.question.ndim != 1 or entry.question.size == 0:
            raise ValueError(f"{path}:{ln}: question must be a non-empty "
                             f"1-D token list")
        if entries and entry.arrival_s < entries[-1].arrival_s:
            raise ValueError(f"{path}:{ln}: arrivals must be sorted")
        entries.append(entry)
    return entries


def save_trace(path, entries) -> None:
    Path(path).write_text(
        "".join(e.to_json() + "\n" for e in entries))


def synthesize_trace(n: int, vocab: int, *,
                     mean_rate: float = 8.0,
                     diurnal_amplitude: float = 0.6,
                     period_s: float = 60.0,
                     burst_boost: float = 4.0,
                     burst_prob: float = 0.15,
                     burst_len: int = 5,
                     q_len_median: float = 8.0, q_len_sigma: float = 0.6,
                     q_len_max: int = 64,
                     out_median: float = 8.0, out_sigma: float = 0.6,
                     out_max: int = 64,
                     presets: tuple = ("hyde",),
                     preset_weights=None,
                     deadline_s: float | None = None,
                     make_question=None,
                     t0: float = 0.0,
                     seed: int = 0) -> list[TraceEntry]:
    """Synthesize a RAGPulse-shaped workload trace: every axis real RAG
    traffic varies on, in one seeded generator.

    * **Diurnal rate curve**: arrivals follow an inhomogeneous Poisson
      process whose rate swings sinusoidally around ``mean_rate`` with
      relative ``diurnal_amplitude`` over ``period_s`` (a compressed
      day), so a replay sees genuine load *regimes*, not one level.
    * **Bursty arrivals**: on top of the slow curve, arrival ``i`` opens
      a burst with probability ``burst_prob``; the next ``burst_len``
      arrivals come at ``burst_boost`` x the instantaneous rate
      (overdispersed, far burstier than Poisson at the same mean).
    * **Heavy-tailed lengths**: prompt and output lengths are lognormal
      (median/sigma knobs, clamped to ``[1, *_max]``) -- most requests
      short, a fat tail of long ones, the shape that stresses batching.
    * **Mixed pipelines**: each entry is tagged with a pipeline
      ``preset`` drawn from ``presets`` with ``preset_weights``, so one
      trace carries heterogeneous RAG configurations side by side.

    ``make_question(rng, q_len) -> np.ndarray`` overrides the default
    uniform-random token questions (e.g. ``topical_corpus``'s query
    maker).  ``t0`` offsets every arrival -- concatenate phase traces
    (``phase_b = synthesize_trace(..., t0=phase_a[-1].arrival_s)``) to
    script a regime change mid-replay.  Deterministic for a given seed.
    """
    if n <= 0:
        return []
    if preset_weights is None:
        preset_weights = [1.0] * len(presets)
    if len(preset_weights) != len(presets):
        raise ValueError("preset_weights must match presets")
    w = np.asarray(preset_weights, float)
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    entries: list[TraceEntry] = []
    t = 0.0
    burst_left = 0
    for _ in range(n):
        diurnal = 1.0 + diurnal_amplitude * np.sin(
            2.0 * np.pi * t / period_s)
        rate = mean_rate * max(diurnal, 0.05)
        if burst_left > 0:
            rate *= burst_boost
            burst_left -= 1
        elif rng.random() < burst_prob:
            burst_left = burst_len
        t += float(rng.exponential(1.0 / rate))
        q_len = int(np.clip(round(rng.lognormal(np.log(q_len_median),
                                                q_len_sigma)),
                            1, q_len_max))
        out = int(np.clip(round(rng.lognormal(np.log(out_median),
                                              out_sigma)),
                          1, out_max))
        question = (make_question(rng, q_len) if make_question is not None
                    else rng.integers(0, vocab, q_len).astype(np.int32))
        entries.append(TraceEntry(
            arrival_s=t0 + t,
            question=np.asarray(question, np.int32),
            max_new_tokens=out,
            deadline_s=deadline_s,
            preset=str(presets[int(rng.choice(len(presets), p=w))])))
    return entries


def bursty_trace(n: int, vocab: int, *, q_len: int = 8,
                 burst_rate: float = 20.0, idle_rate: float = 1.0,
                 burst_len: int = 6, max_new_tokens: int | None = None,
                 deadline_s: float | None = None,
                 seed: int = 0) -> list[TraceEntry]:
    """Synthesize an on/off bursty arrival trace: alternating bursts of
    ``burst_len`` back-to-back arrivals at ``burst_rate`` QPS and quiet
    gaps at ``idle_rate`` QPS -- the overdispersed traffic shape (far
    burstier than Poisson at the same mean) that stresses admission and
    decode-slot scheduling."""
    rng = np.random.default_rng(seed)
    entries, t = [], 0.0
    for i in range(n):
        in_burst = (i // burst_len) % 2 == 0
        rate = burst_rate if in_burst else idle_rate
        t += float(rng.exponential(1.0 / rate))
        entries.append(TraceEntry(
            arrival_s=t,
            question=rng.integers(0, vocab, q_len).astype(np.int32),
            max_new_tokens=max_new_tokens,
            deadline_s=deadline_s))
    return entries
