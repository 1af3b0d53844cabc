"""The harness's judge, driven through whole runs of the toy copy on the
CPU (the look for a chip skipped), sees ``correct`` come out false for
each fault a serving cell can have, planted in the program: a decode
step that leaves its state unchanged, half of the batch left out (its
logits the mean of the rest's), a token altered where it is produced,
retrieval answering other documents.  Every cell of ``BENCHMARK.json``,
whatever its model family; the sound run of each is correct."""

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.cell import run_cell


def state_unchanged(monkeypatch, engine):
    """The step's logits come back, its writes to the pool are undone:
    through the engine's step, whatever model family it serves."""
    logits_of = engine.decode_logits

    def unchanged(token_vec, step_mask):
        before = {k: v.clone() for k, v in engine.pool.cache.items()}
        logits = logits_of(token_vec, step_mask)
        for k, v in engine.pool.cache.items():
            v.copy_(before[k])
        return logits

    monkeypatch.setattr(engine, "decode_logits", unchanged)


def half_batch_left_out(monkeypatch, engine):
    logits_of = engine.decode_logits

    def half(token_vec, step_mask):
        logits = logits_of(token_vec, step_mask).clone()
        b = logits.shape[0] // 2
        logits[b:] = logits[:b].float().mean(0).to(logits.dtype)
        return logits

    monkeypatch.setattr(engine, "decode_logits", half)


def token_altered(monkeypatch, engine):
    logits_of = engine.decode_logits

    def altered(token_vec, step_mask):
        logits = logits_of(token_vec, step_mask).clone()
        logits[:, 3] = torch.finfo(logits.dtype).max
        return logits

    monkeypatch.setattr(engine, "decode_logits", altered)


def answer_altered(monkeypatch, engine):
    backend = engine.backend
    search = backend.search
    n = engine.corpus.shape[0]

    def other(queries, k):
        scores, ids = search(queries, k)
        return scores, (ids + 1) % n

    monkeypatch.setattr(backend, "search", other)


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch_left_out": half_batch_left_out,
          "token_altered": token_altered,
          "answer_altered": answer_altered}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy benchmark, run with one thread: the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("toy")
    yield tiny.make(root), root
    torch.set_num_threads(threads)


def run(toy, cell, plant=None, seed=21):
    bm, root = toy
    result, _ = run_cell(bm, cell, seed, 2.0, False, device="cpu",
                         root=root, bench_dir=root / "bench", plant=plant)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(toy, cell):
    result = run(toy, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(toy, cell, fault, monkeypatch):
    result = run(toy, cell,
                 plant=lambda engine: FAULTS[fault](monkeypatch, engine))
    assert not result["correct"], result["checks"]
