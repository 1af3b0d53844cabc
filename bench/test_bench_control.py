"""The control at a size the CPU holds: the program's int8-weight path, the
precision below the configuration's bf16, read as the judge reads a
served model's control -- at each position of the same token sequences,
the gap under the float32 reference of the token the lower precision
puts first -- comes out far above the bf16 program's own reading, on
either side of a limit.  On the card the control serves each cell whole
(``bench/control.py``; readings in ``PERF.md`` §2)."""

import json

import pytest
import torch

from bench import tiny
from bench.core import spec
from bench.core.judge import token_gaps

CONFIGS = sorted(p.stem for p in (spec.BENCH_DIR / "configs").glob("*.json"))
# the toy's own limit on logit_gap_mean, from its CPU readings at one
# thread (8 x 96 positions, seeds 1-3, both configurations): bf16
# 0.000144-0.000357, int8 0.0012-0.002472
TOY_LIMIT = 0.0008


def readings(name: str, seed: int) -> dict:
    """Through the configuration's family: its weights, its program and
    int8 control (``program_component``), its reference."""
    from repro_torch.models import transformer as tr
    path = spec.BENCH_DIR / "configs" / f"{name}.json"
    cfg = tiny.tiny_config(json.loads(path.read_text()))
    fam = spec.family(cfg)
    m = cfg["model"]
    w = fam.draw_weights(m, fam.program_config(m, name), seed, "cpu")
    toks = torch.randint(0, m["vocab_size"], (8, 96),
                         generator=torch.Generator().manual_seed(seed))
    out = {}
    with torch.no_grad():
        ref_logits = torch.stack(fam.reference.decoder_logits(
            w, m, list(toks), [torch.arange(96)] * 8))
        for label, control in (("bf16", False), ("int8", True)):
            prog, params = fam.program_component(m, w, name, control)
            logits, _ = tr.forward(params, toks, prog)
            first = logits[..., :m["vocab_size"]].float().argmax(-1)
            out[label] = float(token_gaps(ref_logits, first).mean())
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CONFIGS)
def test_control_reads_far_above_the_program(name, seed):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = readings(name, seed)
    finally:
        torch.set_num_threads(threads)
    assert r["bf16"] <= TOY_LIMIT < r["int8"], r
    assert r["int8"] >= 3 * r["bf16"], r
