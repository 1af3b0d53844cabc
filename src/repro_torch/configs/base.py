"""Arch/shape registry of the port (copy of ``repro.configs.base``; the
port imports nothing of ``repro``).

Each architecture of the reference -- five LMs, PNA and four recsys
models -- lives in its own ``repro_torch/configs/<id>.py`` exposing an
``ARCH`` (ArchSpec) built on the port's model config;
``get_arch(arch_id)`` resolves by id and ``all_cells()`` enumerates
(arch, shape).

Shapes carry a ``step`` kind: ``train`` -> train_step,
``prefill``/``decode`` -> serving programs, ``forward`` -> inference
forward, ``score`` -> candidate-scoring (recsys retrieval).  ``skip``
marks cells excluded from the official baseline table (long_500k on pure
full-attention LMs) with the reason recorded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str                      # train | prefill | decode | forward | score
    dims: dict[str, int]
    skip: str | None = None        # reason, if excluded from official table
    variant: dict[str, Any] = field(default_factory=dict)  # config overrides


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    config: Any                    # model config dataclass
    shapes: tuple[ShapeSpec, ...]
    reduced: Callable[[], Any]     # tiny same-family config for smoke tests
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")


# ---------------------------------------------------------------------------
# Shared LM shape template (brief: seq_len x global_batch)
# ---------------------------------------------------------------------------

def lm_shapes(*, full_attention: bool) -> tuple[ShapeSpec, ...]:
    skip = ("pure full-attention arch: 524k decode requires sub-quadratic "
            "attention (DESIGN.md long_500k note); optional sliding-window "
            "variant reported separately" if full_attention else None)
    return (
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill",
                  {"seq_len": 32768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode",
                  {"seq_len": 32768, "global_batch": 128}),
        ShapeSpec("long_500k", "decode",
                  {"seq_len": 524288, "global_batch": 1},
                  skip=skip,
                  variant={"attention": "sliding_window", "window": 4096}),
    )


_REGISTRY: dict[str, str] = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "pna": "repro_torch.configs.pna",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "mind": "repro_torch.configs.mind",
}

ARCH_IDS = tuple(_REGISTRY)


def get_arch(arch_id: str) -> ArchSpec:
    import importlib
    mod = importlib.import_module(_REGISTRY[arch_id])
    return mod.ARCH


def all_cells(include_skipped: bool = False):
    """Yield (ArchSpec, ShapeSpec) for the dry-run table."""
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        for shape in arch.shapes:
            if shape.skip and not include_skipped:
                continue
            yield arch, shape
