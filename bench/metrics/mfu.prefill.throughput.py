"""Model: ``mfu.prefill`` (the window's prefill FLOPs over the engine's
``prefill`` stage seconds and the bf16 peak, %) in a cell whose
end-to-end metric is ``answers_per_s``; the same reading."""

from pathlib import Path

from bench.core import spec

read = spec.metric_reader("mfu.prefill", Path(__file__).resolve().parents[1])
