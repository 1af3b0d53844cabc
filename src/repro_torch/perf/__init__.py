"""Perf-iteration cell variants (counterpart of ``repro.perf``)."""
