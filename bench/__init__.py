"""Benchmark of the PyTorch/CUDA serving port (``repro_torch``) on one H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Everything that measures or judges
the program lives here and imports nothing of the JAX package: traffic
generation (``core/traffic.py``), the window arithmetic
(``core/window.py``), operation and byte counts with the chip's peaks
(``core/counts.py``), the device-trace reduction (``core/trace.py``) and
the plain float32 reference that decides ``correct`` (``reference/``).
"""
