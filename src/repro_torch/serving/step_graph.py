"""A decode step captured once in a CUDA graph and replayed.

The JAX engine jit-compiles its decode step, so a tick costs the host one
dispatch.  PyTorch enqueues the step's ops one by one: ~80 a layer, which
leaves the device idle while the host launches them.  :class:`StepGraph`
records the step's kernels once (``torch.cuda.graph``) and replays them
with one launch.  The replay reads the step's inputs from the tensors the
capture saw and writes its output into the tensor the capture returned,
so the caller copies each tick's inputs into the same tensors and reads
the output before the next replay.

A replay runs no Python, so the kernel wrappers' ``launches`` counters
(``repro_torch.kernels.launch_counters``) would stop at the capture.  The
capture's own calls launched nothing and are taken back off the counters;
each replay adds them again, so the counters keep counting launches.
"""

from __future__ import annotations

from repro_torch.kernels import launch_counters


def capture(step):
    """``step()`` run once on a side stream, as ``torch.cuda.graph``'s
    recipe asks (cuBLAS and the kernels' modules load before the
    capture), then captured: (graph, the eager run's output, the captured
    run's output, ``[(wrapper, its calls in the capture)]``).  The
    capture takes its calls back off the counters."""
    import torch
    counters = list(launch_counters().values())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = step()
    torch.cuda.current_stream().wait_stream(side)
    eager.record_stream(torch.cuda.current_stream())
    before = [fn.launches for fn in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    calls = [(fn, fn.launches - n) for fn, n in zip(counters, before)
             if fn.launches != n]
    for fn, n in calls:
        fn.launches -= n
    return graph, eager, out, calls


class StepGraph:
    """``step() -> tensor`` captured on the tensors it reads: ``eager``
    is the output of the eager run made before the capture, ``out`` the
    tensor every :meth:`replay` writes.  ``key`` names the storage the
    capture bound (the caller compares it before each replay)."""

    def __init__(self, step, key):
        self.key = key
        self.graph, self.eager, self.out, self.launches = capture(step)

    def replay(self) -> None:
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
