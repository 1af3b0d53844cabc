"""A slice of the window traced on the device, reduced to numbers.

``torch.profiler`` records the device's activity (kernels, copies, sets)
between ``start`` and ``stop``; the profile stays in memory and is
reduced at once: the union of the activity intervals (busy time), device
time by kernel name, and the idle gaps, each named by the engine stage
that was open on the host at the time (the program's ``SpanTracer``
spans).  The device clock is tied to the host's by a marker op launched
right after ``start`` on an idle device: the first activity of the trace.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# span kinds of the engine's stages (``repro_torch.serving.telemetry``);
# request residency spans ("DECODE") and instant events name no gap
STAGE_KINDS = ("EMBED", "RETRIEVE", "PREFILL", "DECODE_TICK")
NO_STAGE = "server loop (no stage open)"


def _is_stage(kind: str) -> bool:
    return kind in STAGE_KINDS or kind.startswith("STAGE:")


def _device_events(prof):
    """(name, start_ns, end_ns) of every device activity, from the raw
    Kineto events (building ``FunctionEvent`` objects for a quarter of a
    million kernels would take longer than the window)."""
    from torch.autograd import DeviceType
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:               # older profilers: FunctionEvents (us)
        return [(e.name, e.time_range.start * 1000, e.time_range.end * 1000)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = []
    for ev in results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        if hasattr(ev, "start_ns"):
            t0, dur = ev.start_ns(), ev.duration_ns()
        else:
            t0, dur = ev.start_us() * 1000, ev.duration_us() * 1000
        out.append((ev.name(), t0, t0 + dur))
    return out


def prime(device) -> None:
    """Load and start the profiler's tracing libraries once, in set-up:
    their first start takes seconds, which inside the window would stall
    the host and the requests behind it."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.empty(1, device=device).fill_(0.0)
    torch.cuda.synchronize(device)


class DeviceTrace:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        t = time.monotonic()
        self.prof.start()
        self.t0 = time.monotonic()
        self.start_s = self.t0 - t
        torch.empty(1, device=self.device).fill_(0.0)       # the marker

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t1 = time.monotonic()
        self.prof.stop()

    def reduce(self, spans) -> dict:
        """Busy and window seconds, device seconds by name, and idle
        seconds by the host stage open during each gap."""
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        self.prof = None
        window_s = self.t1 - self.t0
        if not events:
            return {"busy_s": 0.0, "window_s": window_s, "kernel_s": {},
                    "idle_by_stage": {}, "n_events": 0,
                    "start_s": self.start_s}
        offset_ns = events[0][1] - self.t0 * 1e9      # device - host clock
        lo, hi = self.t0 * 1e9 + offset_ns, self.t1 * 1e9 + offset_ns
        kernel_s = defaultdict(float)
        busy, gaps = 0, []
        cur0 = cur1 = None
        for name, a, b in events:
            kernel_s[name] += (b - a) * 1e-9
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                    gaps.append((cur1, a))
                elif a > lo:
                    gaps.append((lo, a))
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            busy += cur1 - cur0
            if cur1 < hi:
                gaps.append((cur1, hi))
        stage = [(s.t0 * 1e9 + offset_ns, s.t1 * 1e9 + offset_ns, s.kind)
                 for s in spans
                 if s.t1 is not None and s.t1 > s.t0 and _is_stage(s.kind)]
        stage.sort()
        starts = [s[0] for s in stage]
        idle = defaultdict(float)
        for a, b in gaps:
            idle[_open_stage(stage, starts, (a + b) / 2)] += (b - a) * 1e-9
        return {"busy_s": busy * 1e-9, "window_s": window_s,
                "kernel_s": dict(kernel_s), "idle_by_stage": dict(idle),
                "n_events": len(events), "start_s": self.start_s}


def _open_stage(stage, starts, t) -> str:
    """The innermost stage span open at ``t``: of the spans that hold it,
    the one that began last (stages nest, never overlap otherwise)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 16), -1):
        t0, t1, kind = stage[j]
        if t0 <= t <= t1:
            return kind
    return NO_STAGE


NAME_CHARS = 96


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of ``{name: seconds}``, largest first,
    names cut to their first ``NAME_CHARS`` characters (and merged)."""
    cut = defaultdict(float)
    for k, v in d.items():
        cut[k[:NAME_CHARS]] += v
    return [[k, v] for k, v in sorted(cut.items(), key=lambda kv: -kv[1])[:n]]
