"""Straggler mitigation and elastic mesh planning.

Copies of ``largest_pow2_leq``, ``plan_mesh_shape`` and
``StragglerMonitor`` from ``repro.training.elastic`` (pure Python there
too; the port keeps its own copy):

* ``plan_mesh_shape`` -- the largest (data, model) grid the healthy
  devices can form, the model axis pinned;
* ``StragglerMonitor`` -- per-step host timing with MAD-based outlier
  detection; the launcher consults ``should_evict`` to drop persistent
  stragglers.

The reference's ``ElasticMesh`` (a JAX ``Mesh`` rebuilt from the healthy
devices, state resharded onto it with ``NamedSharding``) is not ported
here: it belongs with the distributed layer (``distributed/*``,
``launch/{mesh,steps,dryrun}.py``), which the port has not yet taken.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def plan_mesh_shape(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid from ``n_devices`` healthy devices.

    The model axis is pinned (weights are sharded that way); data axis
    shrinks to the largest multiple that fits -- leftover devices idle until
    the next resize window.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{n_devices} devices")
    data = largest_pow2_leq(n_devices // model_parallel)
    return data, model_parallel


@dataclass
class StragglerMonitor:
    """MAD outlier detection over per-host step times."""
    threshold: float = 4.0          # multiples of MAD
    patience: int = 3               # consecutive flags before eviction
    history: dict = field(default_factory=dict)
    flags: dict = field(default_factory=dict)

    def record(self, host: str, step_time: float) -> None:
        self.history.setdefault(host, []).append(step_time)
        self.history[host] = self.history[host][-32:]

    def _latest(self) -> dict:
        return {h: t[-1] for h, t in self.history.items() if t}

    def stragglers(self) -> list[str]:
        latest = self._latest()
        if len(latest) < 3:
            return []
        vals = list(latest.values())
        med = statistics.median(vals)
        mad = statistics.median([abs(v - med) for v in vals]) or 1e-9
        out = []
        for h, v in latest.items():
            if (v - med) / mad > self.threshold:
                self.flags[h] = self.flags.get(h, 0) + 1
                out.append(h)
            else:
                self.flags[h] = 0
        return out

    def should_evict(self) -> list[str]:
        self.stragglers()
        return [h for h, c in self.flags.items() if c >= self.patience]
