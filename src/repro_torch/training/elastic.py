"""Elastic scaling and straggler mitigation (counterpart of
``repro.training.elastic``).

* ``plan_mesh_shape`` -- the largest (data, model) grid the healthy
  devices can form, the model axis pinned (a copy of the reference's);
* ``ElasticMesh`` -- rebuilds that grid as a ``DeviceMesh`` over the
  healthy ranks of the default process group and reshards a state tree
  onto it;
* ``StragglerMonitor`` -- per-step host timing with MAD-based outlier
  detection; the launcher consults ``should_evict`` to drop persistent
  stragglers (which then flows into ``ElasticMesh`` as a failure).

Where JAX's mesh is a plain array of devices, a ``DeviceMesh`` makes a
process group per mesh dim, and making one is a collective over the whole
default group: every rank calls ``fail``, ``join`` (and the constructor)
in the same order, those outside the new mesh included.  A mesh dim's
process group orders its ranks by number (``new_group`` sorts them), and
DTensor's collectives go wrong on a mesh whose rows or columns are out of
rank order; so the mesh takes the ranks the plan picks -- the first
data x model healthy ones, as in the reference -- in rank order, where
JAX's mesh keeps a rejoined device last.  DTensor cannot
redistribute across two meshes, so ``reshard`` gathers each leaf whole on
its old mesh and ``distribute_tensor``s it onto the new one, whose shards
are sent from the new mesh's first rank.  That needs every rank of the
old mesh to take part and the new mesh's first rank to have been in it
(``join`` appends, so it keeps its first rank); after a real loss of a
rank the state comes back from a checkpoint instead.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

import torch


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


class ElasticMesh:
    """The largest (data, model) mesh of the healthy ranks, rebuilt on each
    membership change."""

    def __init__(self, ranks=None, model_parallel: int = 1,
                 device_type: str = "cpu"):
        import torch.distributed as dist
        self.all_ranks = list(ranks if ranks is not None
                              else range(dist.get_world_size()))
        self.healthy = list(self.all_ranks)
        self.model_parallel = model_parallel
        self.device_type = device_type
        self.mesh = self._build()

    def _build(self):
        from torch.distributed.device_mesh import DeviceMesh
        data, model = plan_mesh_shape(len(self.healthy), self.model_parallel)
        ranks = torch.tensor(sorted(self.healthy[:data * model])).reshape(
            data, model)
        return DeviceMesh(self.device_type, ranks,
                          mesh_dim_names=("data", "model"))

    def fail(self, rank: int):
        """Mark a rank unhealthy and rebuild the mesh."""
        self.healthy = [r for r in self.healthy if r != rank]
        self.mesh = self._build()
        return self.mesh

    def join(self, rank: int):
        if rank not in self.healthy:
            self.healthy.append(rank)
        self.mesh = self._build()
        return self.mesh

    def reshard(self, tree, spec_tree):
        """Move a state tree (DTensors or plain tensors, dicts and lists)
        onto the current mesh under ``spec_tree``."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch.distributed.sharding import to_placements
        from repro_torch.training.pytree import leaves, unflatten

        def move(x, spec):
            if not isinstance(x, DTensor):
                full = x
            elif x.device_mesh.get_coordinate() is None:
                # not on the old mesh: the new one's first rank sends
                full = torch.empty(x.shape, dtype=x.dtype,
                                   device=x.to_local().device)
            else:
                full = x.full_tensor()
            return distribute_tensor(full, self.mesh,
                                     to_placements(spec, self.mesh))
        # a spec is a tuple, so it is a leaf of the spec tree
        specs, flat = leaves(spec_tree), leaves(tree)
        if len(specs) != len(flat):
            raise ValueError("tree and spec tree of different shapes")
        return unflatten(tree, [move(x, s) for x, s in zip(flat, specs)])


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
