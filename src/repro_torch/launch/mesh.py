"""Device meshes (counterpart of ``repro.launch.mesh``).

Defined as functions, never module-level constants, so importing this
module touches no process group.  The production pod is 16 x 16 = 256
devices (``data`` x ``model``); the multi-pod mesh prepends a ``pod`` axis
(2 x 16 x 16 = 512).  Here a mesh is PyTorch's ``DeviceMesh`` over the
default process group, which must have the mesh's size: the dry-run
(``launch/dryrun.py``) builds the production meshes over the fake process
group of :func:`init_fake_group`, a process per mesh.

:func:`make_host_mesh` is the 1 x 1 mesh of one device.  A size-1 axis
needs no collective, so it is an :class:`AbstractMesh` -- a
``DeviceMesh``'s names and shape and no process group, as JAX's
``AbstractMesh`` is a mesh's names and sizes without devices -- and no
caller (the engine's ``attn_impl="splitk"``, the cell programs run on the
card) ever initialises a global process group behind its user's back.
Code that reads a mesh goes through :func:`axis_size` and
:func:`axis_names`, which take either kind; the spec rules
(``distributed/sharding.py``) run on an abstract mesh of any shape.
"""

from __future__ import annotations

import math
from dataclasses import dataclass



@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no process group and no
    device: its tensors compute where they lie."""
    shape: tuple[int, ...] = (1, 1)
    mesh_dim_names: tuple[str, ...] = ("data", "model")


def production_shape(multi_pod: bool) -> tuple[tuple[int, ...],
                                               tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """The default process group as PyTorch's fake backend: every
    collective returns at once and moves nothing, so one process can
    stand for any rank of a mesh of ``world_size`` devices.  Its world
    size is fixed until ``destroy_process_group``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ("data", "model") or 2 x 16 x 16 ("pod", "data", "model")
    over the default process group, whose world size must be 256 or 512;
    the dry-run's tensors are meta tensors, so its device type is "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh() -> AbstractMesh:
    """1 x 1 ("data", "model") mesh of the caller's device (smoke tests,
    examples, the engine's split-K decode)."""
    return AbstractMesh()


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(name)])


def mesh_size(mesh) -> int:
    return math.prod(int(s) for s in mesh.shape)


def axes_group(mesh, axes) -> tuple[int, object]:
    """(this rank's index along ``axes``, their process group), the axes
    taken major to minor as JAX's collectives over a tuple of axes take
    them; ``(0, None)`` when they span one device, so no collective runs."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if math.prod(axis_size(mesh, a) for a in axes) == 1:
        return 0, None
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"axes {axes} of an abstract mesh span "
                         f"{mesh.shape}: no process group to reduce over")
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    return sub.get_local_rank(), sub.get_group()


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axis names (includes ``pod`` when present)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def all_axes(mesh) -> tuple[str, ...]:
    return axis_names(mesh)


def named(mesh, *spec):
    """The DTensor placements of ``PartitionSpec(*spec)`` on ``mesh``
    (JAX's ``NamedSharding``)."""
    from repro_torch.distributed.sharding import P, to_placements
    return to_placements(P(*spec), mesh)
