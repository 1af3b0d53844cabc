"""Sharding hints (counterpart of ``repro.distributed.hints``).

Model code is mesh-agnostic; step builders know the mesh.  Builders
install named specs with ``sharding_hints(...)`` around the step's body
and model code applies them with ``constrain(x, name)``: a DTensor is
redistributed to the hinted placements on its own mesh (JAX:
``with_sharding_constraint``).  It is a no-op on a plain tensor or when
the hint is absent, which is every single-device path.
"""

from __future__ import annotations

import contextlib
import threading

_LOCAL = threading.local()


def _stack() -> list[dict]:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = [{}]
    return _LOCAL.stack


@contextlib.contextmanager
def sharding_hints(**specs):
    stack = _stack()
    merged = dict(stack[-1])
    merged.update(specs)
    stack.append(merged)
    try:
        yield
    finally:
        stack.pop()


def hint(name: str):
    return _stack()[-1].get(name)


def constrain_to(x, spec):
    """``x`` redistributed to ``spec`` (a ``P``) when it is a DTensor; any
    other ``x``, or a ``None`` spec, is returned as it is."""
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import to_placements
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def constrain(x, name: str):
    return constrain_to(x, hint(name))
