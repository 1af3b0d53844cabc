"""Production-mesh dry-run (counterpart of ``repro.launch.dryrun``).

Runs each cell program of ``all_cells()`` (``launch/steps.py``) on the
16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data", "model") meshes
in one process, over PyTorch's fake process group, with every input a
meta DTensor placed by the cell's specs: the step runs op by op through
DTensor's sharding propagation, its collectives are issued and moved
nowhere, and no tensor has storage.  The fake group's world size is fixed
per group, so each mesh gets its own group, destroyed after its cells.

Each cell and mesh writes ``<out>/<arch>__<shape>__<mesh>.json``, the
reference's file names, with:

* ``memory`` -- rank 0's bytes of the arguments: the local shard shape of
  every input leaf times its itemsize, per argument (parameters,
  optimizer state, cache, batch) and in all;
* ``collectives`` -- count and bytes (of the collective's local result,
  as the reference counts an HLO op's result shape) by kind, as DTensor
  issued them (``CommDebugMode``), the backward included;
* ``collective_sources`` -- the ten (kind, DTensor op, model line)
  sources of the most collective bytes (``comm_counter``);
* ``replicated_ops`` -- the ops that ran on the dry-run's own strategies
  (``replicate_op``: those DTensor has none for, and ``_OVERRIDES``)
  rather than DTensor's;
* ``flops_global`` -- ``torch.utils.flop_counter`` over the DTensor ops,
  which sees each op at its global shapes: the whole mesh's FLOPs of the
  matmuls, convolutions and attention, not a rank's;
* ``wall_s`` -- the cell's wall time in this process.

XLA's ``cost_analysis`` and the reference's HLO scan with while-loop trip
weights have no counterpart here: these fields count what DTensor runs,
and none of them is claimed to equal the reference's numbers.  A cell
that raises is recorded with its error and counted as a failure.

    python -m repro_torch.launch.dryrun --arch granite-3-2b --mesh single
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path

import torch

from repro_torch.configs.base import all_cells
from repro_torch.distributed.sharding import is_spec, to_placements
from repro_torch.launch.mesh import (init_fake_group, make_production_mesh,
                                     mesh_size, production_shape)
from repro_torch.launch.steps import build_cell

_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "broadcast"))


def collective_kind(op_name: str) -> str:
    for mark, kind in _KINDS:
        if mark in op_name:
            return kind
    return "other"


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


_PKG = str(Path(__file__).resolve().parents[1])
#: frames that carry a collective but are not where the model asked for it
_PLUMBING = (str(Path(__file__).resolve()),
             str(Path(_PKG, "distributed", "hints.py")))


def _source() -> tuple[str, bool]:
    """("file:line function", explicit) of the innermost frame of this
    package that is not the dry-run or the hints (the model line whose
    op or hint issued the collective being counted); ``explicit`` when a
    ``DTensor.redistribute`` call (a hint) is on the stack."""
    f, site, explicit = sys._getframe(2), "?", False
    while f is not None:
        name = f.f_code.co_filename
        if f.f_code.co_name == "redistribute" and name.endswith("_api.py"):
            explicit = True
        if site == "?" and name.startswith(_PKG) and name not in _PLUMBING:
            site = (f"{Path(name).relative_to(_PKG).as_posix()}:"
                    f"{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return site, explicit


def comm_counter():
    """A ``CommDebugMode`` that also sums each collective's result bytes
    by kind (``.comm_bytes``) and by source (``.by_source``: kind, the
    DTensor op whose dispatch issued it -- ``redistribute`` for a hint --
    and the model line, ``_source``), and keeps the names of the ops it
    saw (``.ops``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import (
        c10d_collective_ops)

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.comm_bytes = defaultdict(int)
            self.by_source = defaultdict(lambda: [0, 0])
            self.ops = set()
            self._op = "?"

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(str(func))
            if any(t is DTensor for t in types):
                self._op = str(func)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or isinstance(
                    func, torch._ops.HigherOrderOperator):
                return out
            packet = func._overloadpacket
            if packet in self.comm_registry or packet in c10d_collective_ops:
                kind, n = collective_kind(str(packet)), _tensor_bytes(out)
                self.comm_bytes[kind] += n
                site, explicit = _source()
                entry = self.by_source[
                    (kind, "redistribute" if explicit else self._op, site)]
                entry[0] += 1
                entry[1] += n
            return out

    return CommBytes()


def top_sources(comm, n: int = 10) -> list[dict]:
    """The ``n`` (kind, op, model line) sources of the most collective
    bytes."""
    rows = sorted(comm.by_source.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"kind": k, "op": op, "site": site, "count": c, "bytes": b}
            for (k, op, site), (c, b) in rows]


_NO_STRATEGY = re.compile(r"Operator (\S+) does not have a sharding "
                          r"strategy registered")


def replicate_op(name: str, keep_dims_but: int | None = None,
                 indexed: str | None = None) -> None:
    """Register for ``name`` (an aten op DTensor has no sharding strategy
    for, as ``aten.scatter_reduce.two``) the strategy of replicated inputs
    and outputs: its DTensor inputs are gathered whole first, and those
    collectives are counted with the rest.  With ``keep_dims_but`` (the
    position of the op's ``dim`` argument), inputs and output may also
    share a shard on any other dim.

    ``indexed`` ("read" for a gather, "write" for an in-place scatter)
    also lets the first input keep a shard on ``dim`` itself while the
    other inputs are replicated: a write's result keeps that shard (each
    shard applies the updates that fall in its range), a read's is a
    ``Partial`` sum (each shard gives the rows it holds, zero elsewhere).
    That is how XLA partitions a scatter or gather into an operand sharded
    on the indexed dim; DTensor offers neither, since its local op would
    take a global index for a local one.  The dry-run's tensors are meta,
    so only shapes flow: the strategy serves to count the collectives of
    the partitioned op, and no value is computed on it.  A read is offered
    so only where it reads one position a slice along ``dim`` (the decode
    step's read of the bytes it may write back, a loss's read of its
    label's logit): its ``Partial`` is summed later, at a cost DTensor's
    choice of strategy does not see, and only such a read keeps that cost
    below gathering the input."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    ns, op, overload = name.split(".")
    target = getattr(getattr(getattr(torch.ops, ns), op), overload)
    n_out = len(target._schema.returns)

    @register_sharding(target)
    def strategy(*args, **kwargs):
        def each(place):
            return ([place] * n_out,
                    [place if isinstance(a, DTensorSpec) else None
                     for a in args])
        out = [each(Replicate())]
        if keep_dims_but is not None:
            nd = len(args[0].tensor_meta.shape)
            dim = args[keep_dims_but] % nd
            out += [each(Shard(d)) for d in range(nd) if d != dim]
            one = indexed == "write" or (
                indexed == "read" and args[2].tensor_meta.shape[dim] == 1)
            if one:
                _, ins = each(Replicate())
                ins[0] = Shard(dim)
                res = Partial() if indexed == "read" else Shard(dim)
                out.append(([res] * n_out, ins))
        return out


#: ops whose DTensor strategy fails in this torch on the cells' shapes:
#: ``gather`` along a sharded dim (a mask buffer of the index's shape
#: applied to a tensor of one dim less), ``scatter`` of sharded indices
#: into a replicated buffer, and the decode step's in-place ``scatter_``
#: into the cache (sharded on its sequence dim) that no DTensor strategy
#: keeps in place.  Each gets the strategy of ``replicate_op``; gather and
#: scatter_ may keep a shard on the indexed dim.
_OVERRIDES = (("aten.gather.default", 1, "read"),
              ("aten.scatter.src", None, None),
              ("aten.scatter_.src", 1, "write"))
_overridden = False


def override_strategies() -> None:
    global _overridden
    if not _overridden:
        for name, dim_arg, indexed in _OVERRIDES:
            replicate_op(name, dim_arg, indexed)
        _overridden = True


def distribute(tree, specs, mesh):
    """Every meta leaf of ``tree`` as a DTensor placed by its spec."""
    from torch.distributed.tensor import distribute_tensor
    if is_spec(specs):
        if isinstance(tree, torch.Tensor):
            return distribute_tensor(tree, mesh, to_placements(specs, mesh))
        # one spec for a whole subtree (JAX broadcasts a spec prefix)
        return _map(lambda t: distribute_tensor(
            t, mesh, to_placements(specs, mesh)), tree)
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh) for v, s in zip(tree, specs))
    raise TypeError(f"no spec for {type(tree)}")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tree of DTensors (local shard shapes)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _tensor_bytes(tree.to_local())
    return _tensor_bytes(tree)


def argument_bytes(args) -> dict:
    """Per argument (per top-level key of a dict argument) and in all."""
    parts = {}
    for i, a in enumerate(args):
        if isinstance(a, dict) and all(isinstance(v, dict)
                                       for v in a.values()):
            for k, v in a.items():
                parts[f"arg{i}/{k}"] = local_bytes(v)
        else:
            parts[f"arg{i}"] = local_bytes(a)
    return {"by_argument": parts,
            "argument_bytes_per_device": sum(parts.values())}


def run_cell(arch, shape, mesh, mesh_name: str, out_dir: Path,
             verbose: bool = True) -> dict:
    """One cell (an ``ArchSpec`` and one of its ``ShapeSpec``s) on
    ``mesh``; writes and returns its record."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    arch_id, shape_name = arch.arch_id, shape.name
    t0 = time.time()
    rec = {"arch": arch_id, "shape": shape_name, "step": shape.step,
           "mesh": mesh_name, "n_devices": mesh_size(mesh),
           "skip_reason": shape.skip}
    replicated = []
    override_strategies()
    try:
        while True:
            prog = build_cell(arch, shape, mesh)
            args = distribute(prog.abstract_inputs, prog.in_specs, mesh)
            memory = argument_bytes(args)
            comm = comm_counter()
            flops = FlopCounterMode(display=False)
            try:
                # the model's own tensors (positions, masks, zeros) take
                # part as replicated DTensors
                with implicit_replication(), comm, flops:
                    prog.fn(*args)
                break
            except NotImplementedError as e:
                # an op with no DTensor strategy: run it replicated, and
                # run the cell again from the start
                m = _NO_STRATEGY.search(str(e))
                if m is None or m.group(1) in replicated:
                    raise
                replicate_op(m.group(1))
                replicated.append(m.group(1))
        rec["replicated_ops"] = replicated + [
            name for name, _, _ in _OVERRIDES if name in comm.ops]
        counts = defaultdict(int)
        for op, n in comm.get_comm_counts().items():
            counts[collective_kind(str(op))] += n
        coll = {k: {"count": counts[k], "bytes": comm.comm_bytes[k]}
                for k in sorted(set(counts) | set(comm.comm_bytes))}
        coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
        rec.update({"ok": True, "flops_global": float(
            flops.get_total_flops()), "memory": memory,
            "collectives": coll, "collective_sources": top_sources(comm)})
    except Exception as e:
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"[:2000],
                    "traceback": traceback.format_exc()[-2000:]})
    rec["wall_s"] = round(time.time() - t0, 3)
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{arch_id}__{shape_name}__{mesh_name}.json"
    fname.write_text(json.dumps(rec, indent=1))
    if verbose:
        status = "OK" if rec.get("ok") else f"FAIL ({rec.get('error')})"
        print(f"[dryrun] {arch_id}:{shape_name} mesh={mesh_name} "
              f"{status[:300]} ({rec['wall_s']}s)", flush=True)
        if rec.get("ok"):
            mem = rec["memory"]["argument_bytes_per_device"]
            print(f"  flops_global={rec['flops_global']:.3e} "
                  f"coll_bytes/device="
                  f"{rec['collectives']['total_bytes']:.3e} "
                  f"args/device={mem / 2**30:.2f}GiB", flush=True)
    return rec


def run_mesh(cells, multi_pod: bool, out_dir: Path,
             skip_existing: bool = False) -> int:
    """Every cell on one production mesh, over a fake group of its size;
    returns the failures."""
    import torch.distributed as dist
    mesh_name = "multi" if multi_pod else "single"
    shape, _ = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    init_fake_group(n)
    failures = 0
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, sh in cells:
            fname = out_dir / f"{arch.arch_id}__{sh.name}__{mesh_name}.json"
            if skip_existing and fname.exists() and json.loads(
                    fname.read_text()).get("ok"):
                continue
            rec = run_cell(arch, sh, mesh, mesh_name, out_dir)
            failures += 0 if rec.get("ok") else 1
    finally:
        dist.destroy_process_group()
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Production-mesh dry-run")
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="both")
    p.add_argument("--include-skipped", action="store_true",
                   help="also run the noted-skip long_500k SW variants")
    p.add_argument("--out", default="dryrun_results")
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)
    out_dir = Path(args.out)
    cells = [(a, s) for a, s in all_cells(include_skipped=True)
             if (args.arch is None or a.arch_id == args.arch)
             and (args.shape is None or s.name == args.shape)
             and (s.skip is None or args.include_skipped or
                  args.shape == s.name)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = sum(run_mesh(cells, multi, out_dir, args.skip_existing)
                   for multi in meshes)
    print(f"[dryrun] done, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
