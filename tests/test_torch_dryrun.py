"""The port's dry-run (``repro_torch.launch.dryrun``) on a 2 x 2 mesh over
the fake process group, in a subprocess (the group's world size is fixed
per process group, and a test worker runs many files in one process).

One cell of each family at a reduced size -- reduced Granite's train step
(FSDP x TP, sequence-parallel hints, remat, microbatches of the backward),
PNA's molecule step, reduced DLRM-RM2's candidate score, reduced
Granite's decode step -- writes a well-formed record: collectives by
kind, ``flops_global`` and rank 0's argument bytes, which for Granite's
parameters and AdamW moments, and for the decode step's cache, equal the
shard shapes of JAX's specs times the itemsize.  The decode step writes
its cache (sharded on batch and sequence) in place through the dry-run's
``scatter_`` strategy, which the record lists.  On a 1 x 4 mesh, where
neither head count of a reduced Granite (6 query, 2 KV heads) divides
the "model" axis, its train step runs through the ``"q_proj"`` /
``"kv_proj"`` hints and is held to JAX's shard shapes the same way.
``flops_global`` counts a DTensor matmul at its global shape: ``2 M K
N`` on the 2 x 2 mesh, by hand.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as jsh
from repro.models import transformer as jtr

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from pathlib import Path
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_group

    out = Path(sys.argv[1])
    init_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def reduced(arch_id):
        arch = get_arch(arch_id)
        return dataclasses.replace(arch, config=arch.reduced())

    cells = [
        (reduced("granite-3-2b"),
         ShapeSpec("train_t", "train", {"seq_len": 16, "global_batch": 4})),
        (get_arch("pna"), get_arch("pna").shape("molecule")),
        (reduced("dlrm-rm2"),
         ShapeSpec("score_t", "score", {"batch": 1, "n_candidates": 64})),
        (reduced("granite-3-2b"),
         ShapeSpec("decode_t", "decode", {"seq_len": 32, "global_batch": 4})),
    ]
    for arch, shape in cells:
        dryrun.run_cell(arch, shape, mesh, "2x2", out)
    # 6 query and 2 KV heads over a "model" axis of 4
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    arch = reduced("granite-3-2b")
    arch = dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, **json.loads(sys.argv[2])))
    dryrun.run_cell(arch, cells[0][1], mesh14, "1x4", out)
    a = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    b = distribute_tensor(torch.empty(32, 48, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    with FlopCounterMode(display=False) as fc:
        a @ b
    (out / "matmul.json").write_text(json.dumps(fc.get_total_flops()))
    dist.destroy_process_group()
""")


def _shard_bytes(tree, specs, mesh, itemsize: int) -> int:
    specs = jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, JP))
    return sum(itemsize * math.prod(NamedSharding(mesh, s).shard_shape(
        p.shape)) for s, p in zip(specs, jax.tree_util.tree_leaves(tree)))


#: heads of the 1 x 4 cell: neither count divides the "model" axis
UNEVEN_HEADS = {"n_heads": 6, "n_kv_heads": 2, "d_head": 8}


def _check_train_bytes(rec, mesh, **heads) -> None:
    """Rank 0's bytes of reduced Granite's parameters (with ``heads``) and
    of each AdamW moment: the shard shapes of JAX's specs times 4 bytes."""
    cfg = dataclasses.replace(jget_arch("granite-3-2b").reduced(), **heads)
    jp = jtr.abstract_params(cfg)
    want = _shard_bytes(jp, jsh.lm_param_specs(jp, mesh, train=True), mesh,
                        4)
    by_arg = rec["memory"]["by_argument"]
    assert by_arg["arg0/params"] == want
    # the moments m and v, and the step counter (an int32 scalar)
    assert by_arg["arg0/opt"] == 2 * want + 4
    n_data = dict(zip(mesh.axis_names, mesh.axis_sizes))["data"]
    assert by_arg["arg1"] == 2 * (4 // n_data) * 16 * 4  # tokens, labels
    assert rec["collectives"]["all-gather"]["count"] > 0


def test_dryrun_cells_on_a_fake_2x2_mesh(tmp_path):
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path),
                        json.dumps(UNEVEN_HEADS)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    recs = {f.name: json.loads(f.read_text())
            for f in tmp_path.glob("*__*__*x*.json")}
    assert set(recs) == {"granite-3-2b__train_t__2x2.json",
                         "pna__molecule__2x2.json",
                         "dlrm-rm2__score_t__2x2.json",
                         "granite-3-2b__decode_t__2x2.json",
                         "granite-3-2b__train_t__1x4.json"}
    for name, rec in recs.items():
        assert rec["mesh"] in name and rec["n_devices"] == 4, name
        assert rec["wall_s"] >= 0
        assert rec["ok"] is True, (name, rec.get("error"))
        assert rec["flops_global"] > 0
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(
            v["bytes"] for k, v in coll.items() if k != "total_bytes")
        assert all(v["count"] > 0 for k, v in coll.items()
                   if k != "total_bytes")
        assert rec["memory"]["argument_bytes_per_device"] == sum(
            rec["memory"]["by_argument"].values())
        # the sources of the most bytes, each a part of its kind's total
        src = rec["collective_sources"]
        assert src and all(s["bytes"] <= coll[s["kind"]]["bytes"]
                           for s in src)
        assert [s["bytes"] for s in src] == sorted(
            (s["bytes"] for s in src), reverse=True)
        # each from a line of the port, through an aten op or a hint
        assert all(re.fullmatch(r"[\w/]+\.py:\d+ \w+", s["site"])
                   and (s["op"].startswith("aten.")
                        or s["op"] == "redistribute") for s in src), src
    mesh = AbstractMesh((2, 2), ("data", "model"))
    _check_train_bytes(recs["granite-3-2b__train_t__2x2.json"], mesh)
    uneven = recs["granite-3-2b__train_t__1x4.json"]
    _check_train_bytes(uneven, AbstractMesh((1, 4), ("data", "model")),
                       **UNEVEN_HEADS)
    # the decode step: its cache in place through the dry-run's scatter_,
    # rank 0's cache bytes the shard shapes of JAX's specs times 2 (bf16)
    decode = recs["granite-3-2b__decode_t__2x2.json"]
    assert "aten.scatter_.src" in decode["replicated_ops"]
    cfg = jget_arch("granite-3-2b").reduced()
    cache = jax.eval_shape(lambda: jtr.make_cache(cfg, 4, 32))
    assert decode["memory"]["by_argument"]["arg1"] == _shard_bytes(
        cache, jsh.lm_cache_specs(cache, mesh), mesh, 2)
    assert json.loads((tmp_path / "matmul.json").read_text()) == \
        2 * 64 * 32 * 48
