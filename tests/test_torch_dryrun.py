"""The port's dry-run (``repro_torch.launch.dryrun``) on a 2 x 2 mesh over
the fake process group, in a subprocess (the group's world size is fixed
per process group, and a test worker runs many files in one process).

One cell of each family at a reduced size -- reduced Granite's train step
(FSDP x TP, sequence-parallel hints, remat, microbatches of the backward),
PNA's molecule step, reduced DLRM-RM2's candidate score -- writes a
well-formed record: collectives by kind, ``flops_global`` and rank 0's
argument bytes, which for Granite's parameters and AdamW moments equal
the shard shapes of JAX's specs times the itemsize.  A decode cell, whose
in-place cache write DTensor cannot shard, is recorded as failed with its
error.  ``flops_global`` counts a DTensor matmul at its global shape:
``2 M K N`` on the 2 x 2 mesh, by hand.
"""

import json
import math
import os
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
    a = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    b = distribute_tensor(torch.empty(32, 48, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    with FlopCounterMode(display=False) as fc:
        a @ b
    (out / "matmul.json").write_text(json.dumps(fc.get_total_flops()))
    dist.destroy_process_group()
""")


def test_dryrun_cells_on_a_fake_2x2_mesh(tmp_path):
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    recs = {f.name: json.loads(f.read_text())
            for f in tmp_path.glob("*__*__2x2.json")}
    assert set(recs) == {"granite-3-2b__train_t__2x2.json",
                         "pna__molecule__2x2.json",
                         "dlrm-rm2__score_t__2x2.json",
                         "granite-3-2b__decode_t__2x2.json"}
    for name, rec in recs.items():
        assert rec["mesh"] == "2x2" and rec["n_devices"] == 4, name
        assert rec["wall_s"] >= 0
        if "decode" in name:
            assert rec["ok"] is False and rec["error"], name
            continue
        assert rec["ok"] is True, (name, rec.get("error"))
        assert rec["flops_global"] > 0
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(
            v["bytes"] for k, v in coll.items() if k != "total_bytes")
        assert all(v["count"] > 0 for k, v in coll.items()
                   if k != "total_bytes")
        assert rec["memory"]["argument_bytes_per_device"] == sum(
            rec["memory"]["by_argument"].values())
    # rank 0's bytes of Granite's parameters and of each AdamW moment:
    # the shard shapes of JAX's specs times 4 bytes
    cfg = jget_arch("granite-3-2b").reduced()
    jp = jtr.abstract_params(cfg)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    specs = jax.tree_util.tree_leaves(
        jsh.lm_param_specs(jp, mesh, train=True),
        is_leaf=lambda x: isinstance(x, JP))
    want = sum(4 * math.prod(NamedSharding(mesh, s).shard_shape(p.shape))
               for s, p in zip(specs, jax.tree_util.tree_leaves(jp)))
    train = recs["granite-3-2b__train_t__2x2.json"]
    by_arg = train["memory"]["by_argument"]
    assert by_arg["arg0/params"] == want
    # the moments m and v, and the step counter (an int32 scalar)
    assert by_arg["arg0/opt"] == 2 * want + 4
    assert by_arg["arg1"] == 2 * (4 // 2) * 16 * 4     # tokens, labels
    assert train["collectives"]["all-gather"]["count"] > 0
    assert json.loads((tmp_path / "matmul.json").read_text()) == \
        2 * 64 * 32 * 48
