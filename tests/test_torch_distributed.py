"""Port vs JAX: the distributed layer on the CPU.

* Spec trees (``distributed/sharding.py``) equal JAX's leaf for leaf, as
  tuples, on abstract 16 x 16, 2 x 16 x 16 and 2 x 2 meshes: every LM
  config's params (serving and training, f32 and int8, MoE with and
  without ``moe_megatron``), caches, ``divisible_axes``, GNN and recsys.
* Rank 0's local shard shapes of DTensors placed by those specs on a 2 x 2
  and a 16 x 16 mesh over the fake process group (in a subprocess) equal
  the shard shapes of JAX's ``NamedSharding``.
* ``hints``: nesting and the no-op on plain tensors.
* ``_local_decode_attn`` and ``reference_decode_attn`` against JAX's
  (float32 ``1e-5``; bfloat16 ``2e-2``, the reference test's bound), with
  shards past the length.
* ``make_distributed_decode_attn`` on 8 gloo ranks in one world (a
  subprocess): over 2 ranks, over 4 ranks and the (2, 4) data x model mesh
  of ``tests/test_distributed.py``, plain and int8, lengths that leave
  shards empty and a row of length 0, against JAX's
  ``reference_decode_attn`` (the int8 caches through JAX's quantized body
  on one device).  Same bounds.
* ``ElasticMesh`` fail / join on the same 8 gloo ranks gives the mesh
  shapes of JAX's over 8 forced host devices and takes the same ranks,
  laid out in rank order (JAX's layout where JAX's is in order: DTensor
  needs it, ``training/elastic.py``), and ``reshard`` moves a tree across
  the meshes unchanged.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.distributed import decode_attn as jda
from repro.distributed import hints as jhints
from repro.distributed import sharding as jsh
from repro.models import gnn as jgnn
from repro.models import recsys as jrec
from repro.models import transformer as jtr
from repro_torch.configs import get_arch
from repro_torch.distributed import decode_attn as tda
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LM_IDS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "granite-3-2b",
          "chatglm3-6b", "minitron-8b")
RECSYS_IDS = ("dlrm-rm2", "two-tower-retrieval", "xdeepfm", "mind")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _meshes(name):
    shape, names = MESHES[name]
    return JAbstractMesh(shape, names), AbstractMesh(shape, names)


def _tuples(tree):
    """A spec tree of either package with every spec as a tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tuple(tree)


def _leaves(spec_tree, tree):
    """(spec, leaf) pairs of a JAX spec tree and its tree."""
    specs = jax.tree_util.tree_leaves(spec_tree,
                                      is_leaf=lambda x: isinstance(x, JP))
    return list(zip(specs, jax.tree_util.tree_leaves(tree)))


def _lm_params(arch_id, int8):
    cfg = jget_arch(arch_id).config
    jp = jtr.abstract_params(cfg)
    tp = tr.abstract_params(get_arch(arch_id).config)
    if int8:
        jp = jax.eval_shape(jtr.quantize_for_serving, jp)
        tp = tr.quantize_for_serving(tp)
    return jp, tp.tree()


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_param_specs_equal_jax(arch_id, mesh):
    jm, tm = _meshes(mesh)
    moe = get_arch(arch_id).config.moe is not None
    for int8 in (False, True):
        jp, tp = _lm_params(arch_id, int8)
        for train in (False, True):
            for megatron in ((False, True) if moe else (False,)):
                want = jsh.lm_param_specs(jp, jm, train=train,
                                          moe_megatron=megatron)
                got = sh.lm_param_specs(tp, tm, train=train,
                                        moe_megatron=megatron)
                assert _tuples(got) == _tuples(want), (int8, train,
                                                       megatron)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x2"])
def test_cache_batch_and_io_specs_equal_jax(mesh):
    jm, tm = _meshes(mesh)
    for b in (1, 8, 32, 128, 6):
        cfg = get_arch("granite-3-2b").config
        want = jsh.lm_cache_specs(jtr.abstract_cache(cfg, b, 64), jm)
        got = sh.lm_cache_specs(tr.abstract_cache(cfg, b, 64), tm)
        assert _tuples(got) == _tuples(want)
        assert tuple(sh.lm_batch_specs(tm, b)) == tuple(
            jsh.lm_batch_specs(jm, b))
        assert _tuples(sh.lm_decode_io_specs(tm, b)) == _tuples(
            jsh.lm_decode_io_specs(jm, b))
    for n in (1, 2, 3, 16, 48, 256, 512, 1000, 10 ** 6):
        for axes in (("data",), ("data", "model"), ("model", "data")):
            if mesh == "2x16x16":
                axes = ("pod",) + axes
            assert sh.divisible_axes(n, axes, tm) == jsh.divisible_axes(
                n, axes, jm)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_gnn_and_recsys_specs_equal_jax(mesh):
    jm, tm = _meshes(mesh)
    assert _tuples(sh.gnn_specs(tm)) == _tuples(jsh.gnn_specs(jm))
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    for arch_id in RECSYS_IDS:
        jcfg, tcfg = jget_arch(arch_id).config, get_arch(arch_id).config
        init = arch_id.split("-")[0].replace("two", "two_tower")
        jinit = getattr(jrec, f"{init}_init")
        tinit = getattr(recsys, f"{init}_init")
        jp = jax.eval_shape(lambda k: jinit(k, jcfg), key)
        tp = tinit(torch.Generator(), tcfg, device="meta")
        assert _tuples(sh.recsys_param_specs(tp, tm)) == _tuples(
            jsh.recsys_param_specs(jp, jm)), arch_id
        batch = {"ids": (512, 26), "labels": (512,)}
        want = jsh.recsys_batch_specs(
            {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()},
            jm)
        got = sh.recsys_batch_specs(
            {k: torch.empty(v, device="meta") for k, v in batch.items()}, tm)
        assert _tuples(got) == _tuples(want)
    pcfg = jgnn.PNAConfig(name="p", n_layers=2, d_hidden=8, d_feat=6,
                          n_classes=3)
    assert len(jax.tree_util.tree_leaves(jgnn.abstract_params(pcfg))) == len(
        [t for t in torch.utils._pytree.tree_leaves(gnn.abstract_params(
            gnn.PNAConfig(name="p", n_layers=2, d_hidden=8, d_feat=6,
                          n_classes=3)))])


def test_spec_canonicalised_as_jax():
    for entries in ((("data",), "model"), ((), None), (("pod", "data"),),
                    (None, None, ("data",))):
        assert tuple(sh.P(*entries)) == tuple(JP(*entries))


_FAKE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import init_fake_group
    from repro_torch.models import transformer as tr
    from repro_torch.training.pytree import leaves
    out = {}
    for name, shape, names in (("2x2", (2, 2), ("data", "model")),
                               ("16x16", (16, 16), ("data", "model"))):
        init_fake_group(shape[0] * shape[1])
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        params = tr.abstract_params(get_arch("granite-3-2b").config).tree()
        specs = sh.lm_param_specs(params, mesh, train=True)
        out[name] = [list(distribute_tensor(
            p, mesh, sh.to_placements(s, mesh)).to_local().shape)
            for p, s in zip(leaves(params), leaves(specs))]
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def test_dtensor_local_shapes_equal_jax():
    """Local shards of DTensors on the fake group (rank 0) against JAX's
    shard shapes, leaf for leaf in flattening order."""
    r = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT],
                       capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    jp, _ = _lm_params("granite-3-2b", False)
    for name in ("2x2", "16x16"):
        jm, _ = _meshes(name)
        want = [list(NamedSharding(jm, s).shard_shape(leaf.shape))
                for s, leaf in _leaves(jsh.lm_param_specs(jp, jm,
                                                          train=True), jp)]
        assert got[name] == want, name


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    tm = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.to_placements(sh.P(("pod", "data"), "model"), tm) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.to_placements(sh.P(None, "model"), tm) == (
        Replicate(), Replicate(), Shard(1))
    assert sh.to_placements(sh.P(), tm) == (Replicate(),) * 3
    with pytest.raises(NotImplementedError):
        sh.to_placements(sh.P(("data", "pod")), tm)
    with pytest.raises(ValueError):
        sh.to_placements(sh.P("data", "data"), tm)


# ---------------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------------

def test_hints_nest_like_jax_and_leave_plain_tensors():
    for mod, P in ((jhints, JP), (hints, sh.P)):
        assert mod.hint("a") is None
        with mod.sharding_hints(a=P("data"), b=P(None, "model")):
            assert tuple(mod.hint("a")) == ("data",)
            with mod.sharding_hints(a=P("model")):
                assert tuple(mod.hint("a")) == ("model",)
                assert tuple(mod.hint("b")) == (None, "model")
            assert tuple(mod.hint("a")) == ("data",)
        assert mod.hint("a") is None and mod.hint("b") is None
    x = torch.ones(4, 3)
    with hints.sharding_hints(moe_dispatch=sh.P("data", "model")):
        assert hints.constrain(x, "moe_dispatch") is x
    assert hints.constrain(x, "absent") is x


# ---------------------------------------------------------------------------
# split-K decode attention
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b, s, h, h_kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d), np.float32),
            rng.standard_normal((b, s, h_kv, d), np.float32),
            rng.standard_normal((b, s, h_kv, d), np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_local_and_reference_decode_attn_match_jax(dtype):
    q, k, v = _attn_inputs(0, 3, 48, 8, 2, 16)
    clen = np.array([5, 48, 0], np.int32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    for off, lo, hi in ((0, 0, 16), (16, 16, 32), (32, 32, 48)):
        jo, jm, jl = jda._local_decode_attn(jq, jk[:, lo:hi], jv[:, lo:hi],
                                            jnp.asarray(clen), off, 4)
        to, tm, tl = tda._local_decode_attn(tq, tk[:, lo:hi], tv[:, lo:hi],
                                            torch.tensor(clen), off, 4)
        np.testing.assert_array_equal(np.isfinite(np.asarray(jm)),
                                      torch.isfinite(tm).numpy())
        for a, b in ((jo, to), (jm, tm), (jl, tl)):
            a = np.asarray(a, np.float32)
            b = b.float().numpy()
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=TOL[dtype],
                                       atol=TOL[dtype])
    want = jda.reference_decode_attn(jq, jk, jv, jnp.asarray(clen), 4)
    got = tda.reference_decode_attn(tq, tk, tv, torch.tensor(clen), 4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


_GLOO_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    B, S, H, H_KV, D = 4, 64, 8, 4, 16
    CLEN = [5, 64, 17, 0]
    CASES = {"m2": [[0, 1]], "m4": [[0, 1, 2, 3]],
             "d2m4": [[0, 1, 2, 3], [4, 5, 6, 7]]}

    def inputs():
        rng = np.random.default_rng(0)
        q = rng.standard_normal((B, 1, H, D), np.float32)
        k = rng.standard_normal((B, S, H_KV, D), np.float32)
        v = rng.standard_normal((B, S, H_KV, D), np.float32)
        kq = rng.integers(-127, 128, (B, S, H_KV, D)).astype(np.int8)
        vq = rng.integers(-127, 128, (B, S, H_KV, D)).astype(np.int8)
        ks = (rng.random((B, S, H_KV)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((B, S, H_KV)) * 0.02 + 1e-3).astype(np.float32)
        return q, k, v, kq, vq, ks, vs

    def run(rank, world, port, out):
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.distributed.decode_attn import (
            make_distributed_decode_attn)
        from repro_torch.distributed.sharding import P
        from repro_torch.training.elastic import ElasticMesh
        q, k, v, kq, vq, ks, vs = inputs()
        for name, ranks in CASES.items():
            mesh = DeviceMesh("cpu", torch.tensor(ranks),
                              mesh_dim_names=("data", "model"))
            coord = mesh.get_coordinate()
            if coord is None:
                continue
            nd, nm = len(ranks), len(ranks[0])
            bl, sl = B // nd, S // nm
            r = slice(coord[0] * bl, (coord[0] + 1) * bl)
            c = slice(coord[1] * sl, (coord[1] + 1) * sl)
            clen = torch.tensor(CLEN[r], dtype=torch.int32)
            for dt, tdt in (("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
                attn = make_distributed_decode_attn(mesh, H // H_KV)
                o = attn(torch.tensor(q[r]).to(tdt),
                         torch.tensor(k[r, c]).to(tdt),
                         torch.tensor(v[r, c]).to(tdt), clen)
                np.save(f"{out}/{name}_{dt}_{rank}.npy", o.float().numpy())
            attn = make_distributed_decode_attn(mesh, H // H_KV,
                                                quantized=True)
            o = attn(torch.tensor(q[r]).to(torch.bfloat16),
                     torch.tensor(kq[r, c]), torch.tensor(vq[r, c]),
                     torch.tensor(ks[r, c]).to(torch.bfloat16),
                     torch.tensor(vs[r, c]).to(torch.bfloat16), clen)
            np.save(f"{out}/{name}_int8_{rank}.npy", o.float().numpy())

        em = ElasticMesh(model_parallel=2)
        layouts = [em.mesh.mesh.tolist()]
        w = torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
        spec = {"w": P("data", "model"), "b": [P()]}
        tree = em.reshard({"w": w, "b": [w[0]]}, spec)
        ok = []
        for step in ("fail", "join"):
            layouts.append((em.fail(5) if step == "fail"
                            else em.join(5)).mesh.tolist())
            tree = em.reshard(tree, spec)
            if em.mesh.get_coordinate() is not None:
                ok.append(bool(torch.equal(tree["w"].full_tensor(), w))
                          and bool(torch.equal(
                              tree["b"][0].full_tensor(), w[0])))
        with open(f"{out}/elastic_{rank}.json", "w") as f:
            json.dump({"layouts": layouts, "ok": ok}, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(8, int(sys.argv[1]), sys.argv[2]), nprocs=8)
""")

_JAX_ELASTIC = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.training.elastic import ElasticMesh
    em = ElasticMesh(model_parallel=2)
    ids = lambda m: [[d.id for d in row] for row in m.devices.tolist()]
    layouts = [ids(em.mesh)]
    dev5 = jax.devices()[5]
    layouts.append(ids(em.fail(dev5)))
    layouts.append(ids(em.join(dev5)))
    print(json.dumps(layouts))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    script = out / "gloo_ranks.py"
    script.write_text(_GLOO_SCRIPT)
    r = subprocess.run([sys.executable, str(script), str(_free_port()),
                        str(out)], capture_output=True, text=True,
                       timeout=300, env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return out


def _jax_reference(dtype):
    rng = np.random.default_rng(0)
    b, s, h, h_kv, d = 4, 64, 8, 4, 16
    q = rng.standard_normal((b, 1, h, d), np.float32)
    k = rng.standard_normal((b, s, h_kv, d), np.float32)
    v = rng.standard_normal((b, s, h_kv, d), np.float32)
    kq = rng.integers(-127, 128, (b, s, h_kv, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, s, h_kv, d)).astype(np.int8)
    ks = (rng.random((b, s, h_kv)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((b, s, h_kv)) * 0.02 + 1e-3).astype(np.float32)
    clen = jnp.asarray([5, 64, 17, 0], jnp.int32)
    if dtype == "int8":
        from repro.launch.mesh import make_host_mesh
        mesh = make_host_mesh()
        attn = jda.make_distributed_decode_attn(mesh, h // h_kv,
                                                quantized=True)
        with mesh:
            out = attn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq),
                       jnp.asarray(vq), jnp.asarray(ks, jnp.bfloat16),
                       jnp.asarray(vs, jnp.bfloat16), clen)
        return np.asarray(out, np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return np.asarray(jda.reference_decode_attn(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), clen,
        h // h_kv), np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["m2", "m4", "d2m4"])
def test_distributed_decode_attn_on_gloo_ranks_matches_jax(gloo_run, case,
                                                           dtype):
    want = _jax_reference(dtype)
    tol = TOL["f32" if dtype == "f32" else "bf16"]
    n_ranks = {"m2": 2, "m4": 4, "d2m4": 8}[case]
    n_model = 4 if case != "m2" else 2
    n_data = n_ranks // n_model
    bl = want.shape[0] // n_data
    for rank in range(n_ranks):
        got = np.load(gloo_run / f"{case}_{dtype}_{rank}.npy")
        rows = slice(rank // n_model * bl, (rank // n_model + 1) * bl)
        np.testing.assert_allclose(got, want[rows], rtol=tol, atol=tol,
                                   err_msg=f"{case} rank {rank}")


def test_elastic_mesh_matches_jax_and_reshards(gloo_run):
    r = subprocess.run([sys.executable, "-c", _JAX_ELASTIC],
                       capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    in_order = [np.sort(np.ravel(x)).reshape(np.shape(x)).tolist()
                for x in want]
    assert in_order[:2] == want[:2]          # JAX's own is in order there
    for rank in range(8):
        rec = json.loads((gloo_run / f"elastic_{rank}.json").read_text())
        assert rec["layouts"] == in_order
        assert rec["ok"] == ([True, True] if rank < 4 else [True])
    # fail(5) leaves a (2, 2) mesh of ranks 0-3; join(5) a (4, 2) one
    assert [np.shape(x) for x in want] == [(4, 2), (2, 2), (4, 2)]
