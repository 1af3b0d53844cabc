"""Port vs JAX: the cell programs of ``launch/steps.py`` and the LM
variants of ``perf/variants.py`` on the CPU.

``build_lm_cell`` (train with microbatches, prefill, decode),
``build_gnn_cell``, ``build_recsys_cell`` (train, forward, score) and
``build_lm_decode_variant`` (split-K, int8 KV) on reduced configs on a
1 x 1 mesh against the same JAX cell program on its host mesh: float32 to
``1e-5``; bf16 compute to the model tests' ``BF16_TOL = 6e-2`` and a bf16
train step's loss to ``1e-3``.  Each program's input tree has the shape
of its spec tree (``tests/test_distributed.py``); the MoE train variant's
specs equal JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import steps as jsteps
from repro.models import gnn as jgnn
from repro.models import transformer as jtr
from repro.perf import variants as jvar
from repro.training.optim import init_opt_state as jinit_opt
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.perf import variants
from repro_torch.training.pytree import leaves
from test_torch_variants import BF16_TOL, _quantized, _t

torch.set_num_threads(1)

def _reduced(arch_id):
    ja, ta = jget_arch(arch_id), get_arch(arch_id)
    return (dataclasses.replace(ja, config=ja.reduced()),
            dataclasses.replace(ta, config=ta.reduced()))


def _shape(name, step, dims, variant=None):
    return (JShapeSpec(name, step, dims, variant=variant or {}),
            ShapeSpec(name, step, dims, variant=variant or {}))


def _auto_mesh():
    """JAX's 1 x 1 host mesh with Auto axes: ``jax.make_mesh`` makes them
    Explicit, where the reference's ``with_sharding_constraint`` hints
    raise."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _run_jax(prog, *args):
    with _auto_mesh():
        return jax.jit(prog.fn)(*args)


def _structure_matches(prog):
    """The input tree has the spec tree's shape (JAX: tree structures)."""
    from repro_torch.distributed.sharding import P

    def same(a, s):
        if isinstance(s, P):
            return isinstance(a, torch.Tensor) or all(
                isinstance(t, torch.Tensor) for t in leaves(a))
        if isinstance(a, dict):
            return set(a) == set(s) and all(same(a[k], s[k]) for k in a)
        return len(a) == len(s) and all(map(same, a, s))
    assert same(list(prog.abstract_inputs), list(prog.in_specs))


def _lm_inputs(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_lm_train_cell_matches_jax(arch_id):
    """Microbatches, remat, the sequence-parallel hint and (MoE) the
    ``moe_dispatch`` hints, in both packages on a 1 x 1 mesh."""
    ja, ta = _reduced(arch_id)
    js, ts = _shape("train_t", "train", {"seq_len": 16, "global_batch": 4})
    jprog = jsteps.build_lm_cell(ja, js, _auto_mesh(), microbatches=2)
    tprog = steps.build_lm_cell(ta, ts, make_host_mesh(), microbatches=2)
    _structure_matches(tprog)
    params = jtr.init_params(jax.random.PRNGKey(0), ja.config)
    jstate = {"params": params, "opt": jinit_opt(params)}
    toks = _lm_inputs(ja.config, 4, 16)
    labs = _lm_inputs(ja.config, 4, 16, seed=2)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    jnew, jm = _run_jax(jprog, jstate, batch)
    tstate = _t(jstate)
    tnew, tm = tprog.fn(tstate, {"tokens": torch.tensor(toks),
                                 "labels": torch.tensor(labs)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=BF16_TOL)
    # AdamW's first step moves each weight by lr * (sign(g) + wd * w), lr
    # = 3e-4 * 2 / 100 at step 1.  Where JAX's gradient (its first moment
    # m = 0.1 g) is clear of the bf16 noise, BF16_TOL of the leaf's
    # largest, the update new - old matches within 0.05 lr (the CPU read
    # at most 2.5e-3 lr); a missing update is 1 lr off, a flipped one 2 lr.
    # A gradient near 0 whose sign differs between the frameworks moves
    # its weight by 2 lr the other way, so those get 2.2 lr.
    lr = 3e-4 * 2 / 100
    for old, a, b, mt, mj in zip(
            jax.tree_util.tree_leaves(params), leaves(tnew["params"]),
            jax.tree_util.tree_leaves(jnew["params"]),
            leaves(tnew["opt"]["m"]),
            jax.tree_util.tree_leaves(jnew["opt"]["m"])):
        old = np.asarray(old, np.float64)
        mj = np.asarray(mj, np.float64)
        np.testing.assert_allclose(mt.double().numpy(), mj, rtol=0,
                                   atol=BF16_TOL * np.abs(mj).max())
        clear = np.abs(mj) > BF16_TOL * np.abs(mj).max()
        assert clear.any()
        err = np.abs((a.detach().double().numpy() - old)
                     - (np.asarray(b, np.float64) - old))
        assert err[clear].max() <= 0.05 * lr, (old.shape, err[clear].max())
        assert err.max() <= 2.2 * lr, (old.shape, err.max())
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_lm_serving_cells_match_jax(step):
    ja, ta = _reduced("granite-3-2b")
    js, ts = _shape(f"{step}_t", step, {"seq_len": 16, "global_batch": 2})
    jprog = jsteps.build_lm_cell(ja, js, _auto_mesh())
    tprog = steps.build_lm_cell(ta, ts, make_host_mesh())
    _structure_matches(tprog)
    qp = jtr.quantize_for_serving(jtr.init_params(jax.random.PRNGKey(0),
                                                  ja.config))
    toks = _lm_inputs(ja.config, 2, 16)
    if step == "prefill":
        jl, jcache = _run_jax(jprog, qp, jnp.asarray(toks))
        tl, tcache = tprog.fn(_t(qp), torch.tensor(toks))
    else:
        _, cache = jtr.prefill(qp, jnp.asarray(toks[:, :12]), ja.config,
                               cache_len=16)
        tok, pos = jnp.asarray(toks[:, 12]), jnp.full((2,), 12, jnp.int32)
        jl, jcache = _run_jax(jprog, qp, cache, tok, pos)
        tl, tcache = tprog.fn(_t(qp), _t(cache), torch.tensor(np.asarray(
            tok)), torch.tensor(np.asarray(pos)))
    np.testing.assert_allclose(bridge.tensor_to_numpy(tl),
                               np.asarray(jl, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(bridge.tensor_to_numpy(tcache[key]),
                                   np.asarray(jcache[key], np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_lm_decode_variant_cell_matches_jax():
    ja, ta = _reduced("granite-3-2b")
    js, ts = _shape("decode_t", "decode", {"seq_len": 16,
                                           "global_batch": 2})
    jprog = jvar.build_lm_decode_variant(ja, js, _auto_mesh(),
                                         int8_kv=True)
    tprog = variants.build_lm_decode_variant(ta, ts, make_host_mesh(),
                                             int8_kv=True)
    assert tprog.name == jprog.name
    _structure_matches(tprog)
    qp = jtr.quantize_for_serving(jtr.init_params(jax.random.PRNGKey(0),
                                                  ja.config))
    toks = _lm_inputs(ja.config, 2, 13)
    _, cache = jtr.prefill(qp, jnp.asarray(toks[:, :12]), ja.config,
                           cache_len=16)
    qcache = _quantized(cache)
    tok, pos = jnp.asarray(toks[:, 12]), jnp.full((2,), 12, jnp.int32)
    jl, _ = _run_jax(jprog, qp, qcache, tok, pos)
    tl, _ = tprog.fn(_t(qp), _t(qcache), torch.tensor(np.asarray(tok)),
                     torch.tensor(np.asarray(pos)))
    np.testing.assert_allclose(bridge.tensor_to_numpy(tl),
                               np.asarray(jl, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    with pytest.raises(ValueError):
        variants.build_lm_decode_variant(ta, ts, make_host_mesh(),
                                         splitk=False)


def test_lm_train_variant_specs_match_jax():
    from jax.sharding import AbstractMesh as JAbstractMesh
    from repro_torch.launch.mesh import AbstractMesh
    arch_id = "moonshot-v1-16b-a3b"
    js, ts = jget_arch(arch_id).shape("train_4k"), get_arch(
        arch_id).shape("train_4k")
    jm = JAbstractMesh((16, 16), ("data", "model"))
    tm = AbstractMesh((16, 16), ("data", "model"))
    jprog = jvar.build_lm_train_variant(jget_arch(arch_id), js, jm,
                                        microbatches=4, moe_megatron=True)
    tprog = variants.build_lm_train_variant(get_arch(arch_id), ts, tm,
                                            microbatches=4,
                                            moe_megatron=True)
    assert tprog.name == jprog.name
    from test_torch_distributed import _tuples
    assert _tuples(tprog.in_specs[0]["params"]) == _tuples(
        jprog.in_specs[0]["params"])


def _gnn_batch(shape, cfg, seed=5):
    """Concrete arrays in ``gnn_batch_abstract``'s padded layout."""
    abs_batch, meta = jsteps.gnn_batch_abstract(shape)
    rng = np.random.default_rng(seed)
    n, e = abs_batch["x"].shape[0], abs_batch["edges"].shape[1]
    nr, er = shape.dims["n_nodes"], shape.dims["n_edges"]
    x = np.zeros((n, cfg.d_feat), np.float32)
    x[:nr] = rng.standard_normal((nr, cfg.d_feat))
    edges = np.full((2, e), n - 1, np.int32)
    edges[:, :er] = rng.integers(0, nr, (2, er))
    mask = np.zeros(e, np.float32)
    mask[:er] = 1
    lm = np.zeros(n, np.float32)
    lm[:nr] = 1
    return {"x": x, "edges": edges, "edge_mask": mask,
            "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
            "label_mask": lm}


def test_gnn_cell_matches_jax():
    from repro.configs.pna import config_for_shape
    dims = {"n_nodes": 40, "n_edges": 100, "d_feat": 8, "n_classes": 4}
    js, ts = _shape("full_graph_sm", "train", dims)
    jprog = jsteps.build_gnn_cell(jget_arch("pna"), js, _auto_mesh())
    tprog = steps.build_gnn_cell(get_arch("pna"), ts, make_host_mesh())
    _structure_matches(tprog)
    params = jgnn.init_params(jax.random.PRNGKey(0), config_for_shape(js))
    jstate = {"params": params, "opt": jinit_opt(params)}
    batch = _gnn_batch(js, config_for_shape(js))
    jnew, jm = _run_jax(jprog, jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    tnew, tm = tprog.fn(_t(jstate), {k: torch.tensor(v)
                                     for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for a, b in zip(leaves(tnew["params"]),
                    jax.tree_util.tree_leaves(jnew["params"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)


def _recsys_batch(cfg, b, n_cand, step):
    rng = np.random.default_rng(7)
    out = {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
           "sparse": rng.integers(0, cfg.vocab_per_field,
                                  (b, cfg.n_sparse)).astype(np.int32)}
    if step == "train":
        out["labels"] = rng.integers(0, 2, b).astype(np.float32)
    if step == "score":
        out["candidates"] = rng.permutation(cfg.vocab_per_field)[
            :n_cand].astype(np.int32)
    return out


@pytest.mark.parametrize("step", ["train", "forward", "score"])
def test_recsys_cell_matches_jax(step):
    ja, ta = _reduced("dlrm-rm2")
    b = 1 if step == "score" else 16
    dims = {"batch": b, "n_candidates": 100} if step == "score" else {
        "batch": b}
    js, ts = _shape(f"{step}_t", step, dims)
    jprog = jsteps.build_recsys_cell(ja, js, _auto_mesh())
    tprog = steps.build_recsys_cell(ta, ts, make_host_mesh())
    _structure_matches(tprog)
    params = jsteps._RECSYS["dlrm-rm2"]["init"](jax.random.PRNGKey(0),
                                                ja.config)
    batch = _recsys_batch(ja.config, b, 100, step)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    if step == "train":
        jstate = {"params": params, "opt": jinit_opt(params)}
        jnew, jm = _run_jax(jprog, jstate, jb)
        tnew, tm = tprog.fn(_t(jstate), tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        for a, b_ in zip(leaves(tnew["params"]),
                         jax.tree_util.tree_leaves(jnew["params"])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_),
                                       rtol=0, atol=1e-6)
        return
    want = _run_jax(jprog, params, jb)
    with torch.no_grad():
        got = tprog.fn(_t(params), tb)
    if step == "forward":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_build_cell_dispatches_every_family():
    mesh = make_host_mesh()
    for arch_id, shape in (("granite-3-2b", "decode_32k"),
                           ("pna", "molecule"),
                           ("two-tower-retrieval", "train_batch")):
        arch = get_arch(arch_id)
        prog = steps.build_cell(arch, arch.shape(shape), mesh)
        assert prog.name == f"{arch_id}:{shape}"
        _structure_matches(prog)
        assert all(t.device.type == "meta"
                   for t in leaves(list(prog.abstract_inputs)))
