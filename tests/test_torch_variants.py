"""Port vs JAX: the cell programs (``launch/steps.py``) and their perf
variants (``perf/variants.py``, ``models/gnn_partitioned.py``) on the CPU.

* ``_quantize_token`` equals JAX's bit for bit (float32 and bfloat16).
* ``decode_step_variant`` (split-K attention; int8 KV) on the reference
  test's tiny config against JAX's (logits to ``BF16_TOL = 6e-2``, as the
  port's bf16 model tests hold them; int8 codes within 2, scales to one
  bf16 step) and against the port's baseline ``decode_step`` (softmax
  within the reference's ``0.03`` split-K and ``0.1`` int8 bounds).
* ``forward_partitioned`` on one shard against JAX's ``gnn.forward``
  (``1e-4``, as ``tests/test_perf_variants.py``), and on 2 gloo ranks with
  dst-partitioned edges against the port's whole-graph forward, its
  gradients and one step of ``build_gnn_partitioned_variant`` against
  ``build_gnn_cell``'s on the whole graph (``1e-4`` of each tensor's
  largest magnitude: the std aggregator's cancellation, as
  ``tests/test_torch_gnn.py``).

The cell programs themselves are held against JAX's in
``test_torch_cells.py``.
"""

import dataclasses
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

from repro.distributed.decode_attn import make_distributed_decode_attn as jmake
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.models import gnn as jgnn
from repro.models import transformer as jtr
from repro.perf import variants as jvar
from repro_torch import bridge
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.decode_attn import make_distributed_decode_attn
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import gnn
from repro_torch.models import transformer as tr
from repro_torch.models.gnn_partitioned import forward_partitioned
from repro_torch.perf import variants
from repro_torch.training.optim import init_opt_state
from repro_torch.training.pytree import leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 6e-2
CFG = jtr.TransformerConfig(name="pv", n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_head=16, d_ff=96, vocab_size=256)
TCFG = bridge.config_from_jax(dataclasses.asdict(CFG))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return bridge.tree_from_jax(_np(tree), device="cpu")


def _scaled_close(got, want, tol, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, msg


# ---------------------------------------------------------------------------
# int8 KV and the decode variant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_token_bit_equal(dt):
    x = np.random.default_rng(0).standard_normal((4, 2, 16), np.float32) * 3
    x[1, 0] = 0.0                     # an all-zero row: the 1e-8 floor
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jq, js = jvar._quantize_token(jnp.asarray(x, jdt))
    tq, ts = variants._quantize_token(torch.tensor(x).to(tdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bridge.tensor_to_numpy(ts),
                                  np.asarray(js, np.float32))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def tiny():
    params = jtr.init_params(jax.random.PRNGKey(0), CFG)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, 256)
    _, cache = jtr.prefill(params, toks, CFG, cache_len=32)
    return params, toks, cache


def _quantized(cache):
    kq, ks = jvar._quantize_token(cache["k"].reshape(-1, *cache["k"].shape[-2:]))
    vq, vs = jvar._quantize_token(cache["v"].reshape(-1, *cache["v"].shape[-2:]))
    return {"k": kq.reshape(cache["k"].shape),
            "v": vq.reshape(cache["v"].shape),
            "k_scale": ks.reshape(cache["k"].shape[:-1]),
            "v_scale": vs.reshape(cache["v"].shape[:-1])}


def _softmax(x):
    return torch.softmax(torch.as_tensor(np.asarray(x, np.float32)), -1)


@pytest.mark.parametrize("int8", [False, True], ids=["splitk", "int8kv"])
def test_decode_step_variant_matches_jax_and_baseline(tiny, int8):
    params, toks, cache = tiny
    tok = toks[:, -1]
    pos = jnp.full((2,), 12, jnp.int32)
    jcache = _quantized(cache) if int8 else cache
    mesh = jhost_mesh()
    with mesh:
        jl, jnew = jvar.decode_step_variant(
            params, jcache, tok, pos, CFG, jmake(mesh, CFG.q_per_kv,
                                                 quantized=int8), int8)
    tparams = bridge.params_from_jax(_np(params), device="cpu")
    tcache = _t(jcache)
    attn = make_distributed_decode_attn(make_host_mesh(), TCFG.q_per_kv,
                                        quantized=int8)
    ttok = torch.tensor(np.asarray(tok))
    tpos = torch.tensor(np.asarray(pos))
    tl, tnew = variants.decode_step_variant(tparams, tcache, ttok, tpos,
                                            TCFG, attn, int8)
    assert tnew is tcache                             # written in place
    np.testing.assert_allclose(bridge.tensor_to_numpy(tl),
                               np.asarray(jl, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    for key in jnew:
        got, want = bridge.tensor_to_numpy(tnew[key]), np.asarray(
            jnew[key], np.float32)
        if key in ("k", "v") and int8:
            # one bf16 step of the projected K/V and of its scale between
            # the frameworks moves a code by up to 2
            assert np.abs(got - want).max() <= 2, key
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2e-2,
                                       err_msg=key)
    base, _ = tr.decode_step(tparams, _t(cache), ttok, tpos, TCFG)
    gap = float((_softmax(bridge.tensor_to_numpy(base))
                 - _softmax(bridge.tensor_to_numpy(tl))).abs().max())
    assert gap < (0.1 if int8 else 0.03), gap


# ---------------------------------------------------------------------------
# dst-partitioned PNA
# ---------------------------------------------------------------------------

def test_forward_partitioned_one_shard_matches_jax():
    cfg = jgnn.PNAConfig(name="pv", n_layers=2, d_hidden=8, d_feat=6,
                         n_classes=3)
    params = jgnn.init_params(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 6))
    edges = jax.random.randint(jax.random.PRNGKey(2), (2, 40), 0, 16)
    base = jgnn.forward(params, x, edges, cfg)
    tcfg = gnn.PNAConfig(name="pv", n_layers=2, d_hidden=8, d_feat=6,
                         n_classes=3)
    part = forward_partitioned(_t(params), torch.tensor(np.asarray(x)),
                               torch.tensor(np.asarray(edges)), tcfg,
                               make_host_mesh(), ("data", "model"))
    np.testing.assert_allclose(part.numpy(), np.asarray(base), atol=1e-4)


N_LOC, E_LOC, F, C = 16, 48, 6, 3
GRAPH_SHAPE = {"n_nodes": 2 * N_LOC, "n_edges": 2 * E_LOC, "d_feat": F,
               "n_classes": C}


def _graph():
    """Two shards of N_LOC nodes whose last node is a pad node (zero
    features, label_mask 0); real edges between real nodes, partitioned
    by dst shard (dst local, src global) and padded with masked edges
    from the shard's pad node to itself.  Returns the shards and the
    whole graph (the shards' edges with global dst)."""
    rng = np.random.default_rng(3)
    n = 2 * N_LOC
    real = np.array([i for i in range(n) if i % N_LOC != N_LOC - 1])
    e = rng.choice(real, (2, 70))
    x = rng.standard_normal((n, F)).astype(np.float32)
    x[N_LOC - 1::N_LOC] = 0.0
    labels = rng.integers(0, C, n).astype(np.int32)
    label_mask = np.ones(n, np.float32)
    label_mask[N_LOC - 1::N_LOC] = 0.0
    shards = []
    for r in range(2):
        own = e[:, e[1] // N_LOC == r]
        assert own.shape[1] <= E_LOC
        pad = E_LOC - own.shape[1]
        src = np.concatenate([own[0], np.full(pad, r * N_LOC + N_LOC - 1)])
        dst = np.concatenate([own[1] - r * N_LOC, np.full(pad, N_LOC - 1)])
        mask = np.concatenate([np.ones(own.shape[1]), np.zeros(pad)])
        sl = slice(r * N_LOC, (r + 1) * N_LOC)
        shards.append({"x": x[sl], "edges": np.stack([src, dst]).astype(
            np.int32), "edge_mask": mask.astype(np.float32),
            "labels": labels[sl], "label_mask": label_mask[sl]})
    whole = {"x": x, "labels": labels, "label_mask": label_mask,
             "edges": np.concatenate(
                 [s["edges"] + np.array([[0], [r * N_LOC]], np.int32)
                  for r, s in enumerate(shards)], 1),
             "edge_mask": np.concatenate([s["edge_mask"] for s in shards])}
    return shards, whole


_GLOO_PNA = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port, out):
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        torch.set_num_threads(1)
        sys.path.insert(0, out)
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.configs import pna
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.models import gnn
        from repro_torch.models.gnn_partitioned import (forward_partitioned,
                                                        loss_partitioned)
        from repro_torch.perf.variants import build_gnn_partitioned_variant
        from repro_torch.training.optim import init_opt_state
        from repro_torch.training.pytree import leaves
        from repro_torch.training.train_loop import init_state, value_and_grad
        spec = json.load(open(f"{out}/spec.json"))
        shape = ShapeSpec("full_graph_sm", "train", spec["dims"])
        cfg = pna.config_for_shape(shape)
        batch = {k: torch.tensor(v) for k, v in
                 np.load(f"{out}/shard{rank}.npz").items()}
        mesh = DeviceMesh("cpu", torch.tensor([[0, 1]]),
                          mesh_dim_names=("data", "model"))
        axes = ("data", "model")
        params = init_state(gnn.init_params(torch.Generator().manual_seed(0),
                                            cfg))["params"]
        logits = forward_partitioned(params, batch["x"], batch["edges"], cfg,
                                     mesh, axes, batch["edge_mask"])
        loss, grads = value_and_grad(
            lambda p, b: loss_partitioned(p, b, cfg, mesh, axes))(params,
                                                                  batch)
        flat = leaves(grads)
        for g in [loss] + flat:
            dist.all_reduce(g)
        prog = build_gnn_partitioned_variant(pna.ARCH, shape, mesh)
        state = {"params": params, "opt": init_opt_state(params)}
        state, metrics = prog.fn(state, batch)
        np.savez(f"{out}/rank{rank}.npz", logits=logits.detach().numpy(),
                 loss=loss.numpy(), step_loss=metrics["loss"].numpy(),
                 grad_norm=metrics["grad_norm"].numpy(),
                 **{f"g{i}": g.numpy() for i, g in enumerate(flat)},
                 **{f"p{i}": p.detach().numpy()
                    for i, p in enumerate(leaves(state["params"]))})
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(2, int(sys.argv[1]), sys.argv[2]), nprocs=2)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_partitioned_pna_on_two_gloo_ranks_matches_whole_graph(tmp_path):
    from repro_torch.configs import pna
    from repro_torch.training.train_loop import init_state, value_and_grad
    shards, whole = _graph()
    (tmp_path / "spec.json").write_text(json.dumps({"dims": GRAPH_SHAPE}))
    for r, s in enumerate(shards):
        np.savez(tmp_path / f"shard{r}.npz", **s)
    script = tmp_path / "pna_ranks.py"
    script.write_text(_GLOO_PNA)
    r = subprocess.run([sys.executable, str(script), str(_free_port()),
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    ranks = [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(2)]

    shape = ShapeSpec("full_graph_sm", "train", GRAPH_SHAPE)
    cfg = pna.config_for_shape(shape)
    params = init_state(gnn.init_params(torch.Generator().manual_seed(0),
                                        cfg))["params"]
    tb = {k: torch.tensor(v) for k, v in whole.items()}
    want = gnn.forward(params, tb["x"], tb["edges"], cfg, tb["edge_mask"])
    _scaled_close(np.concatenate([x["logits"] for x in ranks]),
                  want.detach().numpy(), 1e-4, "logits")
    loss, grads = value_and_grad(lambda p, b: gnn.loss_fn(p, b, cfg))(
        params, tb)
    for x in ranks:
        np.testing.assert_allclose(x["loss"], loss.numpy(), rtol=1e-5)
        np.testing.assert_allclose(x["step_loss"], loss.numpy(), rtol=1e-5)
        for i, g in enumerate(leaves(grads)):
            _scaled_close(x[f"g{i}"], g.numpy(), 1e-4, f"grad {i}")
    prog = steps.build_gnn_cell(pna.ARCH, shape, make_host_mesh())
    state = {"params": params, "opt": init_opt_state(params)}
    state, metrics = prog.fn(state, tb)
    for x in ranks:
        np.testing.assert_allclose(x["grad_norm"], metrics["grad_norm"],
                                   rtol=1e-4)
        for i, p in enumerate(leaves(state["params"])):
            np.testing.assert_allclose(x[f"p{i}"], p.detach().numpy(),
                                       rtol=0, atol=1e-5)
