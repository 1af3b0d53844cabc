"""Port vs JAX: PNA (``repro_torch.models.gnn``) and the neighbour sampler
on the CPU.

* ``forward``, ``loss_fn`` and every gradient leaf against
  ``jax.value_and_grad`` at the reference's ``reduced()`` config, weights
  from the JAX ``init_params`` carried across by ``bridge.tree_from_jax``:
  node-level with the padding convention (padded edges masked and pointing
  at a zero-feature pad node, ``label_mask`` 0 on it), node-level without
  masks, and molecule-style graph-level with pad nodes carrying
  ``graph_id == n_graphs`` (dropped by the readout).
* ``_aggregate`` and ``_scale`` on messages with negative entries: degree
  weighted by ``edge_mask``, a masked edge's zero message still entering
  the max and min at its destination, empty segments masked by degree.
* An edge whose source is past the node table reads a NaN row, as
  ``jnp.take`` does.
* Properties (mirroring ``tests/test_models_property.py``): invariance
  under edge permutation, finite outputs with isolated nodes.
* Five ``make_train_step`` steps, node-level and molecule, against the
  JAX package's (loss, gradient norm, parameters).
* ``abstract_params`` on the meta device against the reference's at every
  shape's config, and ``graph_neighbor_sampler`` bit-equal to the
  reference's.

Tolerance: float32 on both sides; outputs and gradients within ``TOL =
1e-4`` of the tensor's largest magnitude, element by element (measured:
outputs 1.1e-5, at the isolated pad node; gradients 4.9e-5, in
``layers[1].msg[0].w``).  Not an rtol: the std aggregator subtracts two
sums (``sq / deg - mean**2``) that nearly cancel and its backward divides
by ``2 * std`` (down to ``2 * sqrt(1e-5)``), and the attenuation scaler
multiplies a node's towers by up to ``delta / 1e-5`` (an isolated node's
std tower is ``sqrt(1e-5) * 2e5``), so one framework's rounding of a sum
moves a small value by a large share of itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, hst, settings

from repro.configs import pna as jpna
from repro.data import synthetic as jsynth
from repro.models import common as jcm
from repro.models import gnn as jgnn
from repro.training import optim as joptim
from repro.training import train_loop as jloop
from repro_torch.configs import pna as tpna
from repro_torch.data import synthetic as tsynth
from repro_torch.models import common as cm
from repro_torch.models import gnn
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.pytree import leaves
from repro_torch.training.train_loop import (init_state, make_train_step,
                                             value_and_grad)
from test_torch_recsys import (PARAM_TOL, _assert_tree_close,
                               close_to_scale, port_tree)

TOL = 1e-4

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


def node_batch(cfg, n: int = 24, e: int = 80, n_pad_edges: int = 8,
               seed: int = 0) -> dict:
    """A padded node-level graph: node n-1 is the zero-feature pad node;
    the last ``n_pad_edges`` edges point at it with ``edge_mask`` 0;
    ``label_mask`` 0 on it.  Random edges leave some nodes isolated."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    x[-1] = 0.0
    edges = rng.integers(0, n - 1, (2, e)).astype(np.int32)
    mask = np.ones(e, np.float32)
    if n_pad_edges:
        edges[:, -n_pad_edges:] = n - 1
        mask[-n_pad_edges:] = 0.0
    label_mask = np.ones(n, np.float32)
    label_mask[-1] = 0.0
    return {"x": x, "edges": edges, "edge_mask": mask,
            "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
            "label_mask": label_mask}


def molecule_batch(cfg, n_graphs: int = 4, nodes: int = 5, edges: int = 8,
                   n_pad: int = 4, seed: int = 0) -> dict:
    """``n_graphs`` disjoint graphs of ``nodes`` nodes, then ``n_pad`` pad
    nodes with ``graph_id == n_graphs``; two padded edges a graph point at
    the last pad node, masked."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes + n_pad
    x = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    x[n_graphs * nodes:] = 0.0
    src, dst, mask = [], [], []
    for g in range(n_graphs):
        src += list(g * nodes + rng.integers(0, nodes, edges)) + [n - 1] * 2
        dst += list(g * nodes + rng.integers(0, nodes, edges)) + [n - 1] * 2
        mask += [1.0] * edges + [0.0, 0.0]
    gids = np.concatenate([np.repeat(np.arange(n_graphs), nodes),
                           np.full(n_pad, n_graphs)]).astype(np.int32)
    return {"x": x, "edges": np.array([src, dst], np.int32),
            "edge_mask": np.array(mask, np.float32), "graph_ids": gids,
            "y": rng.normal(size=n_graphs).astype(np.float32),
            "n_graphs": n_graphs}


def _cfgs(graph_level: bool = False):
    jcfg, tcfg = jpna.reduced(), tpna.reduced()
    if graph_level:
        jcfg = dataclasses.replace(jcfg, graph_level=True, n_classes=1)
        tcfg = dataclasses.replace(tcfg, graph_level=True, n_classes=1)
    return jcfg, tcfg


def _pair(graph_level: bool = False, seed: int = 0):
    jcfg, tcfg = _cfgs(graph_level)
    jp = jgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, port_tree(jp)


def _jb(batch):
    return {k: (v if k == "n_graphs" else jnp.asarray(v))
            for k, v in batch.items()}


def _tb(batch):
    return {k: (v if k == "n_graphs" else torch.from_numpy(v))
            for k, v in batch.items()}


def _jax_loss(jcfg, static_n_graphs=None):
    def loss(p, b):
        if static_n_graphs is not None:
            b = dict(b, n_graphs=static_n_graphs)
        return jgnn.loss_fn(p, b, jcfg)
    return loss


def _strip(batch):
    """The batch without its static ``n_graphs`` (JAX traces arrays)."""
    return {k: v for k, v in batch.items() if k != "n_graphs"}


CASES = ["node", "node_unmasked", "molecule"]


def _case(case: str):
    graph_level = case == "molecule"
    jcfg, jp, tcfg, tp = _pair(graph_level)
    if graph_level:
        batch = molecule_batch(jcfg, seed=1)
    else:
        batch = node_batch(jcfg, seed=1)
        if case == "node_unmasked":
            batch = {k: batch[k] for k in ("x", "edges", "labels")}
    return jcfg, jp, tcfg, tp, batch


@pytest.mark.parametrize("case", CASES)
def test_forward_loss_and_every_gradient_match_jax(case):
    jcfg, jp, tcfg, tp, batch = _case(case)
    ng = batch.get("n_graphs")
    jfwd = jax.jit(lambda p, b: jgnn.forward(
        p, b["x"], b["edges"], jcfg, edge_mask=b.get("edge_mask"),
        graph_ids=b.get("graph_ids"), n_graphs=ng))
    want = jfwd(jp, _jb(_strip(batch)))
    tb = _tb(batch)
    got = gnn.forward(tp, tb["x"], tb["edges"], tcfg,
                      edge_mask=tb.get("edge_mask"),
                      graph_ids=tb.get("graph_ids"), n_graphs=ng)
    assert tuple(got.shape) == want.shape == (
        (ng, 1) if ng else (batch["x"].shape[0], jcfg.n_classes))
    close_to_scale(got, want, TOL)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jcfg, ng)))(
        jp, _jb(_strip(batch)))
    tl, tg = value_and_grad(lambda p, b: gnn.loss_fn(p, b, tcfg))(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_tree_close(tg, jg, lambda g, w: close_to_scale(g, w, TOL))


def test_graph_readout_drops_pad_graph_ids():
    """Pad nodes (``graph_id == n_graphs``) change no graph's output."""
    jcfg, jp, tcfg, tp = _pair(graph_level=True)
    b = _tb(molecule_batch(jcfg, seed=2))
    out = gnn.forward(tp, b["x"], b["edges"], tcfg, b["edge_mask"],
                      b["graph_ids"], 4)
    x = b["x"].clone()
    x[20:] = 5.0                       # features of the pad nodes only
    out2 = gnn.forward(tp, x, b["edges"], tcfg, b["edge_mask"],
                       b["graph_ids"], 4)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    with pytest.raises(ValueError):
        gnn.forward(tp, b["x"], b["edges"], tcfg)


def test_aggregate_and_scale_match_jax():
    """Messages with negative entries: a masked edge's zero message enters
    the max and min at its destination (node 1's max becomes 0), degree
    counts only unmasked edges, a node with only masked edges (node 3) and
    one with none (node 4) read 0 under max and min."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    msg = -np.abs(rng.normal(size=(7, 4))).astype(np.float32)
    dst = np.array([0, 1, 1, 2, 2, 3, 1], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    msg = msg * mask[:, None]
    degree = np.zeros(5, np.float32)
    np.add.at(degree, dst, mask)
    w = rng.normal(size=(5, 4 * jcfg.n_towers)).astype(np.float32)

    def jf(m):
        aggs = jgnn._aggregate(m, jnp.asarray(dst), 5, jnp.asarray(degree),
                               jcfg)
        towers = jgnn._scale(aggs, jnp.asarray(degree), jcfg)
        return jnp.sum(towers * w), (aggs, towers)
    (_, (jaggs, jtowers)), jgrad = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(msg))
    m = torch.from_numpy(msg).requires_grad_()
    aggs = gnn._aggregate(m, torch.from_numpy(dst), 5,
                          torch.from_numpy(degree), tcfg)
    towers = gnn._scale(aggs, torch.from_numpy(degree), tcfg)
    for a, ja in zip(aggs, jaggs):
        close_to_scale(a, ja, TOL)
    close_to_scale(towers, jtowers, TOL)
    torch.sum(towers * torch.from_numpy(w)).backward()
    close_to_scale(m.grad, jgrad, TOL)
    mx, mn = aggs[1].detach(), aggs[2].detach()
    assert (mx[1] == 0).all() and (mn[3] == 0).all() and (mx[4] == 0).all()


def test_an_out_of_range_source_reads_a_nan_row():
    jcfg, jp, tcfg, tp = _pair()
    b = node_batch(jcfg, n_pad_edges=0, seed=4)
    b["edges"][0, 3] = 1000
    want = jgnn.forward(jp, jnp.asarray(b["x"]), jnp.asarray(b["edges"]),
                        jcfg)
    got = gnn.forward(tp, torch.from_numpy(b["x"]),
                      torch.from_numpy(b["edges"]), tcfg)
    close_to_scale(got, want, TOL)
    assert torch.isnan(got).any() and not torch.isnan(got).all()


@settings(max_examples=15, deadline=None)
@given(seed=hst.integers(0, 50))
def test_pna_permutation_invariance(seed):
    """Permuting edge order must not change PNA output."""
    cfg = gnn.PNAConfig(name="h", n_layers=2, d_hidden=8, d_feat=6,
                        n_classes=3)
    params = gnn.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((12, 6), generator=g)
    edges = torch.randint(0, 12, (2, 30), generator=g)
    out1 = gnn.forward(params, x, edges, cfg)
    out2 = gnn.forward(params, x, edges[:, torch.randperm(30, generator=g)],
                       cfg)
    torch.testing.assert_close(out2, out1, rtol=0, atol=2e-4)


@settings(max_examples=15, deadline=None)
@given(seed=hst.integers(0, 50))
def test_pna_isolated_nodes_stable(seed):
    """Zero-degree nodes must produce finite outputs (no div-by-zero)."""
    cfg = gnn.PNAConfig(name="h", n_layers=2, d_hidden=8, d_feat=4,
                        n_classes=2)
    params = gnn.init_params(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((10, 4), generator=torch.Generator().manual_seed(seed))
    # all edges point at node 0: nodes 1..9 have degree 0
    edges = torch.stack([torch.arange(10), torch.zeros(10, dtype=torch.long)])
    assert torch.isfinite(gnn.forward(params, x, edges, cfg)).all()


OPT = dict(lr=1e-2, warmup_steps=2)


@pytest.mark.parametrize("case", ["node", "molecule"])
def test_five_pna_steps_match_jax(case):
    """5 ``make_train_step`` steps against the JAX package's on five
    batches: loss and gradient norm to ``rtol = 1e-5`` each step, the
    parameters after the last step within ``PARAM_TOL`` of their leaf's
    largest magnitude (measured: 1.1e-5 of 0.24)."""
    jcfg, jp, tcfg, tp, _ = _case(case)
    if case == "molecule":
        batches = [molecule_batch(jcfg, seed=10 + i) for i in range(5)]
    else:
        batches = [node_batch(jcfg, seed=10 + i) for i in range(5)]
    ng = batches[0].get("n_graphs")
    jstep = jloop.make_train_step(_jax_loss(jcfg, ng),
                                  joptim.AdamWConfig(**OPT))
    tstep = make_train_step(lambda p, b: gnn.loss_fn(p, b, tcfg),
                            AdamWConfig(**OPT))
    jstate, tstate = jloop.init_state(jp), init_state(tp)
    for b in batches:
        jstate, jm = jstep(jstate, _jb(_strip(b)))
        tstate, tm = tstep(tstate, _tb(b))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
    _assert_tree_close(tstate["params"], jstate["params"],
                       lambda g, w: close_to_scale(g, w, PARAM_TOL))


@pytest.mark.parametrize("shape", [s.name for s in jpna.SHAPES])
def test_abstract_params_match_the_reference(shape):
    """``abstract_params`` of each shape's config on the meta device:
    JAX's leaf shapes in order, the reference's count."""
    jcfg = jpna.config_for_shape(jpna.ARCH.shape(shape))
    tcfg = tpna.config_for_shape(tpna.ARCH.shape(shape))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = jax.tree_util.tree_leaves(jgnn.abstract_params(jcfg))
    got = gnn.abstract_params(tcfg)
    assert [tuple(t.shape) for t in leaves(got)] == [w.shape for w in want]
    assert all(t.is_meta for t in leaves(got))
    n = sum(int(np.prod(w.shape)) for w in want)
    assert cm.count_params(got) == n
    if shape == "full_graph_sm":
        assert n == 446_482


def test_tree_leaves_and_count_match_jax():
    _, jp, _, tp = _pair()
    assert isinstance(tp["layers"], list) and isinstance(
        tp["layers"][0]["msg"], list)
    want = jax.tree_util.tree_leaves(jp)
    got = leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    assert cm.count_params(tp) == jcm.count_params(jp)


def _graph(n: int, e: int, seed: int) -> np.ndarray:
    """Random edges over nodes [0, n) leaving the last 3 nodes without an
    in-edge (the sampler's empty-neighbourhood branch)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n - 3, e)])


@pytest.mark.parametrize("fanout,batch_nodes,seed",
                         [((3, 2), 5, 0), ((4,), 12, 1), ((2, 2, 2), 20, 2)])
def test_graph_neighbor_sampler_equals_jax(fanout, batch_nodes, seed):
    edges = _graph(40, 150, seed)
    got_it = tsynth.graph_neighbor_sampler(edges, 40, fanout, batch_nodes,
                                           seed=seed)
    want_it = jsynth.graph_neighbor_sampler(edges, 40, fanout, batch_nodes,
                                            seed=seed)
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        assert set(got) == set(want) == {"nodes", "edges", "targets"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
