"""Port vs JAX: the embedding substrate and the recsys models on the CPU.

* ``models/embedding.py``: ``take`` and the segment reductions keep
  ``jnp.take``'s and ``jax.ops.segment_*``'s index rules (an id past the
  table gives a NaN row, a negative id wraps, an out-of-range segment id is
  dropped, an empty segment is -inf under the max and +inf under the min),
  with their gradients (ties of the max split evenly, as in JAX);
  ``embedding_bag`` in every mode; ``StackedTables``; the bag's sum
  equals the one-hot matmul (property).
* DLRM-RM2, two-tower, xDeepFM and MIND at the reference's ``reduced()``
  configs, weights from the JAX ``init`` carried across by
  ``bridge.tree_from_jax``: forward and tower outputs, the loss and every
  gradient leaf against ``jax.value_and_grad``; MIND's ``routing_init``
  gets a zero gradient; candidate scoring with repeated candidate ids
  (exact ties) gives JAX's top-k ids; the port's tree leaves come in
  ``jax.tree_util.tree_leaves``' order; five ``make_train_step`` steps of
  DLRM against JAX's (loss, gradient norm, parameters).
* The full-width configs on ``device="meta"``: every leaf shape equal to
  ``jax.eval_shape`` of the reference's init, ``count_params`` equal.
* ``recsys_batches`` bit-equal to the reference's.

Tolerance: float32 on both sides, summed in other orders by XLA and
torch; outputs, losses and gradients to ``rtol = 1e-5, atol = 1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, hst, settings

from repro.configs import get_arch as jget_arch
from repro.data import synthetic as jsynth
from repro.models import embedding as jemb
from repro.models import recsys as jrec
from repro.training import optim as joptim
from repro.training import train_loop as jloop
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.data import synthetic as tsynth
from repro_torch.models import common as cm
from repro_torch.models import embedding as emb
from repro_torch.models import recsys as rec
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.pytree import leaves, tree_map
from repro_torch.training.train_loop import (init_state, make_train_step,
                                             value_and_grad)

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
RECSYS_IDS = ("dlrm-rm2", "two-tower-retrieval", "xdeepfm", "mind")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               equal_nan=True)


def port_tree(jtree):
    """A JAX tree as the port's: exact tensors on the CPU, floating leaves
    requiring grad."""
    tree = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                                "cpu")
    return tree_map(lambda t: t.requires_grad_(t.is_floating_point()), tree)


def close_to_scale(got, want, tol: float) -> None:
    """Within ``tol`` times ``want``'s largest magnitude, element by
    element; NaN where ``want`` has NaN."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    scale = float(np.abs(np.nan_to_num(want)).max())
    assert float(d.max(initial=0.0)) <= tol * scale, (float(d.max()), scale)


def _assert_tree_close(got, want, check=_close):
    """``check(got_leaf, want_leaf)`` leaf by leaf, in JAX's order."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = leaves(got)
    assert len(flat) == len(tl)
    for (path, w), g in zip(flat, tl):
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        try:
            check(g, w)
        except AssertionError as e:
            raise AssertionError(jax.tree_util.keystr(path)) from e


# ---------------------------------------------------------------------------
# jnp.take and jax.ops.segment_* index rules
# ---------------------------------------------------------------------------

def test_take_gives_nan_past_the_table_and_wraps_negative_ids():
    table = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    ids = np.array([[0, 4, 5], [7, -1, -5], [-6, 2, 100]], np.int32)
    got = emb.take(torch.from_numpy(table), torch.from_numpy(ids))
    want = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isnan(got[0, 2]).all() and torch.isnan(got[2, 0]).all()
    np.testing.assert_array_equal(got[1, 1].numpy(), table[4])   # -1 wraps

    # the gradient of a NaN row is dropped; the wrapped rows take theirs
    w = np.random.default_rng(1).normal(size=ids.shape + (3,)).astype(
        np.float32)
    t = torch.from_numpy(table).requires_grad_()
    out = emb.take(t, torch.from_numpy(ids))
    torch.nansum(out * torch.from_numpy(w)).backward()
    jg = jax.grad(lambda x: jnp.nansum(
        jnp.take(x, jnp.asarray(ids), axis=0) * w))(jnp.asarray(table))
    _close(t.grad, jg)


def test_lookup_and_towers_keep_the_nan_rows():
    """An id past a stacked table reads NaN in ``StackedTables.lookup``
    and in the two-tower and MIND lookups, as in JAX."""
    st = emb.StackedTables((3, 4), 2, pad_rows_to=8)
    jst = jemb.StackedTables((3, 4), 2, pad_rows_to=8)
    table = np.arange(16, dtype=np.float32).reshape(8, 2)
    ids = np.array([[0, 0], [2, 3], [5, 4], [9, 0], [-1, 1]], np.int32)
    np.testing.assert_array_equal(
        st.lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jst.lookup(jnp.asarray(table), jnp.asarray(ids))))

    jcfg, tcfg = jget_arch("two-tower-retrieval").reduced(), get_arch(
        "two-tower-retrieval").reduced()
    jp = jrec.two_tower_init(jax.random.PRNGKey(0), jcfg)
    tp = port_tree(jp)
    users = np.array([0, 600, -1], np.int32)       # 600 is past 512 rows
    hist = np.full((3, jcfg.hist_len), 3, np.int32)
    hist[1, 0] = 10_000
    want = jax.jit(lambda p, u, h: jrec.user_tower(p, u, h, jcfg))(
        jp, jnp.asarray(users), jnp.asarray(hist))
    got = rec.user_tower(tp, torch.from_numpy(users), torch.from_numpy(hist),
                         tcfg)
    _close(got, want)
    assert torch.isnan(got[1]).all() and not torch.isnan(got[2]).any()


def test_segment_ops_drop_out_of_range_ids_and_fill_empty_segments():
    got = emb.segment_sum(torch.ones(4), torch.tensor([0, 1, 2, 3]), 3)
    np.testing.assert_array_equal(got.numpy(), [1.0, 1.0, 1.0])
    rng = np.random.default_rng(0)
    data = rng.normal(size=(7, 2)).astype(np.float32)
    data[2] = data[1]                        # a tie in segment 1's max
    seg = np.array([1, 1, 1, -1, 5, 3, 3], np.int32)   # 0, 2, 4 empty
    w = rng.normal(size=(5, 2)).astype(np.float32)
    for name in ("segment_sum", "segment_max", "segment_min"):
        jfn, tfn = getattr(jax.ops, name), getattr(emb, name)
        want = jfn(jnp.asarray(data), jnp.asarray(seg), 5)
        d = torch.from_numpy(data).requires_grad_()
        out = tfn(d, torch.from_numpy(seg), 5)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
        # the gradient through finite entries (empty max/min rows masked)
        torch.sum(torch.where(torch.isfinite(out), out, 0.0)
                  * torch.from_numpy(w)).backward()
        jg = jax.grad(lambda x: jnp.sum(jnp.where(
            jnp.isfinite(jfn(x, jnp.asarray(seg), 5)),
            jfn(x, jnp.asarray(seg), 5), 0.0) * w))(jnp.asarray(data))
        _close(d.grad, jg)
    mx = emb.segment_max(torch.from_numpy(data), torch.from_numpy(seg), 5)
    mn = emb.segment_min(torch.from_numpy(data), torch.from_numpy(seg), 5)
    assert (mx[[0, 2, 4]] == -np.inf).all() and (mn[[0, 2, 4]] == np.inf).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_jax(mode, weighted):
    """Every mode, with and without per-id weights; bag 3 is empty (0 under
    sum and mean, -inf under max, as in JAX); gradients of the table and
    the weights."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(0, 20, 12).astype(np.int32)
    seg = np.sort(rng.choice([0, 1, 2, 4], 12)).astype(np.int32)
    weights = rng.random(12).astype(np.float32) if weighted else None
    g = rng.normal(size=(5, 4)).astype(np.float32)

    def jf(t, wt):
        out = jemb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(seg), 5,
                                 mode, wt)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * g), out
    (_, want), jgrads = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table), None if weights is None else jnp.asarray(weights))
    t = torch.from_numpy(table).requires_grad_()
    wt = (None if weights is None
          else torch.from_numpy(weights).requires_grad_())
    out = emb.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(seg),
                            5, mode, wt)
    _close(out, want)
    assert (out[3] == (-np.inf if mode == "max" else 0.0)).all()
    torch.sum(torch.where(torch.isfinite(out), out, 0.0)
              * torch.from_numpy(g)).backward()
    _close(t.grad, jgrads[0])
    if weighted:
        _close(wt.grad, jgrads[1])
    with pytest.raises(ValueError):
        emb.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(seg), 5,
                          "median")


@settings(max_examples=20, deadline=None)
@given(n=hst.integers(1, 40), v=hst.integers(2, 50), d=hst.integers(1, 8),
       seed=hst.integers(0, 100))
def test_embedding_bag_sum_equals_onehot_matmul(n, v, d, seed):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, d)))
    ids = torch.from_numpy(rng.integers(0, v, n))
    seg = torch.from_numpy(np.sort(rng.integers(0, 4, n)))
    bag = emb.embedding_bag(table, ids, seg, 4, mode="sum")
    onehot = torch.nn.functional.one_hot(ids, v).double()
    seg_onehot = torch.nn.functional.one_hot(seg, 4).double()
    torch.testing.assert_close(bag, seg_onehot.T @ (onehot @ table),
                               rtol=1e-12, atol=1e-12)


@settings(max_examples=20, deadline=None)
@given(vs=hst.lists(hst.integers(1, 100), min_size=1, max_size=6),
       d=hst.integers(1, 8))
def test_stacked_tables_layout(vs, d):
    t = emb.StackedTables(tuple(vs), d)
    jt = jemb.StackedTables(tuple(vs), d)
    assert t.total_rows == jt.total_rows and t.total_rows % 512 == 0
    np.testing.assert_array_equal(t.offsets, jt.offsets)
    table = torch.arange(t.total_rows * d, dtype=torch.float32).reshape(-1, d)
    out = t.lookup(table, torch.zeros((2, len(vs)), dtype=torch.int32))
    for f in range(len(vs)):
        assert torch.equal(out[0, f], table[int(t.offsets[f])])


def test_mlp_init_is_a_list_of_truncated_normal_layers():
    layers = emb.mlp_init(torch.Generator().manual_seed(0), (64, 2000, 3))
    assert isinstance(layers, list) and len(layers) == 2
    w = layers[0]["w"] * 8.0                      # times sqrt(fan-in)
    assert w.shape == (64, 2000) and float(w.abs().max()) <= 3.0
    assert abs(float(w.std()) - 0.9866) < 0.01   # std of N(0,1) on [-3, 3]
    assert torch.equal(layers[1]["b"], torch.zeros(3))


# ---------------------------------------------------------------------------
# the four models against JAX
# ---------------------------------------------------------------------------

def recsys_batch(arch_id: str, cfg, b: int, seed: int = 0) -> dict:
    """A training batch of numpy arrays for ``arch_id`` at ``cfg``."""
    rng = np.random.default_rng(seed)
    if arch_id in ("dlrm-rm2", "xdeepfm"):
        out = next(tsynth.recsys_batches(
            cfg.n_sparse, cfg.vocab_per_field, b, 1,
            n_dense=getattr(cfg, "n_dense", 0), seed=seed))
        return out
    if arch_id == "two-tower-retrieval":
        return {"user_ids": rng.integers(0, cfg.n_users, b).astype(np.int32),
                "hist_ids": rng.integers(0, cfg.n_items, (b, cfg.hist_len))
                .astype(np.int32),
                "item_ids": rng.integers(0, cfg.n_items, b).astype(np.int32),
                "log_q": np.log(rng.random(b) * 1e-3 + 1e-6).astype(
                    np.float32)}
    return {"hist_ids": rng.integers(0, cfg.n_items, (b, cfg.hist_len))
            .astype(np.int32),
            "item_ids": rng.integers(0, cfg.n_items, b).astype(np.int32)}


#: per arch: (JAX init, JAX loss, port loss, JAX outputs, port outputs)
MODELS = {
    "dlrm-rm2": (
        jrec.dlrm_init, jrec.dlrm_loss, rec.dlrm_loss,
        lambda p, b, c: [jrec.dlrm_forward(p, b["dense"], b["sparse"], c)],
        lambda p, b, c: [rec.dlrm_forward(p, b["dense"], b["sparse"], c)]),
    "two-tower-retrieval": (
        jrec.two_tower_init, jrec.two_tower_loss, rec.two_tower_loss,
        lambda p, b, c: [jrec.user_tower(p, b["user_ids"], b["hist_ids"], c),
                         jrec.item_tower(p, b["item_ids"], c)],
        lambda p, b, c: [rec.user_tower(p, b["user_ids"], b["hist_ids"], c),
                         rec.item_tower(p, b["item_ids"], c)]),
    "xdeepfm": (
        jrec.xdeepfm_init, jrec.xdeepfm_loss, rec.xdeepfm_loss,
        lambda p, b, c: [jrec.xdeepfm_forward(p, b["sparse"], c)],
        lambda p, b, c: [rec.xdeepfm_forward(p, b["sparse"], c)]),
    "mind": (
        jrec.mind_init, jrec.mind_loss, rec.mind_loss,
        lambda p, b, c: [jrec.mind_interests(p, b["hist_ids"], c)],
        lambda p, b, c: [rec.mind_interests(p, b["hist_ids"], c)]),
}


def _pair(arch_id: str, seed: int = 0):
    """(JAX cfg, JAX params, port cfg, port params) at ``reduced()``."""
    jcfg, tcfg = jget_arch(arch_id).reduced(), get_arch(arch_id).reduced()
    jp = MODELS[arch_id][0](jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, port_tree(jp)


def jax_value_and_grad(loss, cfg):
    """``jax.value_and_grad`` of ``loss(params, batch, cfg)``, jitted (one
    compile is much cheaper here than op-by-op dispatch)."""
    return jax.jit(jax.value_and_grad(lambda p, b: loss(p, b, cfg)))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_outputs_loss_and_every_gradient_match_jax(arch_id):
    _, jloss, tloss, jfwd, tfwd = MODELS[arch_id]
    jcfg, jp, tcfg, tp = _pair(arch_id)
    batch = recsys_batch(arch_id, jcfg, 16, seed=3)
    want_out = jax.jit(lambda p, b: jfwd(p, b, jcfg))(jp, _jb(batch))
    for got, want in zip(tfwd(tp, _tb(batch), tcfg), want_out):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    jl, jg = jax_value_and_grad(jloss, jcfg)(jp, _jb(batch))
    tl, tg = value_and_grad(lambda p, b: tloss(p, b, tcfg))(tp, _tb(batch))
    _close(tl, jl)
    _assert_tree_close(tg, jg)
    assert all(torch.isfinite(g).all() for g in leaves(tg))


def test_two_tower_loss_without_log_q_matches_jax():
    jcfg, jp, tcfg, tp = _pair("two-tower-retrieval")
    batch = recsys_batch("two-tower-retrieval", jcfg, 8, seed=4)
    del batch["log_q"]
    _close(rec.two_tower_loss(tp, _tb(batch), tcfg),
           jax.jit(lambda p, b: jrec.two_tower_loss(p, b, jcfg))(
               jp, _jb(batch)))


def test_mind_routing_init_gets_a_zero_gradient():
    jcfg, jp, tcfg, tp = _pair("mind")
    batch = recsys_batch("mind", jcfg, 8, seed=5)
    _, jg = jax_value_and_grad(jrec.mind_loss, jcfg)(jp, _jb(batch))
    _, tg = value_and_grad(lambda p, b: rec.mind_loss(p, b, tcfg))(
        tp, _tb(batch))
    assert not np.asarray(jg["routing_init"]).any()
    assert torch.equal(tg["routing_init"], torch.zeros_like(
        tp["routing_init"]))
    assert tg["bilinear"].abs().max() > 0


def _scores(arch_id, p, cfg, cand, mod, np_in):
    """(values, ids) of the top 10 for one user over ``cand``."""
    if mod is jrec:
        arr, topk = jnp.asarray, jax.lax.top_k
    else:
        arr = torch.from_numpy
        from repro_torch.retrieval.exact import top_k as topk
    if arch_id == "dlrm-rm2":
        s = mod.dlrm_score_candidates(p, arr(np_in["dense"]),
                                      arr(np_in["sparse"]), arr(cand), cfg)
        return topk(s, 10)
    if arch_id == "xdeepfm":
        s = mod.xdeepfm_score_candidates(p, arr(np_in["sparse"]), arr(cand),
                                         cfg)
        return topk(s, 10)
    if arch_id == "two-tower-retrieval":
        return mod.two_tower_score_candidates(
            p, arr(np_in["user_ids"]), arr(np_in["hist_ids"]), arr(cand),
            cfg, 10)
    return mod.mind_score_candidates(p, arr(np_in["hist_ids"]), arr(cand),
                                     cfg, 10)


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_score_candidates_top_k_matches_jax_under_ties(arch_id):
    """Every candidate id twice: each score has an exact twin, and both
    packages rank the lower position of a tie first."""
    jcfg, jp, tcfg, tp = _pair(arch_id)
    user = recsys_batch(arch_id, jcfg, 1, seed=6)
    vocab = getattr(jcfg, "vocab_per_field", getattr(jcfg, "n_items", 0))
    cand = np.random.default_rng(7).permutation(vocab)[:30].astype(np.int32)
    cand = np.concatenate([cand, cand])
    with torch.no_grad():
        tv, ti = _scores(arch_id, tp, tcfg, cand, rec, user)
    jv, ji = _scores(arch_id, jp, jcfg, cand, jrec, user)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    # exact ties: the twins come out side by side, lower position first
    ids = ti.numpy()
    assert (ids[0::2] < 30).all() and (ids[1::2] == ids[0::2] + 30).all()


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_tree_leaves_come_in_jax_order(arch_id):
    """The i-th leaf of the port's tree is the i-th leaf of
    ``jax.tree_util.tree_leaves`` of the same tree (lists included)."""
    _, jp, _, tp = _pair(arch_id)
    want = jax.tree_util.tree_leaves(jp)
    got = leaves(tp)
    assert len(got) == len(want)
    assert (arch_id == "mind") != any(isinstance(v, list)
                                      for v in tp.values())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


FULL_COUNTS = {"dlrm-rm2": 1_664_786_753, "two-tower-retrieval": 770_313_728,
               "mind": 64_032_968}


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_full_config_on_meta_matches_jax_eval_shape(arch_id):
    """The full-width init on the meta device: JAX's leaf shapes, in
    order, and the reference's parameter count (6.66 GB of DLRM tables
    never allocated here)."""
    init = MODELS[arch_id][0]
    jcfg, tcfg = jget_arch(arch_id).config, get_arch(arch_id).config
    want = jax.eval_shape(lambda k: init(k, jcfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    tinit = {"dlrm-rm2": rec.dlrm_init, "two-tower-retrieval":
             rec.two_tower_init, "xdeepfm": rec.xdeepfm_init,
             "mind": rec.mind_init}[arch_id]
    got = tinit(torch.Generator(), tcfg, device="meta")
    wl = jax.tree_util.tree_leaves(want)
    assert [tuple(t.shape) for t in leaves(got)] == [w.shape for w in wl]
    assert all(t.is_meta and t.dtype == torch.float32 for t in leaves(got))
    n = sum(int(np.prod(w.shape)) for w in wl)
    assert cm.count_params(got) == n
    if arch_id in FULL_COUNTS:
        assert n == FULL_COUNTS[arch_id]


def test_count_params_equals_the_references_on_reduced_trees():
    from repro.models import common as jcm
    for arch_id in RECSYS_IDS:
        _, jp, _, tp = _pair(arch_id)
        assert cm.count_params(tp) == jcm.count_params(jp) > 0


@pytest.mark.parametrize("n_dense,seed", [(0, 0), (13, 3)])
def test_recsys_batches_equal_jax(n_dense, seed):
    want = list(jsynth.recsys_batches(7, 50, 9, 3, n_dense=n_dense,
                                      seed=seed))
    got = list(tsynth.recsys_batches(7, 50, 9, 3, n_dense=n_dense,
                                     seed=seed))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


OPT = dict(lr=1e-2, warmup_steps=2)
#: parameters after five AdamW steps, relative to the leaf's largest
#: magnitude (see test_five_dlrm_steps_match_jax)
PARAM_TOL = 1e-4


def test_five_dlrm_steps_match_jax():
    """``make_train_step`` on reduced DLRM for 5 steps against the JAX
    package's on the same batches: loss and gradient norm each step to
    ``rtol = 1e-5``; after the last step every parameter within
    ``PARAM_TOL`` of its leaf's largest magnitude.  AdamW moves a
    parameter by ``lr * m / (sqrt(v) + eps)``: where a gradient is near
    eps (1e-8) -- an embedding entry touched once with a gradient of
    ~1e-9 -- the two sides take steps of other sizes (measured: one table
    entry 3.9e-5 apart, of a largest magnitude of 1.03)."""
    jcfg, jp, tcfg, tp = _pair("dlrm-rm2")
    batches = list(tsynth.recsys_batches(jcfg.n_sparse, jcfg.vocab_per_field,
                                         32, 5, n_dense=jcfg.n_dense, seed=8))
    jstep = jloop.make_train_step(lambda p, b: jrec.dlrm_loss(p, b, jcfg),
                                  joptim.AdamWConfig(**OPT))
    tstep = make_train_step(lambda p, b: rec.dlrm_loss(p, b, tcfg),
                            AdamWConfig(**OPT))
    jstate, tstate = jloop.init_state(jp), init_state(tp)
    for b in batches:
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
    _assert_tree_close(tstate["params"], jstate["params"],
                       lambda g, w: close_to_scale(g, w, PARAM_TOL))
    assert int(tstate["opt"]["step"]) == 5
