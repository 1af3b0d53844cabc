"""Port vs JAX: the training substrate (``repro_torch.training``) on the CPU.

The first half mirrors ``tests/test_training.py`` case for case on the
port: checkpoint round trip, torn checkpoints skipped, prune, the async
writer, kill-and-restart, loss decreasing, the int8 error bound, error
feedback, ``compressed_psum`` on a one-rank gloo group, ``plan_mesh_shape``
and the straggler monitor.  The second half holds the port against the
JAX package on identical numpy inputs: ``adamw_update`` at steps 1 and 3
with clipping active, ``lm_batches``, and checkpoints written by one
package restored by the other; trees with lists flatten as
``jax.tree_util`` does, and a reduced DLRM-RM2 train state (MLPs as lists)
checkpointed by either package restores in the other.

Tolerance for ``adamw_update``: both sides run the same float32 operations
in the same order, but XLA and torch may fuse or reduce them otherwise (the
global norm is a sum of per-leaf reductions), so parameters and moments
agree to ``rtol = 1e-6`` and ``atol = 1e-7`` -- where every gradient is
well away from zero, so that the step-1 ratio ``mhat / sqrt(vhat)`` (+-1
for any nonzero gradient) cannot change sign between the frameworks.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _hyp import given, hst, settings

from repro.data import synthetic as jsynth
from repro.training import checkpoint as jck
from repro.training import compression as jcomp
from repro.training import optim as joptim
from repro_torch.data import synthetic as tsynth
from repro_torch.training import checkpoint as ck
from repro_torch.training import compression as comp
from repro_torch.training import optim
from repro_torch.training.elastic import StragglerMonitor, plan_mesh_shape
from repro_torch.training.pytree import leaves
from repro_torch.training.train_loop import TrainConfig, init_state, train

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "b": {"x": torch.arange(6.0),
                  "n": torch.zeros((), dtype=torch.int32)}}


def _copy(tree):
    return [t.clone() for t in leaves(tree)]


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    want = _copy(t)
    ck.save(tmp_path, 7, t)
    restored, step = ck.restore(tmp_path, _tree(1))
    assert step == 7
    for a, b in zip(want, leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_skips_uncommitted(tmp_path):
    ck.save(tmp_path, 1, _tree())
    # fake a torn checkpoint at a later step
    d = tmp_path / "step_00000009"
    d.mkdir()
    (d / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step(tmp_path) == 1


def test_checkpoint_prune(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(tmp_path, s, _tree())
    ck.prune(tmp_path, keep=2)
    assert ck.latest_step(tmp_path) == 5
    _, step = ck.restore(tmp_path, _tree())
    assert step == 5


def test_async_checkpointer(tmp_path):
    w = ck.AsyncCheckpointer(tmp_path, keep=2)
    for s in (10, 20):
        w.save(s, _tree(s))
    w.wait()
    assert ck.latest_step(tmp_path) == 20


def test_async_checkpointer_copies_at_save(tmp_path):
    """The host copy is taken at ``save``: an in-place update right after
    it does not reach the checkpoint."""
    t = _tree()
    want = t["w"].clone()
    w = ck.AsyncCheckpointer(tmp_path)
    w.save(1, t)
    t["w"].add_(1.0)
    w.wait()
    restored, _ = ck.restore(tmp_path, t)
    torch.testing.assert_close(restored["w"], want, rtol=0, atol=0)


def test_checkpoint_refuses_bf16_and_mismatched_templates(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(tmp_path, 1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    ck.save(tmp_path, 2, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(tmp_path, {"w": torch.zeros(8, 4)})
    bad = _tree()
    bad["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tmp_path, bad)
    bad["w"] = torch.zeros(8, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        ck.restore(tmp_path, bad)


def _quadratic(p, batch):
    return torch.sum((p["w"] - batch) ** 2)


def test_train_restart_resumes(tmp_path):
    """Kill-and-restart: second run continues from the checkpoint."""
    cfg = optim.AdamWConfig(lr=1e-2)
    batches = [torch.ones(4)] * 10
    tc = TrainConfig(steps=6, ckpt_dir=str(tmp_path), ckpt_every=3)
    _, hist1 = train(init_state({"w": torch.zeros(4)}), batches, _quadratic,
                     tc, cfg)
    assert ck.latest_step(tmp_path) == 6
    # restart with more steps: resumes at 6, runs to 10
    tc2 = TrainConfig(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5)
    state, hist2 = train(init_state({"w": torch.zeros(4)}), batches,
                         _quadratic, tc2, cfg)
    assert hist2[0]["step"] == 7
    assert hist2[-1]["step"] == 10
    assert state["params"]["w"].requires_grad
    # the resumed run continues the uninterrupted one
    _, full = train(init_state({"w": torch.zeros(4)}), batches, _quadratic,
                    TrainConfig(steps=10), cfg)
    np.testing.assert_allclose([h["loss"] for h in hist1 + hist2],
                               [h["loss"] for h in full], rtol=1e-6)


def test_loss_decreases():
    _, hist = train(init_state({"w": torch.zeros(4)}), [torch.ones(4)] * 30,
                    _quadratic, TrainConfig(steps=30),
                    optim.AdamWConfig(lr=5e-2, weight_decay=0.0,
                                      warmup_steps=1))
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.5


def test_train_raises_on_a_non_finite_loss():
    def loss(p, batch):
        return torch.sum(p["w"]) * float("nan")
    with pytest.raises(FloatingPointError, match="step 1"):
        train(init_state({"w": torch.zeros(4)}), [None] * 3, loss,
              TrainConfig(steps=3))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(hst.integers(0, 1000))
def test_int8_compression_error_bound(seed):
    g = torch.randn(64, generator=torch.Generator().manual_seed(seed)) * 10
    q, s = comp.compress_int8(g)
    deq = comp.decompress_int8(q, s)
    amax = float(g.abs().max())
    assert float((g - deq).abs().max()) <= amax / 127.0 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compression_matches_jax(dtype):
    """Same q and scale as JAX's on the same numbers (a bf16 gradient is
    divided in float32 by the float32 scale, as jnp promotes it)."""
    g = (np.random.default_rng(3).standard_normal(257) * 5).astype(
        np.float32)
    jg = jnp.asarray(g, getattr(jnp, dtype))
    tg = torch.tensor(np.asarray(jg.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jcomp.compress_int8(jg)
    tq, ts = comp.compress_int8(tg)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_error_feedback_reduces_bias():
    g = torch.randn(128, generator=torch.Generator().manual_seed(0))
    r = torch.zeros(128)
    total_true = torch.zeros(128)
    total_sent = torch.zeros(128)
    for _ in range(50):
        total_true = total_true + g
        sent, r = comp.with_error_feedback(g, r)
        total_sent = total_sent + sent
    # accumulated transmitted gradient tracks the true sum within residual
    err = float((total_true - total_sent).abs().max())
    assert err <= float(g.abs().max()) / 127.0 * 55  # ~1 step of noise


def test_error_feedback_over_a_tree_matches_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((4, 6)).astype(np.float32),
         "b": {"c": rng.standard_normal(10).astype(np.float32)}}
    r = {"a": rng.standard_normal((4, 6)).astype(np.float32) * 0.01,
         "b": {"c": np.zeros(10, np.float32)}}
    jsent, jres = jcomp.with_error_feedback(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, r))
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict)  # noqa: E731
                      else torch.tensor(v) for k, v in t.items()}
    tsent, tres = comp.with_error_feedback(to_t(g), to_t(r))
    for want, got in ((jsent, tsent), (jres, tres)):
        for a, b in zip(jax.tree_util.tree_leaves(want), leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    zeros = comp.init_residual(to_t(g))
    assert all(float(z.abs().max()) == 0 for z in leaves(zeros))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_psum_single_device():
    # group of size 1: compressed psum must be ~identity
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        g = torch.randn(16, generator=torch.Generator().manual_seed(0))
        out = comp.compressed_psum(g)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out.numpy(), g.numpy(), atol=0.02)


# ---------------------------------------------------------------------------
# Elasticity + stragglers
# ---------------------------------------------------------------------------

def test_plan_mesh_shape():
    assert plan_mesh_shape(512, 16) == (32, 16)
    assert plan_mesh_shape(511, 16) == (16, 16)   # drop to largest pow2
    assert plan_mesh_shape(16, 16) == (1, 16)
    with pytest.raises(ValueError):
        plan_mesh_shape(8, 16)


def test_straggler_monitor_detects_and_evicts():
    m = StragglerMonitor(threshold=3.0, patience=2)
    for step in range(3):
        for h in ("a", "b", "c", "d"):
            m.record(h, 1.0 + 0.01 * step)
        m.record("slow", 10.0)
        flagged = m.stragglers()
        assert "slow" in flagged
    assert "slow" in m.should_evict()
    assert "a" not in m.should_evict()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _adam_inputs(seed=0):
    """A two-level tree of params and gradients whose every gradient is at
    least 0.05 from zero, so the step-1 sign of ``mhat / sqrt(vhat)``
    cannot differ between the frameworks."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (12, 8), "layers": {"wq": (2, 8, 8), "ln1": (2, 8)},
              "ln_f": (8,)}

    def draw(shape, grad):
        x = rng.standard_normal(shape).astype(np.float32)
        if grad:
            x = np.sign(x) * (np.abs(x) + 0.05) * 3.0   # norm well above 1
        return x

    def tree(grad):
        return {k: tree_of(v, grad) for k, v in shapes.items()}

    def tree_of(v, grad):
        return ({k: tree_of(s, grad) for k, s in v.items()}
                if isinstance(v, dict) else draw(v, grad))
    params = tree(False)
    grads = [tree(True) for _ in range(3)]
    return params, grads


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("warmup", [1, 10])
def test_adamw_update_matches_jax(warmup):
    """Steps 1, 2 and 3 on the same gradients, clipping active (norm > 1):
    the same parameters, moments, step and gradient norms."""
    cfg_kw = dict(lr=1e-2, warmup_steps=warmup, clip_norm=1.0)
    params, grads = _adam_inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = joptim.init_opt_state(jp)
    tp = _to_torch(params)
    topt = optim.init_opt_state(tp)
    jcfg, tcfg = joptim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    for i, g in enumerate(grads, start=1):
        jp, jopt, jn = joptim.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), jopt, jp, jcfg)
        tp2, topt2, tn = optim.adamw_update(_to_torch(g), topt, tp, tcfg)
        assert tp2 is tp and topt2 is topt          # updated in place
        assert float(jn) > 1.0                      # clipping is active
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(topt["step"]) == int(jopt["step"]) == i
        for want, got in ((jp, tp), (jopt["m"], topt["m"]),
                          (jopt["v"], topt["v"])):
            for a, b in zip(jax.tree_util.tree_leaves(want), leaves(got)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-7)
    for s in (1, 5, 12):
        np.testing.assert_allclose(
            float(optim.lr_schedule(torch.tensor(s, dtype=torch.int32),
                                    tcfg)),
            float(joptim.lr_schedule(jnp.asarray(s, jnp.int32), jcfg)),
            rtol=1e-7)


def test_clip_by_global_norm_matches_jax():
    _, grads = _adam_inputs(1)
    jc, jn = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads[0]), 2.0)
    tg = _to_torch(grads[0])
    tc, tn = optim.clip_by_global_norm(tg, 2.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(tg)), float(jn),
                               rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jc), leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 64, 0),
                                                  (49155, 2, 16, 3)])
def test_lm_batches_equal_jax(vocab, batch, seq, seed):
    want = list(jsynth.lm_batches(vocab, batch, seq, 3, seed=seed))
    got = list(tsynth.lm_batches(vocab, batch, seq, 3, seed=seed))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert set(g) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def _jax_state(seed=0):
    k = jax.random.PRNGKey(seed)
    params = {"w": jax.random.normal(k, (8, 4)),
              "b": {"x": jnp.arange(6.0)}}
    return {"params": params, "opt": joptim.init_opt_state(params)}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jck.save(tmp_path, 4, jstate)
    template = init_state({"w": torch.zeros(8, 4),
                           "b": {"x": torch.zeros(6)}})
    restored, step = ck.restore(tmp_path, template)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(jstate), leaves(restored)):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    assert restored["params"]["w"].requires_grad
    assert restored["opt"]["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = init_state(_tree(2) | {"b": {"x": torch.arange(6.0)}})
    state["opt"]["step"] += 3
    ck.save(tmp_path, 3, state)
    jstate = _jax_state()
    jstate["params"] = {"w": jnp.zeros((8, 4)), "b": {"x": jnp.zeros(6)}}
    restored, step = jck.restore(tmp_path, jstate)
    assert step == 3
    for a, b in zip(leaves(state), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(b), a.detach().numpy())
    assert int(restored["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# trees with lists (the recsys and GNN parameter trees)
# ---------------------------------------------------------------------------

def _list_tree(seed=0):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"z": [arr(2), {"w": arr(3, 2), "b": arr(2)}],
            "a": {"layers": [{"msg": [{"w": arr(4), "b": arr(1)}],
                              "ln": arr(2)},
                             {"msg": [], "ln": arr(3)}]},
            "m": [[arr(1), arr(5)], np.int32(7)]}


def test_tree_with_lists_flattens_as_jax():
    """Lists are tree nodes: items in index order inside the dicts'
    sorted-key order, leaf for leaf ``jax.tree_util.tree_leaves``;
    ``unflatten`` and ``tree_map`` keep the lists; checkpoint paths read
    ``/a/layers/0/msg/0/w``."""
    from repro_torch.training.pytree import tree_map, unflatten
    tree = _list_tree()
    want = jax.tree_util.tree_leaves(tree)
    got = leaves(tree)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g is w
    doubled = tree_map(lambda x: x * 2, tree)
    assert isinstance(doubled["z"], list) and isinstance(
        doubled["a"]["layers"][1]["msg"], list)
    for g, w in zip(leaves(doubled),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda x: x * 2, tree))):
        np.testing.assert_array_equal(g, w)
    rebuilt = unflatten(tree, range(10))
    assert rebuilt["m"] == [[4, 5], 6]
    assert rebuilt["z"] == [7, {"b": 8, "w": 9}]
    assert ck._paths(tree) == [
        "/a/layers/0/ln", "/a/layers/0/msg/0/b", "/a/layers/0/msg/0/w",
        "/a/layers/1/ln", "/m/0/0", "/m/0/1", "/m/1", "/z/0", "/z/1/b",
        "/z/1/w"]


def test_unflatten_holds_no_leaf_after_it_returns():
    """A tree built by ``unflatten`` (and so the gradients of
    ``value_and_grad``) is freed as soon as its last reference goes, with
    the cyclic collector off: no reference cycle keeps the leaves alive
    (a recursive closure did, holding a step's gradients until the next
    collection)."""
    import gc
    import weakref
    from repro_torch.training.pytree import unflatten
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.collect()
    gc.disable()
    try:
        tree = unflatten({"a": [0, {"b": 0}], "c": 0},
                         [leaf, torch.ones(1), torch.ones(2)])
        assert tree["a"][0] is leaf
        del tree, leaf
        assert ref() is None
    finally:
        gc.enable()


def _dlrm_states():
    """A JAX train state of reduced DLRM-RM2 (its ``bot`` and ``top``
    MLPs are lists) and the port's from the same weights."""
    from repro.configs import get_arch as jget_arch
    from repro.models import recsys as jrec
    from repro_torch import bridge
    cfg = jget_arch("dlrm-rm2").reduced()
    jparams = jrec.dlrm_init(jax.random.PRNGKey(0), cfg)
    tparams = bridge.tree_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return joptim.init_opt_state, jparams, init_state(tparams)


def test_jax_dlrm_checkpoint_restores_in_the_port(tmp_path):
    init_opt, jparams, template = _dlrm_states()
    opt = init_opt(jparams)
    opt = {"m": jax.tree_util.tree_map(lambda x: x + 1.0, opt["m"]),
           "v": jax.tree_util.tree_map(lambda x: x + 2.0, opt["v"]),
           "step": opt["step"] + 5}
    jstate = {"params": jparams, "opt": opt}
    jck.save(tmp_path, 5, jstate)
    restored, step = ck.restore(tmp_path, template)
    assert step == 5 and isinstance(restored["params"]["bot"], list)
    want = jax.tree_util.tree_leaves(jstate)
    assert len(leaves(restored)) == len(want)
    for a, b in zip(want, leaves(restored)):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    assert restored["params"]["top"][0]["w"].requires_grad


def test_port_dlrm_checkpoint_restores_in_jax(tmp_path):
    init_opt, jparams, state = _dlrm_states()
    with torch.no_grad():
        for t in leaves(state["params"]):
            t.add_(0.5)
    state["opt"]["step"] += 2
    ck.save(tmp_path, 2, state)
    jtemplate = {"params": jax.tree_util.tree_map(jnp.zeros_like, jparams),
                 "opt": init_opt(jparams)}
    restored, step = jck.restore(tmp_path, jtemplate)
    assert step == 2 and int(restored["opt"]["step"]) == 2
    for a, b in zip(leaves(state), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(b), a.detach().numpy())
    assert isinstance(restored["params"]["top"], list)
