"""Port vs JAX: LM training on the CPU -- ``tr.loss_fn`` and its gradients,
``forward(remat=True)``, the train loop over a transformer, resuming from a
JAX checkpoint, and ``python -m repro_torch.launch.train``.

Configs: the reference's reduced Granite-3.0-2B (dense; vocabulary 512,
no padding), the same with vocabulary 500 (padded to 512, so the mask of
the padded logits is exercised) and the reduced Moonlight-16B-A3B (MoE, 8
experts top-2: the aux loss enters the loss).  Weights are JAX
``tr.init_params``'s carried across by ``repro_torch.bridge``; batches
are ``lm_batches``, equal in both packages.

Tolerances: gradients are held leaf by leaf against the leaf's largest
JAX magnitude.  float32: loss to ``rtol = 1e-6``, gradients to ``1e-5``
of that magnitude (the frameworks sum matmuls in other orders; measured
~2e-6).  bfloat16: every product rounds to bf16 (2^-8 relative) and a
backward pass chains several such roundings, so the loss is held to
``1e-3`` relative and gradients to ``BF16_TOL = 6e-2`` of the leaf's
magnitude (measured ~2.5e-2); the Moonlight inputs here meet no router
near-tie, so both sides route every token alike.  Five training steps in
float32: losses and gradient norms to ``rtol = 1e-5``, not raw parameters
(AdamW's first step moves a parameter by +-lr for any nonzero gradient,
so a gradient that is ~0 on both sides may step either way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_3_2b as jgranite
from repro.configs import moonshot_v1_16b_a3b as jmoon
from repro.data.synthetic import lm_batches
from repro.models import common as jcm
from repro.models import transformer as jtr
from repro.training import train_loop as jloop
from repro.training.optim import AdamWConfig as JAdamWConfig
from repro_torch import bridge
from repro_torch.launch import train as launch_train
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr
from repro_torch.training import checkpoint as ck
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.pytree import leaves
from repro_torch.training.train_loop import (TrainConfig, init_state, train,
                                             value_and_grad)

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

BF16_TOL = 6e-2
CONFIGS = {
    "granite": jgranite.reduced(),
    "granite_padded": dataclasses.replace(jgranite.reduced(), vocab_size=500),
    "moonlight": jmoon.reduced(),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(name: str):
    jcfg = CONFIGS[name]
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batches(vocab: int, n: int, seed: int = 1):
    return list(lm_batches(vocab, 2, 16, n, seed=seed))


def _jax_loss(jcfg, jdt=jnp.bfloat16):
    def loss(p, batch):
        return jtr.loss_fn(p, jnp.asarray(batch["tokens"]),
                           jnp.asarray(batch["labels"]), jcfg,
                           compute_dtype=jdt)
    return loss


def _torch_loss(tcfg, tdt=torch.bfloat16, remat=False):
    def loss(p, batch):
        return tr.loss_fn(p, torch.as_tensor(batch["tokens"]),
                          torch.as_tensor(batch["labels"]), tcfg,
                          compute_dtype=tdt, remat=remat)
    return loss


def _assert_grads(jgrads, tgrads, tol: float) -> None:
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = leaves(tgrads)
    assert len(flat) == len(got)
    for (path, want), g in zip(flat, got):
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        assert scale > 0, jax.tree_util.keystr(path)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_loss_and_count_params():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want = jcm.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = cm.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    jcfg, jparams, _, tparams = _pair("moonlight")
    n = jcm.count_params(jparams)
    assert cm.count_params(tparams) == cm.count_params(tparams.tree()) == n
    assert n == jcfg.param_count()     # vocabulary 512: no padding


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_jax(name, dt):
    jdt, tdt = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = _pair(name)
    batch = _batches(jcfg.vocab_size, 1)[0]
    jloss, jgrads = jax.value_and_grad(_jax_loss(jcfg, jdt))(jparams, batch)
    params = init_state(tparams)["params"]
    tloss, tgrads = value_and_grad(_torch_loss(tcfg, tdt))(params, batch)
    assert tloss.dtype == torch.float32 and not tloss.requires_grad
    if dt == "f32":
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
        _assert_grads(jgrads, tgrads, 1e-5)
    else:
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
        _assert_grads(jgrads, tgrads, BF16_TOL)


@pytest.mark.parametrize("name", ["granite", "moonlight"])
def test_remat_equals_no_remat(name):
    """Checkpointed layers recompute the same float32 numbers: loss and
    every gradient equal to ``rtol = atol = 1e-6``."""
    _, _, tcfg, tparams = _pair(name)
    batch = _batches(tcfg.vocab_size, 1)[0]
    params = init_state(tparams)["params"]
    want_loss, want = value_and_grad(_torch_loss(tcfg, torch.float32))(
        params, batch)
    got_loss, got = value_and_grad(_torch_loss(tcfg, torch.float32, True))(
        params, batch)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)
    for a, b in zip(leaves(want), leaves(got)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


def test_stacked_weights_get_one_gradient_a_stack():
    """``forward`` unbinds each stacked leaf once: the backward pass
    reaches every layer stack through one UnbindBackward, never through a
    select a layer (which would write a zero-filled stack-sized gradient
    per layer)."""
    _, _, tcfg, tparams = _pair("granite")
    batch = _batches(tcfg.vocab_size, 1)[0]
    params = init_state(tparams)["params"]
    loss = _torch_loss(tcfg, torch.float32)(params, batch)
    stacks = {id(t): name for name, t in params["layers"].items()}
    feeding = {name: set() for name in stacks.values()}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            leaf = getattr(nxt, "variable", None)
            if leaf is not None and id(leaf) in stacks:
                feeding[stacks[id(leaf)]].add(type(fn).__name__)
            todo.append(nxt)
    assert feeding == {name: {"UnbindBackward0"} for name in feeding}


# ---------------------------------------------------------------------------
# Training: five steps, resuming from JAX's checkpoint, the launcher
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's ``train`` for 5 float32 steps on reduced Granite, writing a
    checkpoint at step 3."""
    jcfg, jparams, tcfg, tparams = _pair("granite")
    batches = _batches(jcfg.vocab_size, 5, seed=2)
    ckpt_dir = tmp_path_factory.mktemp("jax_ckpt")
    _, hist = jloop.train(
        jloop.init_state(jparams), [jax.tree_util.tree_map(jnp.asarray, b)
                                    for b in batches],
        _jax_loss(jcfg, jnp.float32),
        jloop.TrainConfig(steps=5, ckpt_dir=str(ckpt_dir), ckpt_every=3),
        JAdamWConfig(**OPT))
    return tcfg, tparams, batches, ckpt_dir, hist


def _close_history(got, want, steps):
    assert [h["step"] for h in got] == steps
    want = [h for h in want if h["step"] in steps]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-5)


def test_five_steps_match_jax(jax_run):
    tcfg, tparams, batches, _, jhist = jax_run
    _, hist = train(init_state(tparams), batches,
                    _torch_loss(tcfg, torch.float32), TrainConfig(steps=5),
                    AdamWConfig(**OPT))
    _close_history(hist, jhist, [1, 2, 3, 4, 5])
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_port_resumes_a_jax_checkpoint(jax_run):
    """The port's ``train`` resumes from JAX's step-3 checkpoint and runs
    JAX's steps 4 and 5 (the batches handed over start where JAX's run
    stood)."""
    tcfg, _, batches, ckpt_dir, jhist = jax_run
    assert ck.latest_step(ckpt_dir) == 3
    # a fresh, differently drawn template: everything comes from the disk
    template = init_state(tr.init_params(
        tcfg, torch.Generator().manual_seed(9), device="cpu"))
    state, _ = ck.restore(ckpt_dir, template)
    assert int(state["opt"]["step"]) == 3
    _, hist = train(template, batches[3:], _torch_loss(tcfg, torch.float32),
                    TrainConfig(steps=5, ckpt_dir=str(ckpt_dir)),
                    AdamWConfig(**OPT))
    _close_history(hist, jhist, [4, 5])


def test_launcher_trains_and_resumes(tmp_path, capsys):
    argv = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--ckpt", str(tmp_path)]
    state, hist = launch_train.main(argv + ["--steps", "3"])
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert ck.latest_step(tmp_path) == 3
    state, hist = launch_train.main(argv + ["--steps", "5", "--remat"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [4, 5]
    assert int(state["opt"]["step"]) == 5
    assert ck.latest_step(tmp_path) == 5


def test_launcher_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])
