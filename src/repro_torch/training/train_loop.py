"""Training loop with checkpoint/restart, async saves and straggler hooks.

The counterpart of ``repro.training.train_loop``.  The step is eager: the
loss's gradients by ``torch.autograd.grad``, then ``adamw_update`` in
place.  A state is ``{"params": tree, "opt": init_opt_state(params)}``
whose floating parameter leaves are autograd leaves that require grad.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from repro_torch.training import checkpoint as ckpt
from repro_torch.training.elastic import StragglerMonitor
from repro_torch.training.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.training.pytree import leaves, tree_map, unflatten


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` over a tree of parameters: ``f(params,
    *args) -> (loss, grads)``, ``grads`` shaped like ``params`` (zeros
    where the loss does not reach a leaf)."""
    def f(params, *args):
        loss = loss_fn(params, *args)
        flat = leaves(params)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return loss.detach(), unflatten(params, grads)
    return f


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig = AdamWConfig()):
    """loss_fn(params, batch) -> scalar.  Returns the step fn
    ``step(state, batch) -> (state, {"loss", "grad_norm"})``; the state
    is updated in place."""
    grad_fn = value_and_grad(loss_fn)

    def step(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        _, _, gnorm = adamw_update(grads, state["opt"], state["params"],
                                   opt_cfg)
        return state, {"loss": loss, "grad_norm": gnorm}

    return step


def init_state(params) -> dict:
    """``{"params", "opt"}`` from a tree of tensors (``TransformerParams``:
    its ``tree()``).  The parameter leaves are detached views of the given
    tensors made to require grad (floating ones), so the optimizer writes
    into the given storage."""
    if hasattr(params, "tree"):
        params = params.tree()
    params = tree_map(
        lambda t: t.detach().requires_grad_(t.is_floating_point()), params)
    return {"params": params, "opt": init_opt_state(params)}


def train(state: dict, batches: Iterable, loss_fn: Callable,
          cfg: TrainConfig = TrainConfig(),
          opt_cfg: AdamWConfig = AdamWConfig(),
          on_step=None) -> tuple[dict, list[dict]]:
    """Runs up to cfg.steps; resumes from the latest committed checkpoint if
    ckpt_dir holds one (fault-tolerant restart).  The batches are consumed
    from the first, resumed or not."""
    step_fn = make_train_step(loss_fn, opt_cfg)
    start = 0
    writer = None
    if cfg.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        latest = ckpt.latest_step(cfg.ckpt_dir)
        if latest is not None:
            state, start = ckpt.restore(cfg.ckpt_dir, state)
    monitor = StragglerMonitor()
    history = []
    it = iter(batches)
    for step_idx in range(start, cfg.steps):
        try:
            batch = next(it)
        except StopIteration:
            break
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        monitor.record("host0", dt)
        rec = {"step": step_idx + 1, "loss": loss, "time": dt,
               "grad_norm": float(metrics["grad_norm"])}
        history.append(rec)
        if on_step:
            on_step(rec)
        if cfg.ckpt_dir and (step_idx + 1) % cfg.ckpt_every == 0:
            writer.save(step_idx + 1, state)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step_idx+1}")
    if writer:
        writer.wait()
    return state, history
