"""Hand-rolled AdamW (+ global-norm clipping) over nested dicts of tensors.

The counterpart of ``repro.training.optim``, with the reference's order of
operations: clip every gradient by the global norm, then bias corrections
``1 - b**step`` and ``delta = mhat / (sqrt(vhat) + eps) + wd * p``, and
``p - lr * delta`` cast back to ``p``'s dtype.  This is not
``torch.optim.AdamW``, which places the decay and ``eps`` otherwise and
rounds differently.  Moments are float32.

JAX returns new trees; the port updates the parameters and the moments IN
PLACE under ``torch.no_grad()`` and returns the same tensors, so a step
holds no second copy of the state.  The step count, learning rate, norm
and bias corrections stay 0-dim tensors on the parameters' device: an
update reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.training.pytree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params) -> dict:
    """Zero float32 moments shaped like ``params`` and an int32 step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's float32 sum of
    squares."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads times min(1, max_norm / (norm + 1e-9)), norm); new tensors."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up: ``lr * min(1, (step + 1) / warmup_steps)``, float32.
    ``adamw_update`` passes the already incremented step, as JAX does."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm.float()


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step.  Returns ``(params, opt_state, grad_norm)``: the
    same trees, updated in place, and the global norm of the unclipped
    gradients."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = opt_state["step"]
    step += 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    flat_p = leaves(params)
    flat_g, flat_m, flat_v = (leaves(t) for t in (grads, opt_state["m"],
                                                   opt_state["v"]))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("grads, moments and params of different shapes")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * scale       # autograd may hand out expanded views
        m.mul_(b1).add_(g * (1 - b1))             # b1*m + (1-b1)*g
        v.mul_(b2).add_((1 - b2) * g * g)         # b2*v + ((1-b2)*g)*g
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_(p.float().sub_(lr * delta))
    return params, opt_state, gnorm
