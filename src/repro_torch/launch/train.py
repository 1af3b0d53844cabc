"""Training launcher: build an LM arch's parameters and run real AdamW steps
on synthetic token batches.  The counterpart of ``repro.launch.train``, on
the GPU unless ``--device cpu`` is given.

Example (reduced, CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --steps 5 --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import transformer as tr
from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore)
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_loop import init_state, make_train_step


def main(argv=None) -> tuple[dict, list[dict]]:
    """Train ``--steps`` steps (resuming from ``--ckpt``'s latest
    checkpoint); returns the state and each run step's
    ``{"step", "loss", "time"}``."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="granite-3-2b")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--reduced", action="store_true",
                   help="use the arch's reduced config (CPU-sized)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the GPU)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer's activations in the backward "
                        "pass")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise ValueError(f"{args.arch} is not a language model: the train "
                         f"launcher covers LM archs")
    cfg = arch.reduced() if args.reduced else arch.config
    print(f"[train] {arch.arch_id} ({cfg.param_count()/1e6:.1f}M params, "
          f"reduced={args.reduced})")
    params = tr.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            dtype=torch.float32, device=device)
    state = init_state(params)
    del params

    def loss_fn(p_, batch):
        return tr.loss_fn(p_, batch["tokens"], batch["labels"], cfg,
                          remat=args.remat)

    step_fn = make_train_step(loss_fn, AdamWConfig(lr=1e-3, warmup_steps=10))
    writer = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, start = restore(args.ckpt, state)
        print(f"[train] resumed from step {start}")
    data = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      args.steps - start)
    history = []
    for i, batch in enumerate(data, start=start + 1):
        t0 = time.time()
        state, m = step_fn(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()})
        loss = float(m["loss"])
        history.append({"step": i, "loss": loss, "time": time.time() - t0})
        print(f"[train] step {i} loss={loss:.4f} "
              f"({history[-1]['time']:.2f}s)")
        if writer:
            writer.save(i, state)
    if writer:
        writer.wait()
    return state, history


if __name__ == "__main__":
    main()
