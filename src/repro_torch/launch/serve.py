"""Serving launcher: stand up the RAG engine with a chosen generative arch
(its reduced config) and serve a synthetic request stream.  The
counterpart of ``repro.launch.serve``, on the GPU unless ``--device cpu``
is given.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --requests 6 --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import topical_corpus
from repro_torch.models import transformer as tr
from repro_torch.serving.engine import Component, EngineConfig, RAGEngine
from repro_torch.serving.request import Request


def main(argv=None) -> list[Request]:
    """Serve ``--requests`` questions; returns the finished requests."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="granite-3-2b")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--iterative", type=int, default=0,
                   help="retrieval interval in tokens (0 = single retrieval)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the GPU)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise ValueError(f"{args.arch} is not a language model")
    gen_cfg = arch.reduced()
    gen = Component(gen_cfg, tr.init_params(
        gen_cfg, torch.Generator(device=device).manual_seed(0)))
    enc_cfg = tr.TransformerConfig(
        name="encoder", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_head=16, d_ff=64, vocab_size=gen_cfg.vocab_size, causal=False)
    enc = Component(enc_cfg, tr.init_params(
        enc_cfg, torch.Generator(device=device).manual_seed(1)))
    corpus, topics, make_q = topical_corpus(64, 10, gen_cfg.vocab_size,
                                            n_topics=4)
    engine = RAGEngine(gen, enc, corpus, EngineConfig(
        decode_slots=4, s_max=128, max_new_tokens=8,
        iterative_interval=args.iterative or None,
        retrieval_batch=2 if args.iterative else 1), device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(question=make_q(int(rng.integers(0, 4))))
            for _ in range(args.requests)]
    t0 = time.time()
    done = engine.serve(reqs)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {arch.arch_id} (reduced): {len(done)} requests, "
          f"{toks} tokens in {dt:.1f}s; metrics={engine.metrics}")
    return done


if __name__ == "__main__":
    main()
