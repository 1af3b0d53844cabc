#!/usr/bin/env python3
"""Device time of the port's flash-attention kernel on one GPU, warm and
cold in L2, beside one library call that computes the same function and
the bound (the larger of the bytes over the memory rate and the
operations over the tensor-core rate), at:

  * the five shapes ``chip_smoke.check_flash_attention`` measures: the
    1,024-token causal prefills of Granite-3.0-2B (H 32, H_kv 8, D 64),
    Moonlight-16B-A3B (16, 16, 128), Minitron-8B (32, 8, 128) and
    ChatGLM3-6B (32, 2, 128) in bf16, and the encoder's batch (B 32, S 256,
    H 12, D 64, full) in f32;
  * the serving engine's prompt buckets S = 128, 256 and 512 at Granite's
    and at Minitron's heads (bf16, causal);
  * S = 8,192 and 32,768 at Minitron's heads (bf16, causal), the
    registry's ``prefill_32k`` length.

    python3 flash_bench.py                 # this checkout
    python3 flash_bench.py --root DIR      # the port of another checkout
                                           # (e.g. the parent commit's)

Run one process per tree, in turns (parent, change, change, parent) in
one call, to compare two kernels on one card.  The library call is
``scaled_dot_product_attention(..., enable_gqa=True)`` on (B, H, S, D)
views of the same tensors; the port never calls it.  Prints one JSON line
per shape: ``ms`` / ``cold_ms`` (``chip_smoke.device_ms`` /
``device_ms_cold``), ``library_ms`` / ``library_cold_ms``, ``bound_ms``
and ``bound_by``, the kernel's achieved TFLOP/s, the host's time to
issue one wrapper call (``host_us``: the mean over 200 calls, 5 past
S = 4,096, with the checks, any tensor-map encoding and the launch, on
the host clock; prefill is host-bound at serving shapes), and the
largest difference between the kernel's output and the library's (both
round an f32 result to the input type once; ``chip_smoke.py`` holds the
kernel to its plain version).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: name: (B, S, H, H_kv, D, dtype, causal)
SHAPES = {
    "prefill": (1, 1024, 32, 8, 64, "bfloat16", True),
    "encoder": (32, 256, 12, 12, 64, "float32", False),
    "serve_moe": (1, 1024, 16, 16, 128, "bfloat16", True),
    "minitron": (1, 1024, 32, 8, 128, "bfloat16", True),
    "chatglm3": (1, 1024, 32, 2, 128, "bfloat16", True),
    **{f"granite_s{s}": (1, s, 32, 8, 64, "bfloat16", True)
       for s in (128, 256, 512)},
    **{f"minitron_s{s}": (1, s, 32, 8, 128, "bfloat16", True)
       for s in (128, 256, 512, 8192, 32768)},
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose src/repro_torch is timed")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    cs = _chip_smoke()
    from repro_torch.kernels.flash_attention import ops as fa

    head = {"root": str(args.root), "card": cs.nvidia_smi_line()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, s, h, h_kv, d, dt, causal) in SHAPES.items():
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda", dtype=dtype)
        k, v = (torch.randn(b, s, h_kv, d, generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_cuda(q, k, v, causal)

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        diff = float((kernel().float()
                      - library().transpose(1, 2).float()).abs().max())
        reps = 5 if s > 4096 else cs.TIMING_REPS
        pairs = s * (s + 1) // 2 if causal else s * s
        n_ops = 4 * d * pairs * b * h
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound_ms, bound_by = cs.bound(n_bytes, n_ops, dt)
        ms = cs.device_ms(kernel, reps)
        torch.cuda.synchronize()
        n_calls = 200 if s <= 4096 else 5
        t0 = time.perf_counter()
        for _ in range(n_calls):
            kernel()
        host_us = (time.perf_counter() - t0) / n_calls * 1e6
        torch.cuda.synchronize()
        print(json.dumps({
            **head, "shape": name, "dims": [b, s, h, h_kv, d], "dtype": dt,
            "causal": causal, "ms": ms,
            "cold_ms": cs.device_ms_cold(kernel, min(reps, 20)),
            "library_ms": cs.device_ms(library, reps),
            "library_cold_ms": cs.device_ms_cold(library, min(reps, 20)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": n_ops / ms * 1e-9, "host_us": host_us,
            "max_abs_diff_library": diff}), flush=True)
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
