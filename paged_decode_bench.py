#!/usr/bin/env python3
"""Device time of the port's paged decode-attention kernel at the main
path's two shapes (``chip_smoke.PAGED_SHAPES``: serve's and serve_plan's),
warm and cold in L2, bf16, on one GPU; and, where the tree's wrapper has a
split plan, the same kernel under other plans of the split.

    python3 paged_decode_bench.py                    # this checkout
    python3 paged_decode_bench.py --root DIR         # the port of another
                                                     # checkout (e.g. the
                                                     # parent commit's)

Two more shapes take serve_plan's apart, under the wrapper's own plan:
its 8 live rows alone (``serve_plan_live``, B=8) and its 128 slots all at
length 1 (``serve_plan_idle``).

Prints one JSON line per (shape, plan): the plan's (n_split, chunk), the
warm and cold times (``chip_smoke.device_ms`` / ``device_ms_cold``) and the
max abs error against the plain version.  Plans other than the wrapper's
own are set by replacing ``ops.split_plan`` for the call:

  dense        the dense kernel's plan (``decode_attention.ops.split_plan``:
               about 264 blocks from B and H_kv), over M*page positions
  tiles=N      a chunk of N tiles whatever B is, n_split = cdiv(M*page,
               chunk)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(cs) -> dict:
    """chip_smoke's paged shapes, then serve_plan's live rows alone and its
    slots all idle."""
    shapes = dict(cs.PAGED_SHAPES)
    b, h_kv, g, d, page, m, lengths, _ = shapes["serve_plan"]
    live = [x for x in lengths if x > 1]
    shapes["serve_plan_live"] = (len(live), h_kv, g, d, page, m, live,
                                 (4, 5))
    shapes["serve_plan_idle"] = (b, h_kv, g, d, page, m, [1] * b, (0, 1))
    return shapes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose src/repro_torch is timed")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_decode_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    cs = _chip_smoke()
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_dense_ref)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    own = getattr(pa, "split_plan", None)
    for name, shape in _shapes(cs).items():
        b, h_kv, g, d, page, m, lengths, _ = shape
        q, k, v, tables, ln = cs.paged_inputs(
            shape, torch.bfloat16, np.random.default_rng(0))
        want = paged_decode_attention_dense_ref(q, k, v, tables, ln)
        tile = da.tile_positions(d, 2)
        plans = {"own": own}
        if own is not None and name in cs.PAGED_SHAPES:
            plans["dense"] = lambda n, t: da.split_plan(b, h_kv, n, t)
            for n_tiles in (1, 2, 4, 8):
                plans[f"tiles={n_tiles}"] = (
                    lambda n, t, c=n_tiles * tile: (-(-n // c), c))
        for label, plan in plans.items():
            if plan is not None:
                pa.split_plan = plan
            try:
                got = pa.paged_decode_attention_cuda(q, k, v, tables, ln)
                torch.cuda.synchronize()
                row = {
                    "shape": name, "plan": label,
                    "n_split_chunk": (None if plan is None
                                      else plan(m * page, tile)),
                    "max_abs_err": float((got.float() - want.float())
                                         .abs().max()),
                    "ms": cs.device_ms(lambda: pa.paged_decode_attention_cuda(
                        q, k, v, tables, ln)),
                    "cold_ms": cs.device_ms_cold(
                        lambda: pa.paged_decode_attention_cuda(
                            q, k, v, tables, ln)),
                    "bound_ms": cs.paged_bound(
                        shape, tables.cpu().numpy())[0],
                    "card": card, "root": str(args.root)}
            finally:
                pa.split_plan = own
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
