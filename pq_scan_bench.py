#!/usr/bin/env python3
"""Device time of the port's PQ-scan kernel at the two shapes
``chip_smoke.py`` measures -- one serve search (8 probed lists of 104
codes, 8 sub-quantizers) and the retrieve_scale search (32 queries x nprobe
8 over ``chip_smoke.synthetic_index``, 21,015,324 vectors in 4,096 lists,
96-byte codes) -- and of the whole IVF-PQ search at the second, on one
GPU.

    python3 pq_scan_bench.py                 # this checkout
    python3 pq_scan_bench.py --root DIR      # the port of another checkout
                                             # (e.g. the parent commit's)

A tree whose wrapper has ``pq_scan_lists`` scans the probed lists where
they lie; an older tree scans them after ``list_codes[probe]`` has
gathered them, as its ``search`` does (``gather_scan_ms`` times the two
together).  Prints one JSON line per shape: the kernel warm and cold in L2
(``chip_smoke.device_ms`` / ``device_ms_cold``), bit-equal to the plain
version, and at the scale shape the search's device time (calls replayed
in a CUDA graph) and wall time (host clock to its result on the host),
and, where the tree's wrapper plans its split (``ops.scan_plan``), the
kernel under 1, 2, 4 and 8 splits of each row (``split_ms``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


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
    if not torch.cuda.is_available():
        print("pq_scan_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    cs = _chip_smoke()
    from repro_torch.kernels.pq_scan import ops as pq
    from repro_torch.kernels.pq_scan.ref import pq_scan_ref
    from repro_torch.retrieval import ivf_pq
    from repro_torch.retrieval.exact import top_k

    card = cs.nvidia_smi_line()
    in_place = hasattr(pq, "pq_scan_lists_cuda")
    head = {"root": str(args.root), "in_place": in_place, "card": card}

    # one serve search: (nprobe, list_len, S) as chip_smoke.check_pq_scan
    rng = np.random.default_rng(1)
    lut = torch.tensor(rng.standard_normal((8, 8, 256)),
                       dtype=torch.float32, device="cuda")
    codes = torch.tensor(rng.integers(0, 256, (8, 104, 8)),
                         dtype=torch.uint8, device="cuda")
    if not torch.equal(pq.pq_scan_cuda(lut, codes), pq_scan_ref(lut, codes)):
        raise AssertionError("pq_scan at serve's shape is not bit-equal")
    print(json.dumps({**head, "shape": "serve", "dims": [8, 104, 8],
                      "ms": cs.device_ms(lambda: pq.pq_scan_cuda(lut, codes)),
                      "cold_ms": cs.device_ms_cold(
                          lambda: pq.pq_scan_cuda(lut, codes))}), flush=True)

    # the retrieve_scale search
    index = cs.synthetic_index(seed=0)
    queries = torch.randn(cs.SCALE_QUERIES, cs.SCALE_DIM, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    c2 = torch.sum(index.centroids ** 2, dim=-1)
    _, probe = top_k(-(c2[None] - 2.0 * queries @ index.centroids.T),
                     cs.SCALE_NPROBE)
    tables = ivf_pq.adc_tables(index, queries, index.centroids[probe])
    lut = tables.reshape(-1, cs.SCALE_SUBQ, 256).contiguous()
    rows = probe.reshape(-1).int()
    b, ll = lut.shape[0], index.list_codes.shape[1]

    def gather_scan():
        return pq.pq_scan_cuda(lut, index.list_codes[probe].reshape(
            b, ll, cs.SCALE_SUBQ))

    if in_place:
        def scan():
            return pq.pq_scan_lists_cuda(lut, index.list_codes, rows)
    else:
        gathered = index.list_codes[probe].reshape(b, ll, cs.SCALE_SUBQ)

        def scan():
            return pq.pq_scan_cuda(lut, gathered)
    got = scan()
    if not torch.equal(got, pq_scan_ref(lut, index.list_codes[probe.reshape(
            -1)])):
        raise AssertionError("pq_scan at the scale shape is not bit-equal")
    del got

    def search():
        return ivf_pq.search(index, queries, cs.SCALE_NPROBE, cs.SCALE_K,
                             use_kernel=True)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = search()
        d.cpu(), i.cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    plans = {}
    if hasattr(pq, "scan_plan"):            # the kernel under other splits
        own = pq.scan_plan
        for n_split in (1, 2, 4, 8):
            tiles = -(-(-(-ll // pq.TILE)) // n_split)
            pq.scan_plan = (lambda *_, t=tiles: (-(-ll // (t * pq.TILE)),
                                                 t * pq.TILE, cs.SCALE_SUBQ))
            plans[n_split] = cs.device_ms(scan, reps=20)
        pq.scan_plan = own
    print(json.dumps({
        **head, "shape": "retrieve_scale", "dims": [b, ll, cs.SCALE_SUBQ],
        "plan": pq.scan_plan(b, ll, cs.SCALE_SUBQ) if plans else None,
        "split_ms": plans,
        "ms": cs.device_ms(scan, reps=20),
        "cold_ms": cs.device_ms_cold(scan),
        "gather_scan_ms": None if in_place else cs.device_ms(gather_scan,
                                                             reps=10),
        "search_ms": cs.device_ms(search, reps=10),
        "search_wall_ms": sorted(walls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
