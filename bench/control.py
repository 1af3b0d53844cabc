"""Readings that set a cell's limits: sound runs and control runs of the
cell on several seeds, in one process (the program is built anew for
each run; only the process start and the kernel library are shared).

    python3 bench/control.py --workload granite-short-open --seconds 10 \
        --seeds 11 12 13 --control-seeds 21 22 23

A sound run serves the cell as ``bench/run.py`` does; a control run
serves it through the program's int8-weight path with TF32 on, the
precision below the configuration's, which the judge has to fail.  One
JSON line a run: the numbers compared, their limits and what the judge
covered.  Not run by the benchmark's runs.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.core import spec
    from bench.core.cell import run_cell
    bm = spec.load_benchmark(ROOT)
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        result, info = run_cell(bm, args.workload, seed, args.seconds, False,
                                control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "checks": result["checks"],
                          "attempted": result["attempted"],
                          "metrics": result["metrics"],
                          "readings": info["readings"],
                          "covered": info["covered"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
