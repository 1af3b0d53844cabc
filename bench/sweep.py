"""Find the highest rate an open-loop cell sustains: one process, the
engine built once, the cell's traffic offered at each rate in turn.

    python3 bench/sweep.py --workload granite-short-open --seed 7 \
        --seconds 15 --rates 6 8 10 12

For each rate: the window's requests answered a second, TTFT p50 in the
window's first and second halves and p95, and how many of the window's
requests were admitted only after it closed.  A rate is sustained while
the second half's TTFT stays near the first's and the backlog stays
small; the cell then runs at about 0.8 of the highest such rate (its
traffic file's ``rate_qps``).  Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.core import spec
    from bench.core import traffic as TR
    from bench.core import window as W
    from bench.core.cell import Driver, Obs, build
    bm = spec.load_benchmark(ROOT)
    device = torch.device("cuda")
    su = build(bm, args.workload, args.seed, args.seconds, device,
               mix_over={"rate_qps": args.rates[0]})
    Driver(Obs(args.workload, su.cfg, su.mix, args.seconds, False),
           su.server, su.engine, su.traffic, su.family, device,
           time.monotonic()).warm_up()
    for i, rate in enumerate(args.rates):
        mix = {**su.mix, "rate_qps": rate}
        # other questions at each rate: the prefix cache sees no repeats
        traffic = TR.make_traffic(mix, su.cfg["corpus"],
                                  su.cfg["model"]["vocab_size"],
                                  args.seed + i + 1, args.seconds)
        obs = Obs(args.workload, su.cfg, mix, args.seconds, False)
        drv = Driver(obs, su.server, su.engine, traffic, su.family, device,
                     time.monotonic())
        drv.run_open(args.seconds)
        reqs = sorted((r.req for r in drv.recs
                       if obs.t0 <= r.req.t_arrive < obs.t1),
                      key=lambda q: q.t_arrive)
        mid = obs.t0 + args.seconds / 2
        ttft = [q.ttft for q in reqs if q.ttft is not None]
        first = [q.ttft for q in reqs if q.ttft is not None
                 and q.t_arrive < mid]
        second = [q.ttft for q in reqs if q.ttft is not None
                  and q.t_arrive >= mid]
        stamps = [W.Stamp(q.t_arrive, q.t_first_token, q.t_done,
                          len(q.output), q.max_new_tokens, q.t_done
                          is not None) for q in reqs]
        print(json.dumps({
            "rate_qps": rate, "due": len(reqs),
            "answered_per_s": W.rate(stamps, obs.t0, obs.t1),
            "ttft_p50_first_half_s": W.quantile(first, 0.5),
            "ttft_p50_second_half_s": W.quantile(second, 0.5),
            "ttft_p95_s": W.quantile(ttft, 0.95),
            "admitted_after_close": sum(
                q.t_first_token is None or q.t_first_token >= obs.t1
                for q in reqs),
            "decode_step_ms": 1e3 * obs.stage_s.get("decode", 0.0)
            / max(1, obs.stage_n.get("decode", 0)),
            "prefill_ms": 1e3 * obs.stage_s.get("prefill", 0.0)
            / max(1, obs.stage_n.get("prefill", 0))}), flush=True)
        su.server.run_until_idle()
    return 0


if __name__ == "__main__":
    sys.exit(main())
