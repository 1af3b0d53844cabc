"""Drive one cell: set-up, warm-up, the measured window, the judge.

The harness builds the program's ``RAGEngine`` behind a ``RAGServer`` and
calls ``RAGServer.submit(..., arrival_time=<due time>)`` and
``RAGServer.step()`` itself: an open loop submits each request when it is
due, whatever is in flight; a closed loop keeps one request in flight per
client.  Between steps it reads what each request served, to count the
work of every prefill and decode step (by the configuration's model
family, ``bench/blocks/<block>.py``), and the engine's stage counters at
the window's edges.  With ``trace`` it also installs the program's
``SpanTracer`` for the window and traces a slice of it on the device
(``core/trace.py``).
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench.core import judge as J
from bench.core import model as M
from bench.core import prompt as P
from bench.core import spec
from bench.core import trace as T
from bench.core import traffic as TR
from bench.core import window as W

TRACE_S = 10.0        # longest slice of the window traced on the device


@dataclass
class Obs:
    """What the metric readers read (``bench/metrics/*.py``)."""
    cell: str
    cfg: dict
    mix: dict
    seconds: float
    traced: bool
    setup_s: float = 0.0
    t0: float = 0.0                 # window start (host monotonic)
    t1: float = 0.0                 # window end
    stamps: list = field(default_factory=list)    # every request
    judged: list = field(default_factory=list)    # the window's requests
    stage_s: dict = field(default_factory=dict)   # stage seconds, window
    stage_n: dict = field(default_factory=dict)   # stage counts, window
    work: dict = field(default_factory=dict)      # counted work
    spans: list = field(default_factory=list)     # SpanTracer spans
    device_trace: dict | None = None              # trace.reduce()


class _Rec:
    """One submitted request and what the harness knows of its cache."""
    __slots__ = ("req", "n_want", "prompt_len", "appended", "n_seen",
                 "r_seen")

    def __init__(self, req, n_want, prompt_len):
        self.req, self.n_want, self.prompt_len = req, n_want, prompt_len
        self.appended = 0      # iteratively appended tokens
        self.n_seen = 0        # answer tokens seen after the last step
        self.r_seen = 0        # iterative retrievals seen


def _stage_counters(engine) -> tuple[dict, dict]:
    snap = engine.metrics_snapshot()
    hist = snap.get("histograms", {})
    return (dict(snap["stage_time_s"]),
            {k.split(":", 1)[1]: v["count"] for k, v in hist.items()
             if k.startswith("stage_seconds:")})


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b}


def _add(into: dict, parts: dict) -> None:
    for name, value in parts.items():
        into[name] = into.get(name, 0.0) + value


class Driver:
    def __init__(self, obs: Obs, server, engine, traffic, family, device,
                 t_start):
        self.obs, self.server, self.engine = obs, server, engine
        self.traffic, self.family, self.device = traffic, family, device
        self.model = obs.cfg["model"]
        self.t_start = t_start
        self.serving = obs.cfg["serving"]
        self.k = int(obs.mix["k"])
        self.doc_len = int(obs.cfg["corpus"]["doc_len"])
        self.interval = obs.mix.get("iterative_interval")
        self.budget = P.prompt_budget(self.serving)
        self.live: list[_Rec] = []
        self.recs: list[_Rec] = []
        self.in_window = False
        self.trace = None
        self.in_slice = False
        self.work = {"decode_flops": 0.0, "prefill_flops": 0.0,
                     "decode_steps": 0, "prefills": 0}
        self.stage0 = None

    # ---------------- requests ---------------------------------------------

    def submit(self, i: int, n_want: int, due: float) -> _Rec:
        q = self.traffic.questions[i % len(self.traffic.questions)]
        h = self.server.submit(q, max_new_tokens=int(n_want),
                               arrival_time=due)
        plen = min(self.k * self.doc_len + len(q), self.budget)
        rec = _Rec(h.request, h.request.max_new_tokens, plen)
        self.live.append(rec)
        self.recs.append(rec)
        return rec

    # ---------------- one step, counted -------------------------------------

    def step(self) -> bool:
        more = self.server.step()
        ctxs, prefill_lens = [], []
        still = []
        for rec in self.live:
            req = rec.req
            n0, n1 = rec.n_seen, len(req.output)
            r1 = len(req.retrieved_ids) - 1
            while rec.r_seen < r1:
                rec.r_seen += 1
                point = self.interval * rec.r_seen
                if req.retrieved_ids[rec.r_seen]:
                    rec.appended += P.append_len(
                        self.serving["s_max"],
                        rec.prompt_len + rec.appended + point - 1,
                        rec.n_want - point, self.doc_len)
            if n1 > n0:
                prefilled = n0 == 0
                if prefilled:
                    prefill_lens.append(rec.prompt_len)
                if n1 - n0 - prefilled > 0:
                    ctxs.append(rec.prompt_len + rec.appended + n1 - 1)
                rec.n_seen = n1
            if not req.done:
                still.append(rec)
        self.live = still
        self.count(ctxs, prefill_lens)
        return more

    def count(self, ctxs: list, prefill_lens: list) -> None:
        """One step's work: its FLOPs in the window, and in the traced
        slice the least time of each kernel the family's path runs (a
        step's prefills summed first, then added)."""
        w, fam, m = self.work, self.family, self.model
        if self.in_window:
            if ctxs:
                w["decode_steps"] += 1
                w["decode_flops"] += fam.decode_flops(m, ctxs)
            w["prefills"] += len(prefill_lens)
            w["prefill_flops"] += sum(fam.prefill_flops(m, n)
                                      for n in prefill_lens)
        if self.in_slice:
            if ctxs:
                _add(w, fam.decode_bounds(m, ctxs))
            step: dict = {}
            for n in prefill_lens:
                _add(step, fam.prefill_bounds(m, n))
            _add(w, step)

    # ---------------- window edges and the traced slice ---------------------

    def open_window(self, seconds: float) -> None:
        obs = self.obs
        if obs.traced:
            from repro_torch.serving.telemetry import SpanTracer
            self.server.set_tracer(SpanTracer())
        self.stage0 = _stage_counters(self.engine)
        # set-up's objects leave the collector's generations: its passes
        # in the window walk only what the window allocates
        gc.collect()
        gc.freeze()
        obs.t0 = time.monotonic()
        obs.t1 = obs.t0 + seconds
        obs.setup_s = obs.t0 - self.t_start
        # the slice: the window's last TRACE_S seconds, on to the end of the
        # loop (an open loop's wait for the window's last answers), so that
        # stopping the profiler, which takes seconds, stalls nothing judged
        self.slice_start = max(obs.t0, obs.t1 - TRACE_S)
        self.in_window = True

    def close_window(self) -> None:
        obs = self.obs
        self.in_window = False
        s0, n0 = self.stage0
        s1, n1 = _stage_counters(self.engine)
        obs.stage_s, obs.stage_n = _delta(s0, s1), _delta(n0, n1)

    def _slice_start(self, now: float) -> None:
        """Open the traced slice once; the device is profiled only on a
        CUDA device, the kernels' bounds are counted on any."""
        if (self.obs.traced and self.in_window and not self.in_slice
                and now >= self.slice_start):
            if self.device.type == "cuda":
                self.trace = T.DeviceTrace(self.device)
                self.trace.start()
            self.in_slice = True

    def stop_slice(self) -> None:
        """End the traced slice: after the loop, outside the window."""
        if self.in_slice:
            if self.trace is not None:
                self.trace.stop()
            self.in_slice = False
        self.obs.work = dict(self.work)

    # ---------------- the loops -------------------------------------------

    def warm_up(self) -> None:
        """Every shape the cell uses, before the window: each question
        length's query embedding, then a few requests served whole
        (the prefill bucket, the decode step and, with iterative
        retrieval, the appends)."""
        for n in sorted({len(q) for q in self.traffic.questions}):
            q = next(q for q in self.traffic.questions if len(q) == n)
            self.engine.retrieve(q[None], self.k)
        n_want = (self.interval + 2) if self.interval else 4
        for q in self.traffic.warmup:
            self.server.submit(q, max_new_tokens=n_want)
        self.server.run_until_idle()

    def run_open(self, seconds: float) -> None:
        mix, offs = self.obs.mix, self.traffic.offsets
        outs = self.traffic.out_lens
        t_arr0 = time.monotonic()
        start = t_arr0 + float(mix["lead_in_s"])
        i, n = 0, len(offs)
        window_recs: list[_Rec] = []
        deadline = None
        while True:
            now = time.monotonic()
            while i < n and t_arr0 + offs[i] <= now:
                due = t_arr0 + float(offs[i])
                rec = self.submit(i, outs[i], due)
                if self.obs.t0 <= due < self.obs.t1:
                    window_recs.append(rec)
                i += 1
            if deadline is None and not self.in_window and now >= start:
                self.open_window(seconds)
                continue
            if self.in_window and now >= self.obs.t1:
                self.close_window()
                deadline = now + TR.DRAIN_S
            if deadline is not None and (
                    all(r.req.done for r in window_recs) or now > deadline):
                break
            self._slice_start(now)
            if not self.step() and i < n:
                time.sleep(max(0.0, min(t_arr0 + offs[i] - time.monotonic(),
                                        0.005)))

    def run_closed(self, seconds: float) -> None:
        mix, tr_ = self.obs.mix, self.traffic
        clients = int(mix["clients"])
        per_tick = int(mix["admit_per_tick"])
        cur: list[_Rec | None] = [None] * clients
        nxt = clients
        # warm-up: clients come in a few a step, each with the residual of
        # a request already in flight
        for c in range(clients):
            cur[c] = self.submit(c, tr_.first_out_lens[c], time.monotonic())
            if (c + 1) % per_tick == 0 or c == clients - 1:
                self.step()
                nxt = self._refill(cur, nxt)
        while not all(r.req.output for r in cur):  # every client admitted
            self.step()
            nxt = self._refill(cur, nxt)
        self.open_window(seconds)
        while True:
            now = time.monotonic()
            if now >= self.obs.t1:
                self.close_window()
                return
            self._slice_start(now)
            self.step()
            nxt = self._refill(cur, nxt)

    def _refill(self, cur, nxt: int) -> int:
        """Each client whose answer came back sends its next question."""
        for c, rec in enumerate(cur):
            if rec is not None and rec.req.done:
                cur[c] = self.submit(nxt, self.traffic.out_lens[
                    nxt % len(self.traffic.out_lens)], time.monotonic())
                nxt += 1
        return nxt


def _served(rec: _Rec) -> J.Served:
    req = rec.req
    return J.Served(np.asarray(req.question), rec.n_want, list(req.output),
                    [list(r) for r in req.retrieved_ids])


@dataclass
class Setup:
    """A cell's program, built and loaded, with the inputs it was given."""
    cfg: dict
    mix: dict
    gen_w: dict
    enc_w: dict
    traffic: TR.Traffic
    engine: object
    server: object
    family: object          # the model family's module (``spec.family``)


def build(bm: dict, cell: str, seed: int, seconds: float, device,
          root=spec.ROOT, bench_dir=spec.BENCH_DIR, control: bool = False,
          mix_over: dict | None = None) -> Setup:
    """Weights and traffic from the seed, then the program's engine (which
    encodes the corpus) behind a server.  The served model is the
    configuration's model family's (``spec.family``), the encoder the
    dense one.  ``control`` serves the program's int8-weight path with
    TF32 on; ``mix_over`` overrides fields of the traffic mix (the knee
    sweep's rates)."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Component, EngineConfig, RAGEngine
    from repro_torch.serving.server import RAGServer

    wl = spec.workload(bm, cell)
    cfg = spec.load_config(bm, wl["config"], root)
    fam = spec.family(cfg, bench_dir)
    mix = {**spec.load_traffic(wl["traffic"], bench_dir), **(mix_over or {})}
    m, name = cfg["model"], wl["config"]
    enc_cfg = M.program_config(cfg["encoder"], name + "-encoder")
    gen_seed, enc_seed = M.component_seeds(seed)
    gen_w = fam.draw_weights(m, fam.program_config(m, name), gen_seed,
                             device)
    enc_w = M.draw_weights(cfg["encoder"], enc_cfg.padded_vocab, enc_seed,
                           device, dtype=torch.float32)
    traffic = TR.make_traffic(mix, cfg["corpus"], m["vocab_size"], seed,
                              seconds)
    gen_cfg, gen_params = fam.program_component(m, gen_w, name, control)
    torch.backends.cuda.matmul.allow_tf32 = control
    serving = cfg["serving"]
    ecfg = EngineConfig(
        decode_slots=serving["decode_slots"], s_max=serving["s_max"],
        page_size=serving["page_size"],
        max_new_tokens=serving["max_new_tokens"],
        iter_query_tokens=serving["iter_query_tokens"],
        retrieval_backend=cfg["retrieval"]["backend"],
        attn_impl=serving["attn_impl"], retrieval_k=int(mix["k"]),
        iterative_interval=mix.get("iterative_interval"),
        retrieval_batch=int(mix.get("retrieval_batch", 1)))
    engine = RAGEngine(Component(gen_cfg, gen_params),
                       Component(enc_cfg, tr.TransformerParams(enc_w)),
                       traffic.corpus, ecfg, device=device)
    return Setup(cfg, mix, gen_w, enc_w, traffic, engine, RAGServer(engine),
                 fam)


def run_cell(bm: dict, cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, root=spec.ROOT,
             bench_dir=spec.BENCH_DIR, control: bool = False,
             plant=None) -> tuple[dict, dict]:
    """One run of ``cell``: (the result line, what the judge covered and
    the work counted).  ``control`` serves the program's int8-weight path
    with TF32 on (the lower precision that has to fail the check);
    ``plant(engine)`` may break the engine (the tests' faults)."""
    from repro_torch.serving.request import State

    t_start = time.monotonic() if t_start is None else t_start
    device = torch.device(device)
    seed = int(seed) % (2 ** 63)
    su = build(bm, cell, seed, seconds, device, root, bench_dir, control)
    cfg, mix, gen_w, enc_w, traffic = (su.cfg, su.mix, su.gen_w, su.enc_w,
                                       su.traffic)
    engine, server, fam = su.engine, su.server, su.family
    obs = Obs(cell, cfg, mix, seconds, trace)
    if plant is not None:
        plant(engine)
    drv = Driver(obs, server, engine, traffic, fam, device, t_start)
    drv.warm_up()
    if trace and device.type == "cuda":
        T.prime(device)
    if mix["loop"] == "open":
        drv.run_open(seconds)
    else:
        drv.run_closed(seconds)
    drv.stop_slice()
    gc.unfreeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    if trace:
        obs.spans = server.tracer.spans()
    if drv.trace is not None:
        obs.device_trace = drv.trace.reduce(obs.spans)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the window's requests: open loop, those due in it; closed, those done
    # in it.  A request that ended otherwise than whole is unanswered.
    def whole(rec):
        return (rec.req.state is State.DONE
                and len(rec.req.output) == rec.n_want)
    def stamp(rec):
        req = rec.req
        return W.Stamp(req.t_arrive, req.t_first_token, req.t_done,
                       len(req.output), rec.n_want, whole(rec), req.rid)

    obs.stamps = [stamp(r) for r in drv.recs]
    if mix["loop"] == "open":
        window = [r for r in drv.recs if obs.t0 <= r.req.t_arrive < obs.t1]
    else:
        window = [r for r in drv.recs if r.req.t_done is not None
                  and obs.t0 <= r.req.t_done < obs.t1]
    obs.judged = [stamp(r) for r in window]
    unanswered = sum(not whole(r) for r in window) + sum(
        r.req.state in (State.FAILED, State.EXPIRED) for r in drv.recs
        if r not in window)
    served = [_served(r) for r in window if whole(r)]
    del su, server, engine, drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = J.judge(cfg, mix, gen_w, enc_w, traffic.corpus, served, seed,
                      device, fam.reference)
    numbers["unanswered"] = unanswered
    limits = {**mix["judge"]["limits"], "unanswered": 0}
    checks = {name: {"value": float(numbers[name]), "limit": float(lim)}
              for name, lim in limits.items()}
    # a window that answered nothing has nothing to judge: not correct
    correct = bool(window) and numbers["tokens_judged"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec.cell_metrics(bm, cell, trace):
        value = spec.metric_reader(m["name"], bench_dir)(obs)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(window),
              "failed": int(unanswered), "metrics": metrics, "device": dev}
    if trace and obs.device_trace is not None:
        dt = obs.device_trace
        dev["busy_s"] = dt["busy_s"]
        dev["window_s"] = dt["window_s"]
        result["breakdown"] = {"device_ops": T.top(dt["kernel_s"]),
                               "idle_gaps": T.top(dt["idle_by_stage"])}
    info = {"covered": {k: numbers[k] for k in
                        ("retrievals_judged", "tokens_judged",
                         "requests_sampled")},
            "readings": {k: numbers[k] for k in
                         ("logit_gap", "logit_gap_mean", "argmax_missed",
                          "retrieval_gap")},
            "submitted": len(obs.stamps), "work": obs.work,
            "stage_s": obs.stage_s}
    if obs.device_trace is not None:
        info["trace"] = {k: obs.device_trace[k] for k in
                         ("start_s", "n_events", "busy_s", "window_s")}
    result["checks"] = checks
    return result, info
