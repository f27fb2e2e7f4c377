"""Open loop into a `SolverService`: a solver service fed by independent users.

Traffic (the cell's file): Poisson arrivals at ``rate`` requests a second
over the window (`generators.poisson_trace`), each a unique seeded instance
of the configuration's family, submitted with the configuration's
assignment budget. The arrival times and the instances are drawn from
``pool_seed``, and the run's seed orders the instances over the arrivals:
every run serves the same requests at the same times, differently ordered
(which bursts a seed happens to draw would otherwise move the tail more
than the program does). Every instance is made on the device in set-up; a
request is submitted when it is due, whatever the service is doing, and the
service is stepped whenever it has work. After the window the run drains
every request that arrived in it. ``warm_requests`` other instances are
solved through the same service in set-up (kernels, slot tables, frontier
shapes), under ``warm_assignments``.

End to end: ``p95_ms``, the 95th percentile of request latency, each request
timed from when it was due to when the harness saw it finished; a request
that failed or was shed counts as missing every limit. Counters for the
readers: the service's rounds and rows dispatched over the window and the
drain, and how late each submission outside the traced slice was. The
check replays a seeded sample of ``check_requests`` of the completed
requests with the plain MAC search and compares each request's solution,
exhaustion and counts.
"""

from __future__ import annotations

import math
import time
from typing import List

import numpy as np

from rtacbench.lib import instances, searches
from rtacbench.lib.harness import Outcome
from rtacbench.reference import generators as gen


class Port:
    def __init__(self, config, wl, device):
        from repro_torch.core.csp import CSP
        from repro_torch.engines import get_engine
        from repro_torch.service import SolverService

        self.CSP = CSP
        engine = get_engine(config["engine"], fixpoint=config["fixpoint"], device=device)
        self.svc = SolverService(engine=engine, clock=time.perf_counter,
                                 initial_slots=wl["initial_slots"])

    def submit(self, csp, budget):
        return self.svc.submit(self.CSP(*csp), max_assignments=budget)

    @property
    def has_work(self) -> bool:
        return self.svc.has_work

    def step(self) -> int:
        return self.svc.step()

    @staticmethod
    def outcome(req):
        """(finished, failed, record) of a request."""
        if not req.done():
            return False, False, None
        if req.status.value != "done":
            return True, True, None
        return True, False, searches.record(req.solution, req.stats)

    def counts(self) -> dict:
        m = self.svc.metrics
        return {"svc_rounds": m.n_rounds, "svc_rows": m.rows_dispatched}


class _ControlRequest:
    def __init__(self, csp, budget):
        self.csp, self.budget, self.rec = csp, budget, None


class Control:
    """The control in the service's place: answers one queued request a
    step with the reference whose fixpoints are cut short."""

    def __init__(self, config, wl, device):
        self.queue = []

    def submit(self, csp, budget):
        req = _ControlRequest(csp, budget)
        self.queue.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    def step(self) -> int:
        req = self.queue.pop(0)
        req.rec = searches.control_record(req.csp, req.budget)
        return 1

    @staticmethod
    def outcome(req):
        return req.rec is not None, False, req.rec

    def counts(self) -> dict:
        return {}


def events(ctx) -> List[gen.TraceEvent]:
    cfg, wl = ctx.config, ctx.workload
    pool_seed = instances.seed_of(wl["pool_seed"])[0]
    trace = gen.poisson_trace([cfg["family"]], wl["rate"], ctx.seconds, seed=pool_seed,
                              variants={cfg["family"]: [searches.knobs(cfg)]})
    order = np.random.default_rng(instances.seed_of(ctx.seed, 4)).permutation(len(trace))
    return [ev._replace(seed=instances.seed_of(pool_seed, int(j)))
            for ev, j in zip(trace, order)]


def setup(ctx):
    wl, cfg = ctx.workload, ctx.config
    trace = events(ctx)
    warm = [instances.seed_of(ctx.seed, 1, i) for i in range(wl["warm_requests"])]
    draws = searches.draws(ctx, [ev.seed for ev in trace] + warm)
    csps = [instances.rb_on_device(d, ctx.device) for d in draws]
    ctx.phase("inputs")
    program = (Port if ctx.program == "port" else Control)(cfg, wl, ctx.device)
    for csp in csps[len(trace):]:
        program.submit(csp, wl["warm_assignments"])
    while program.has_work:
        program.step()
    ctx.sync()
    return {"program": program, "trace": trace, "csps": csps[:len(trace)],
            "draws": draws[:len(trace)]}


def _p95(values) -> float:
    """Nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def window(ctx, state) -> Outcome:
    program, trace, csps = state["program"], state["trace"], state["csps"]
    budget = ctx.config["max_assignments"]
    tracer = ctx.tracer
    before = program.counts()
    reqs, submitted, finished = [], [], {}
    open_reqs = []
    backlog = []  # (seconds into the window, requests in flight) after each arrival
    t0 = time.perf_counter()
    i = 0
    while i < len(trace) or open_reqs:
        now = time.perf_counter() - t0
        while i < len(trace) and trace[i].t <= now:
            with tracer.span("rtacbench.submit"):
                reqs.append(program.submit(csps[i], budget))
            submitted.append(time.perf_counter() - t0)
            open_reqs.append(i)
            backlog.append((trace[i].t, len(open_reqs)))
            i += 1
        if program.has_work:
            with tracer.unit():
                with tracer.span("rtacbench.step"):
                    retired = program.step()
            if retired:
                t = time.perf_counter() - t0
                still = []
                for r in open_reqs:
                    done, _failed, _rec = program.outcome(reqs[r])
                    if done:
                        finished[r] = t
                    else:
                        still.append(r)
                open_reqs = still
        elif i < len(trace):
            with tracer.span("rtacbench.wait_arrival"):
                time.sleep(max(0.0, trace[i].t - (time.perf_counter() - t0)))
    drained = time.perf_counter() - t0
    after = program.counts()
    results = [program.outcome(r) for r in reqs]
    failed = sum(f for _d, f, _r in results)
    latency = [math.inf if results[r][1] else 1e3 * (finished[r] - trace[r].t)
               for r in range(len(reqs))]
    p95 = _p95(latency) if latency else math.inf
    if not math.isfinite(p95):
        p95 = 1e3 * drained  # failures at the tail: the whole run is the bound
    # the profiler's start and stop stall the loop for a second or two:
    # lateness is read outside the traced slice
    late = [1e3 * (s - ev.t) for s, ev in zip(submitted, trace)
            if not tracer.traced(t0 + ev.t) and not tracer.traced(t0 + s)]
    state["results"] = results
    counts = {key: after[key] - before[key] for key in after}
    counts.update(requests=len(reqs), late_ms=late)
    # requests in flight at each arrival, averaged over each quarter of the
    # window: a backlog that grows through the window marks an overload
    quarters = [[b for t, b in backlog if q * ctx.seconds / 4 <= t < (q + 1) * ctx.seconds / 4]
                for q in range(4)]
    info = {"requests": len(reqs), "failed": failed, "drained_s": drained,
            "offered_rps": len(reqs) / ctx.seconds,
            "done_in_window": sum(t <= ctx.seconds for t in finished.values()),
            "p50_ms": _p50(latency), "p95_ms": p95,
            "in_flight_by_quarter": [float(np.mean(q)) if q else 0.0 for q in quarters]}
    return Outcome({"p95_ms": p95}, attempted=len(reqs), failed=failed, counts=counts,
                   info=info)


def _p50(values) -> float:
    ordered = sorted(values)
    return ordered[len(ordered) // 2] if ordered else math.inf


def release(ctx, state) -> None:
    state.pop("program", None)
    state.pop("csps", None)


def check(ctx, state, outcome):
    done = [r for r, (_d, failed, rec) in enumerate(state["results"]) if rec is not None]
    picks = searches.sample(ctx, len(done), ctx.workload["check_requests"], 2)
    answers = [(state["draws"][done[p]], state["results"][done[p]][2]) for p in picks]
    return searches.replay(answers, ctx.config["max_assignments"])
