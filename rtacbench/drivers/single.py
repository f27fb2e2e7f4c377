"""Closed loop of `mac_solve` calls: single solves, the paper's own measure.

Traffic (the cell's file): one seeded instance of the configuration's family
at a time, solved by `mac_solve` on the configuration's engine under its
assignment budget (MAC calls RTAC after every assignment: one network, one
sync a recurrence). ``instances`` distinct instances are drawn in set-up
from ``pool_seed``, so every run solves the same set (a window holds about
a dozen solves, and which instances they are would otherwise move the rate
more than the program does), and handed to the calls in an order drawn
from the run's seed, as fresh device copies. The solve running when the
window ends finishes and counts.

End to end: ``assign_rate``, MAC assignments of the window's solves over the
time from the window's start to the end of its last solve. Counters for the
readers: the rounds of the untraced solves and their time. The check replays
the window's solves (a seeded sample of ``check_solves`` where it held more)
with the plain MAC search and compares each solve's solution, exhaustion
and counts.
"""

from __future__ import annotations

import time

import numpy as np

from rtacbench.lib import instances, searches
from rtacbench.lib.harness import Outcome


class Port:
    def __init__(self, config, device):
        from repro_torch.core.csp import CSP
        from repro_torch.engines import get_engine

        self.CSP = CSP
        self.engine = get_engine(config["engine"], fixpoint=config["fixpoint"], device=device)
        self.budget = config["max_assignments"]

    def mac_solve(self, csp, budget=None):
        from repro_torch.core.search import mac_solve

        sol, st = mac_solve(self.CSP(*csp), engine=self.engine,
                            max_assignments=budget or self.budget)
        return searches.record(sol, st), st.quarantined is not None


class Control:
    def __init__(self, config, device):
        self.budget = config["max_assignments"]

    def mac_solve(self, csp, budget=None):
        return searches.control_record(csp, budget or self.budget), False


def setup(ctx):
    wl = ctx.workload
    count = wl["instances"]
    draws = searches.draws(ctx, [instances.seed_of(wl["pool_seed"], i) for i in range(count)]
                           + [instances.seed_of(ctx.seed, count)])
    pool = [instances.rb_on_device(d, ctx.device) for d in draws]
    ctx.phase("inputs")
    program = (Port if ctx.program == "port" else Control)(ctx.config, ctx.device)
    program.mac_solve(pool[count], budget=wl["warm_assignments"])  # never in the window
    return {"program": program, "pool": pool[:count], "draws": draws[:count],
            "order": np.random.default_rng(instances.seed_of(ctx.seed, 1)).permutation(count)}


def window(ctx, state) -> Outcome:
    program, pool, order = state["program"], state["pool"], state["order"]
    tracer = ctx.tracer
    t0 = time.perf_counter()
    end = t0
    solves, failed = [], 0
    rounds, untraced_s = 0, 0.0
    while time.perf_counter() - t0 < ctx.seconds:
        i = int(order[len(solves) % len(order)])
        start = time.perf_counter()
        with tracer.unit() as traced:
            with tracer.span("rtacbench.handoff"):
                csp = tuple(t.clone() for t in pool[i])
            with tracer.span("rtacbench.mac_solve"):
                rec, quarantined = program.mac_solve(csp)
        end = time.perf_counter()
        failed += quarantined
        solves.append((i, rec))
        if not traced:  # the profiler slows the host: round times leave it out
            rounds += rec[4]
            untraced_s += end - start
    wall = end - t0
    state["solves"] = solves
    assigned = sum(r[2] for _i, r in solves)
    return Outcome({"assign_rate": assigned / wall}, attempted=len(solves), failed=failed,
                   counts={"rounds": rounds, "untraced_s": untraced_s},
                   info={"solves": len(solves), "assignments": assigned,
                         "rounds": sum(r[4] for _i, r in solves), "wall_s": wall})


def release(ctx, state) -> None:
    state.pop("program", None)
    state.pop("pool", None)


def check(ctx, state, outcome):
    solves = state["solves"]
    picks = searches.sample(ctx, len(solves), ctx.workload["check_solves"], 2)
    answers = [(state["draws"][solves[p][0]], solves[p][1]) for p in picks]
    return searches.replay(answers, ctx.config["max_assignments"])
