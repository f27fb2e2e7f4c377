"""Closed loop of `solve_many` calls: workloads of many CSP solves.

Traffic (the cell's file): each call solves ``batch`` seeded instances of
the configuration's family to completion under its assignment budget; the
next call starts when the last one returns. ``batches`` distinct batches are
drawn in set-up from ``pool_seed``, so every run solves the same batches,
and handed to the calls in an order drawn from the run's seed, each call
getting fresh device copies (the port memoizes a network's preparation by
tensor identity, so a batch handed twice as the same tensors would skip
work). The call running when the window ends finishes and counts.

End to end: ``assign_rate``, MAC assignments of the window's solves over the
time from the window's start to the end of its last call. Counters for the
readers: lockstep rounds and their time (untraced calls only), rows
dispatched and padded. The check replays every solve of one call (in a
traced run the traced call, else one drawn from the seed) with the plain
MAC search, and compares each solve's solution, exhaustion and counts: one
solve for each row of the lockstep batch. The same replays give the fused
fixpoint's byte bound for the traced call.
"""

from __future__ import annotations

import time

import numpy as np

from rtacbench.lib import instances, roofline, searches
from rtacbench.lib.harness import Outcome


class Port:
    def __init__(self, config, device):
        from repro_torch.core.csp import CSP
        from repro_torch.engines import get_engine

        self.CSP = CSP
        self.engine = get_engine(config["engine"], fixpoint=config["fixpoint"], device=device)
        self.budget = config["max_assignments"]

    def solve_many(self, batch, budget=None):
        from repro_torch.core.search import solve_many

        tel = {}
        sols, stats = solve_many([self.CSP(*t) for t in batch], engine=self.engine,
                                 max_assignments=budget or self.budget, telemetry=tel)
        return ([searches.record(s, st) for s, st in zip(sols, stats)],
                sum(st.quarantined is not None for st in stats), tel)


class Control:
    def __init__(self, config, device):
        self.budget = config["max_assignments"]

    def solve_many(self, batch, budget=None):
        return [searches.control_record(t, budget or self.budget) for t in batch], 0, {}


def setup(ctx):
    wl = ctx.workload
    b, nb = wl["batch"], wl["batches"]
    draws = searches.draws(ctx, [instances.seed_of(wl["pool_seed"], j, i)
                                 for j in range(nb) for i in range(b)]
                           + [instances.seed_of(ctx.seed, nb, i) for i in range(b)])
    pool = [[instances.rb_on_device(d, ctx.device) for d in draws[j * b:(j + 1) * b]]
            for j in range(nb + 1)]
    ctx.phase("inputs")
    program = (Port if ctx.program == "port" else Control)(ctx.config, ctx.device)
    # warm up on a batch the window never sees: builds the kernels, the
    # closures and the frontier's shapes
    program.solve_many(pool[nb], budget=wl["warm_assignments"])
    return {"program": program, "pool": pool[:nb], "draws": draws[:nb * b],
            "order": np.random.default_rng(instances.seed_of(ctx.seed, 1)).permutation(nb)}


def window(ctx, state) -> Outcome:
    program, pool, order = state["program"], state["pool"], state["order"]
    tracer = ctx.tracer
    t0 = time.perf_counter()
    end = t0
    solves, calls, failed = [], 0, 0
    counts = {"rounds": 0, "rows_dispatched": 0, "rows_padded": 0, "untraced_s": 0.0}
    traced_call = None
    while time.perf_counter() - t0 < ctx.seconds:
        j = int(order[calls % len(order)])
        start = time.perf_counter()
        with tracer.unit() as traced:
            with tracer.span("rtacbench.handoff"):
                batch = [tuple(t.clone() for t in csp) for csp in pool[j]]
            with tracer.span("rtacbench.solve_many"):
                recs, quarantined, tel = program.solve_many(batch)
        end = time.perf_counter()
        del batch
        failed += quarantined
        counts["rows_dispatched"] += tel.get("rows_dispatched", 0)
        counts["rows_padded"] += tel.get("rows_padded", 0)
        if traced:
            traced_call = calls
        else:  # the profiler slows the host: round times leave traced calls out
            counts["rounds"] += tel.get("rounds", 0)
            counts["untraced_s"] += end - start
        solves.extend((calls, j, i, r) for i, r in enumerate(recs))
        calls += 1
    wall = end - t0
    counts["calls"] = calls
    state.update(solves=solves, traced_call=traced_call)
    assigned = sum(r[2] for *_, r in solves)
    return Outcome({"assign_rate": assigned / wall}, attempted=len(solves), failed=failed,
                   counts=counts, info={"calls": calls, "solves": len(solves),
                                        "assignments": assigned, "wall_s": wall})


def release(ctx, state) -> None:
    state.pop("program", None)
    state.pop("pool", None)


def check(ctx, state, outcome):
    wl = ctx.workload
    solves = state["solves"]
    traced = state["traced_call"]
    call = traced
    if call is None:
        rng = np.random.default_rng(instances.seed_of(ctx.seed, 2))
        call = int(rng.integers(solves[-1][0] + 1)) if solves else 0
    answers = [(state["draws"][j * wl["batch"] + i], got)
               for c, j, i, got in solves if c == call]
    bound = roofline.Bound() if traced is not None else None
    checks = searches.replay(answers, ctx.config["max_assignments"], bound)
    if bound is not None and answers:
        outcome.counts["fixpoint_bound_s"] = bound.seconds()
    return checks
