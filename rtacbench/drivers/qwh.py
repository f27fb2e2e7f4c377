"""Closed loop of `mac_solve` calls on quasigroup-with-holes instances: single
solves of a structured network too large for the fused fixpoint's CTA.

Traffic, clock and end-to-end metric are the single-solve cell's
(`drivers/single.py`, whose window and release run here): one instance at a
time, solved by `mac_solve` on the configuration's engine under its
assignment budget, handed over as a fresh device copy, in an order drawn
from the run's seed; ``assign_rate`` is the window's assignments over the
time to the end of its last solve. What differs is the family: set-up draws
``instances`` instances from ``pool_seed`` and a ninth from the run's seed
for a warm-up of ``warm_assignments``, on `lib.pool`'s workers (the
Jacobson-Matthews chain), and builds each on the device by broadcast, its
filled cells as singleton root domains (`lib.qwh.on_device`).

The check replays every solve of the window (a seeded sample of
``check_solves`` where it held more, and always the traced ones) with the
plain MAC search from the instance's root domains and compares each solve's
solution, exhaustion and counts. In a traced run the same replays give the
byte bound of the traced solves' single-network revise calls. The
result's ``info`` (standard error) counts the window's fixpoint calls and
revise launches by route, its blocking reads and its rounds.
"""

from __future__ import annotations

import numpy as np

from rtacbench.lib import instances, qwh, searches, spec

_single = spec.driver("single")


class Noted:
    """A program whose solves note whether the profiler traced them."""

    def __init__(self, program, tracer):
        self.program = program
        self.tracer = tracer
        self.traced = []

    def mac_solve(self, csp, budget=None):
        self.traced.append(self.tracer.active)
        return self.program.mac_solve(csp, budget)


def setup(ctx):
    wl = ctx.workload
    count = wl["instances"]
    draws = qwh.draws([instances.seed_of(wl["pool_seed"], i) for i in range(count)]
                      + [instances.seed_of(ctx.seed, count)], qwh.knobs(ctx.config))
    ctx.phase("draws")
    pool = [qwh.on_device(d, ctx.device) for d in draws[:count]]
    ctx.phase("inputs")
    if ctx.program == "port":
        program = _single.Port(ctx.config, ctx.device)
    else:
        qwh.deep_recursion()  # the control's plain MAC search
        program = _single.Control(ctx.config, ctx.device)
    program.mac_solve(qwh.on_device(draws[count], ctx.device),
                      budget=wl["warm_assignments"])  # never in the window
    return {"program": Noted(program, ctx.tracer), "pool": pool, "draws": draws[:count],
            "order": np.random.default_rng(instances.seed_of(ctx.seed, 1)).permutation(count)}


#: the port's always-on counters of the single-network path's routes, and
#: of its syncs and rounds
ROUTES = ("fixpoint.one_launch", "fixpoint.host_loop", "revise.narrow", "revise.wide",
          "sync.count", "driver.rounds")


def window(ctx, state):
    from repro_torch.obs import REGISTRY

    before = [REGISTRY.counter(name) for name in ROUTES]
    outcome = _single.window(ctx, state)
    outcome.info["routes"] = {name: REGISTRY.counter(name) - was
                              for name, was in zip(ROUTES, before)}
    state["traced"] = state["program"].traced
    return outcome


release = _single.release


def check(ctx, state, outcome):
    solves, traced = state["solves"], state["traced"]
    picks = set(searches.sample(ctx, len(solves), ctx.workload["check_solves"], 2).tolist())
    picks |= {p for p, t in enumerate(traced) if t}
    checks, bound = qwh.replay([(state["draws"][solves[p][0]], solves[p][1], traced[p])
                                for p in sorted(picks)], ctx.config["max_assignments"])
    if bound.parts:
        outcome.counts["revise_bound_s"] = bound.seconds()
    return checks
