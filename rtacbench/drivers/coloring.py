"""Closed loop of `solve_many` calls on graph-colouring portfolios: many
large dense not-equal networks a call, each built on the card inside it.

Traffic (the cell's file): each call colours ``batch`` graphs of the
configuration's G(n, edge_prob) with its ``k`` colours under its
assignment budget, each search asking for all children of a node in one
lockstep round or, where the configuration's ``batched_children`` is
false, for one child a round; the next call starts when the last one
returns.
``batches`` batches are drawn in set-up from ``pool_seed`` (on `lib.pool`'s
workers) and kept on the host as (n, n) adjacency; the run's seed orders
them and draws one more batch for a warm-up of ``warm_assignments``. Each
graph goes to the port as a lazy instance, a callable that builds its
network on the card (`coloring_csp`), so the call builds and prepares its
networks one at a time, inside the timed call. The call running when the
window ends finishes and counts.

End to end: ``assign_rate``, MAC assignments of the window's solves over
the time from the window's start to the end of its last call. Counters for
the readers, over the untraced calls: lockstep rounds, wall time and the
calls' preparation (`solve_many`'s ``prepare_seconds``, where the program
reports it); rows dispatched and padded over every call. The check replays
every solve of one call (in a traced run the traced call, else one drawn
from the seed) with the plain colouring MAC search and compares each
solve's solution, exhaustion and counts; the same replays give the fused
fixpoint's byte bound for the traced call. The result's ``info`` (standard
error) carries the calls' preparation, the bound, and the window's blocking
reads and lockstep rounds (the port's always-on counters ``sync.count`` and
``driver.rounds``).
"""

from __future__ import annotations

import time

import numpy as np

from rtacbench.lib import coloring, instances, roofline, searches
from rtacbench.lib.control import STEPS
from rtacbench.lib.harness import Outcome


class Port:
    def __init__(self, config, device):
        from repro_torch.engines import get_engine

        self.k = config["k"]
        self.device = device
        self.engine = get_engine(config["engine"], fixpoint=config["fixpoint"], device=device)
        self.budget = config["max_assignments"]
        self.batched = coloring.batched(config)

    def solve_many(self, batch, budget=None):
        from repro_torch.core.csp import coloring_csp
        from repro_torch.core.search import solve_many

        tel = {}
        lazy = [lambda adj=adj: coloring_csp(adj, self.k, device=self.device) for adj in batch]
        sols, stats = solve_many(lazy, engine=self.engine, max_assignments=budget or self.budget,
                                 batched_children=self.batched, telemetry=tel)
        return ([searches.record(s, st) for s, st in zip(sols, stats)],
                sum(st.quarantined is not None for st in stats), tel)


class Control:
    def __init__(self, config, device):
        self.k = config["k"]
        self.budget = config["max_assignments"]
        self.batched = coloring.batched(config)

    def solve_many(self, batch, budget=None):
        return (coloring.control_solves(batch, self.k, budget or self.budget, STEPS,
                                        self.batched), 0, {})


def setup(ctx):
    wl = ctx.workload
    b, nb = wl["batch"], wl["batches"]
    graphs = coloring.graphs([instances.seed_of(wl["pool_seed"], j, i)
                              for j in range(nb) for i in range(b)]
                             + [instances.seed_of(ctx.seed, nb, i) for i in range(b)],
                             ctx.config)
    ctx.phase("inputs")
    program = (Port if ctx.program == "port" else Control)(ctx.config, ctx.device)
    # warm up on a batch the window never sees: builds the kernels and the
    # frontier's shapes
    program.solve_many(graphs[nb * b:], budget=wl["warm_assignments"])
    pool = [graphs[j * b:(j + 1) * b] for j in range(nb)]
    return {"program": program, "pool": pool,
            "order": np.random.default_rng(instances.seed_of(ctx.seed, 1)).permutation(nb)}


#: the port's always-on counters of its blocking reads and lockstep rounds
SYNCS = ("sync.count", "driver.rounds")


def window(ctx, state) -> Outcome:
    from repro_torch.obs import REGISTRY

    program, pool, order = state["program"], state["pool"], state["order"]
    before = [REGISTRY.counter(name) for name in SYNCS]
    tracer = ctx.tracer
    t0 = time.perf_counter()
    end = t0
    solves, calls, failed = [], 0, 0
    counts = {"rounds": 0, "rows_dispatched": 0, "rows_padded": 0, "untraced_s": 0.0}
    prepare = []
    traced_call = None
    while time.perf_counter() - t0 < ctx.seconds:
        j = int(order[calls % len(order)])
        start = time.perf_counter()
        with tracer.unit() as traced:
            with tracer.span("rtacbench.solve_many"):
                recs, quarantined, tel = program.solve_many(pool[j])
        end = time.perf_counter()
        failed += quarantined
        counts["rows_dispatched"] += tel.get("rows_dispatched", 0)
        counts["rows_padded"] += tel.get("rows_padded", 0)
        if traced:
            traced_call = calls
        else:  # the profiler slows the host: round times leave traced calls out
            counts["rounds"] += tel.get("rounds", 0)
            counts["untraced_s"] += end - start
            if "prepare_seconds" in tel:
                prepare.append(tel["prepare_seconds"])
        solves.extend((calls, j, i, r) for i, r in enumerate(recs))
        calls += 1
    wall = end - t0
    counts["calls"] = calls
    if prepare:
        counts["prepare_seconds"] = sum(prepare)
    state.update(solves=solves, traced_call=traced_call)
    assigned = sum(r[2] for *_, r in solves)
    return Outcome({"assign_rate": assigned / wall}, attempted=len(solves), failed=failed,
                   counts=counts,
                   info={"calls": calls, "solves": len(solves), "assignments": assigned,
                         "wall_s": wall, "untraced_s": counts["untraced_s"],
                         "prepare_seconds": prepare,
                         "syncs": {name: REGISTRY.counter(name) - was
                                   for name, was in zip(SYNCS, before)}})


def release(ctx, state) -> None:
    state.pop("program", None)


def check(ctx, state, outcome):
    wl = ctx.workload
    solves = state["solves"]
    traced = state["traced_call"]
    call = traced
    if call is None:
        rng = np.random.default_rng(instances.seed_of(ctx.seed, 2))
        call = int(rng.integers(solves[-1][0] + 1)) if solves else 0
    answers = [(state["pool"][j][i], got) for c, j, i, got in solves if c == call]
    bound = roofline.Bound() if traced is not None else None
    checks = coloring.replay(answers, ctx.config["k"], ctx.config["max_assignments"], bound,
                             coloring.batched(ctx.config))
    if bound is not None and answers:
        outcome.counts["fixpoint_bound_s"] = bound.seconds()
        outcome.info["fixpoint_bound_s"] = outcome.counts["fixpoint_bound_s"]
    return checks
