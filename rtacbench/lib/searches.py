"""What the search cells share: the configuration's instances, a solve's
record as the check compares it, and the replay of solves with the plain
MAC search, on the worker processes of `pool`."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from rtacbench.reference import fixpoint as fx
from rtacbench.reference import generators as gen
from rtacbench.reference import mac

from . import control, instances, pool, roofline
from .harness import Check


def knobs(config: dict) -> dict:
    """The Model RB generator's knobs of a configuration."""
    return {k: config[k] for k in ("n", "alpha", "r", "hardness")}


def draws(ctx, seeds: Sequence) -> List[gen.RBDraws]:
    return instances.rb_draws(seeds, knobs(ctx.config))


def record(sol, st) -> tuple:
    """A port solve as the comparison reads it (`mac.Record.key`)."""
    return (sol, bool(st.exhausted), st.n_assignments, st.n_backtracks, st.rounds,
            tuple(st.recurrences))


def control_record(csp, budget) -> tuple:
    """The control's solve of a CSP handed as (cons, mask, dom)."""
    return control.solve(*csp, budget).key()


def sample(ctx, count: int, size: int, label: int) -> np.ndarray:
    """A seeded sample of ``size`` of ``count`` answers, in order."""
    rng = np.random.default_rng(instances.seed_of(ctx.seed, label))
    return np.sort(rng.choice(count, size=min(size, count), replace=False))


#: below this many solves the replays run in this process
SERIAL_BELOW = 4


def replay_job(job) -> tuple:
    """One ``(draws, got, budget, bound)`` replayed with the plain MAC search:
    (whether it differs from ``got``, and with ``bound`` the (bytes, ANDs)
    of the fused fixpoint's work for each of its requests in turn)."""
    dr, got, budget, bound = job
    net = fx.rb_network(dr)
    parts = []
    observe = None
    if bound:
        n_p, d_p, entry = roofline.padded(dr.n, dr.d)
        cols = net.ptr.diff()[None]

        def observe(seeds, rows):
            parts.append(roofline.call_bytes(
                cols, torch.zeros(rows, dtype=torch.long), seeds, n_p, d_p, entry,
                out_bytes=rows * (n_p * d_p + 1 + 4), idx_bytes=4))

    want = mac.solve(net, torch.ones((dr.n, dr.d), dtype=torch.bool), budget,
                     observe=observe)
    return want.key() != got, parts


def replay(answers, budget: int, bound: Optional[roofline.Bound] = None) -> List[Check]:
    """Replay each ``(draws, got)`` with the plain MAC search and compare.
    With ``bound``, every search's k-th request is added to the k-th call
    (a search's k-th request rides its lockstep call's k-th round)."""
    out = pool.run("rtacbench.lib.searches:replay_job",
                   [(dr, got, budget, bound is not None) for dr, got in answers],
                   SERIAL_BELOW)
    for _differs, parts in out:
        for k, part in enumerate(parts):
            bound.add(k, *part)
    mismatched = sum(differs for differs, _parts in out)
    return [Check("solves_mismatched", mismatched, 0),
            Check("solves_unchecked", 0 if answers else 1, 0)]
