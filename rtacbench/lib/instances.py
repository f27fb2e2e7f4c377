"""Making a cell's instances in set-up.

Model RB's draws are numpy's and slow (about 14 ms an frb100-40 instance,
most of it in `numpy.random.Generator.choice`), so a pool of instances is
drawn by a few worker processes (`pool`) that import numpy and the frozen
generator only, and touch no device. Each instance then lands on the device
in one scatter (`rb_on_device`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from rtacbench.reference import generators as gen

from . import pool

#: below this many instances the draws run in this process
SERIAL_BELOW = 16


def rb_draws(seeds: Sequence, knobs: dict) -> List[gen.RBDraws]:
    """Model RB draws of each seed (in order), with ``knobs``."""
    return pool.run("rtacbench.reference.generators:model_rb_draws_job",
                    [(s, knobs) for s in seeds], SERIAL_BELOW)


def rb_on_device(draws: gen.RBDraws, device):
    """(cons, mask, dom) of one instance on ``device``, equal to
    `generators.rb_dense`."""
    n, d = draws.n, draws.d
    xs = torch.as_tensor(draws.xs, device=device)
    ys = torch.as_tensor(draws.ys, device=device)
    rels = torch.as_tensor(draws.rels, device=device)
    mask = torch.zeros((n, n), dtype=torch.bool, device=device)
    mask[xs, ys] = True
    mask[ys, xs] = True
    cons = torch.zeros((n, n, d, d), dtype=torch.bool, device=device)
    cons[xs, ys] = rels
    cons[ys, xs] = rels.transpose(1, 2)
    return cons, mask, torch.ones((n, d), dtype=torch.bool, device=device)


def seed_of(*parts) -> tuple:
    """A numpy seed from the run's seed and a label; numpy takes
    non-negative ints, so the run's seed is taken modulo 2**63."""
    return tuple(int(p) % (1 << 63) for p in parts)
