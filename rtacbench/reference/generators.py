"""Frozen copies of the port's numpy input generators.

The benchmark makes its inputs with these, never with the port's own
generators, so a later change to the port cannot change what is measured.
Each draws exactly as its original does (a test holds them byte for byte
against the port at small sizes):

- `model_rb`: `repro_torch.problems.random_binary.model_rb` (numpy draws);
- `search_nodes`: `repro_torch.launch.distributed_ac.search_nodes`;
- `poisson_trace`: `repro_torch.service.trace.poisson_trace`.

The hashed model-A generator is in `hashed`. Model RB is also available as
its draws alone (`model_rb_draws`: the constrained pairs and their
relations), which the reference reads without the dense (n, n, d, d) array.
This module imports numpy only, so worker processes that draw instances
load no torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Model RB (Xu & Li, JAIR 2000)
# ---------------------------------------------------------------------------


def model_rb_params(n: int, alpha: float, r: float) -> Tuple[int, int, float]:
    """(dom_size d, #constraints m, critical tightness p_cr) for Model RB."""
    d = max(2, math.ceil(n**alpha))
    m = min(math.ceil(r * n * math.log(n)), n * (n - 1) // 2)
    p_cr = 1.0 - math.exp(-alpha / r)
    return d, m, p_cr


class RBDraws(NamedTuple):
    """One Model RB instance as drawn: scopes ``xs < ys`` (m,) and the
    allowed relation of each, ``rels[i][a, b]`` for x=a, y=b."""

    n: int
    d: int
    xs: np.ndarray
    ys: np.ndarray
    rels: np.ndarray  # (m, d, d) bool


def model_rb_draws(seed, n: int = 24, alpha: float = 0.8, r: float = 0.7,
                   hardness: float = 1.0, p: Optional[float] = None) -> RBDraws:
    """The draws of `model_rb`, in its order."""
    rng = np.random.default_rng(seed)
    d, m, p_cr = model_rb_params(n, alpha, r)
    if p is None:
        p = hardness * p_cr
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"tightness p={p} outside [0, 1]")
    q = int(round(p * d * d))
    iu = np.triu_indices(n, k=1)
    pick = rng.choice(len(iu[0]), size=m, replace=False)
    xs, ys = iu[0][pick], iu[1][pick]
    rels = np.empty((m, d, d), dtype=bool)
    for i in range(m):
        allowed = np.ones((d * d,), dtype=bool)
        allowed[rng.choice(d * d, size=q, replace=False)] = False
        rels[i] = allowed.reshape(d, d)
    return RBDraws(n, d, xs, ys, rels)


def model_rb_draws_job(job) -> RBDraws:
    """`model_rb_draws` of one ``(seed, knobs)`` job (a worker's unit)."""
    seed, knobs = job
    return model_rb_draws(seed, **knobs)


def rb_dense(draws: RBDraws):
    """(cons (n, n, d, d), mask (n, n), dom (n, d)) bool numpy arrays, as
    `model_rb` builds them."""
    n, d = draws.n, draws.d
    mask = np.zeros((n, n), dtype=bool)
    mask[draws.xs, draws.ys] = True
    mask |= mask.T
    cons = np.zeros((n, n, d, d), dtype=bool)
    cons[draws.xs, draws.ys] = draws.rels
    cons[draws.ys, draws.xs] = draws.rels.transpose(0, 2, 1)
    return cons, mask, np.ones((n, d), dtype=bool)


def model_rb(seed, n: int = 24, alpha: float = 0.8, r: float = 0.7,
             hardness: float = 1.0, p: Optional[float] = None):
    """Dense numpy (cons, mask, dom) of one Model RB instance."""
    return rb_dense(model_rb_draws(seed, n, alpha, r, hardness, p))


# ---------------------------------------------------------------------------
# Search nodes and arrival traces
# ---------------------------------------------------------------------------


def search_nodes(dom: np.ndarray, batch: int, seed: int = 0) -> np.ndarray:
    """``batch`` copies of the root domain (n, d), each with one random
    variable assigned one random value."""
    n, d = dom.shape
    rng = np.random.default_rng(seed)
    doms = np.repeat(dom[None], batch, axis=0)
    for i in range(batch):
        var, keep = rng.integers(n), rng.integers(d)
        doms[i, var, :] = False
        doms[i, var, keep] = True
    return doms


class TraceEvent(NamedTuple):
    """One arrival: at ``t`` seconds, family instance ``seed`` with ``knobs``."""

    t: float
    family: str
    knobs: dict
    seed: tuple


def poisson_trace(families: Sequence[str], rate: float, duration: float, seed: int,
                  variants: Dict[str, List[dict]]) -> List[TraceEvent]:
    """A seeded Poisson arrival process over ``families``; instance i is
    seeded ``(seed, i)``."""
    if rate <= 0 or duration <= 0:
        raise ValueError("poisson_trace needs rate > 0 and duration > 0")
    unknown = [f for f in families if f not in variants]
    if unknown:
        raise ValueError(f"no size variants for families {unknown}")
    rng = np.random.default_rng(seed)
    events: List[TraceEvent] = []
    t = 0.0
    for i in range(10**9):
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            break
        family = families[int(rng.integers(len(families)))]
        knobs = variants[family][int(rng.integers(len(variants[family])))]
        events.append(TraceEvent(t=t, family=family, knobs=dict(knobs), seed=(seed, i)))
    return events
