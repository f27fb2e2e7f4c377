"""Quasigroup with holes (Achlioptas, Gomes, Kautz and Selman, "Generating
Satisfiable Problem Instances", AAAI 2000): the Latin-square completion
instances of the CSP solver competitions' QWH series, in their binary
encoding.

An instance of order N starts from a Latin square drawn by the
Jacobson-Matthews Markov chain (Jacobson and Matthews, "Generating uniformly
distributed random Latin squares", J. Combin. Des. 4, 1996), run from the
cyclic square ``(r + c) mod N`` for ``moves`` proper moves, and then empties
exactly ``holes`` cells, drawn uniformly: it is satisfiable by construction.
As a CSP it has a variable per cell (cell (r, c) is variable ``r·N + c``),
the values 0..N-1, a binary "not equal" between every two cells that share
a row or a column, and a singleton root domain at every cell left filled.

This module imports numpy only, so the worker processes that draw instances
load no torch; `pairs`, `block` and `root` are what `reference.fixpoint` and
`reference.mac` read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

#: uniform draws fetched from the generator at once by the chain
_BATCH = 1 << 14


class QWHDraws(NamedTuple):
    """One instance as drawn: the completed square and which cells stay
    filled."""

    order: int
    square: np.ndarray  # (N, N) int: the Latin square the holes were cut from
    filled: np.ndarray  # (N·N,) bool: cells that keep their value

    @property
    def n(self) -> int:
        return self.order * self.order

    @property
    def d(self) -> int:
        return self.order


def latin_square(order: int, moves: int, rng: np.random.Generator) -> np.ndarray:
    """A Latin square of ``order`` after ``moves`` proper moves of the
    Jacobson-Matthews chain from the cyclic square.

    The chain walks the square's incidence cube M[x, y, z] (1 where cell
    (x, y) holds z): from a proper cube, a cell (x, y, z) with M = 0; from an
    improper one, its -1 cell. With x', y', z' the 1s on its three lines
    (one each in a proper cube, one of two each, uniformly, in an improper
    one) the move adds 1 to (x, y, z), (x, y', z'), (x', y, z'), (x', y', z)
    and takes 1 from (x', y, z), (x, y', z), (x, y, z'), (x', y', z'); the
    cube is improper after it where (x', y', z') went to -1. A proper move is
    the walk from one proper cube to the next.

    Every line of the cube holds one 1, but the three lines through an
    improper cube's -1 cell, which hold two: the line's 1 that was there
    first, then the one the move put there. So the 1s are kept in three
    flat 2-D indexes, ``zs[x·N + y]``, ``xs[y·N + z]`` and ``ys[x·N + z]``,
    with the -1 cell's second 1s beside them, and a move rewrites twelve
    entries; a cube cell is 1 exactly where its line's index names it."""
    n = order
    zs = [(x + y) % n for x in range(n) for y in range(n)]  # (x, y) -> z with M = 1
    xs = [(z - y) % n for y in range(n) for z in range(n)]  # (y, z) -> x
    ys = [(z - x) % n for x in range(n) for z in range(n)]  # (x, z) -> y
    draws: list = []
    used = 0
    improper: Optional[Tuple[int, int, int]] = None
    z2 = x2 = y2 = 0  # the -1 cell's second 1 on each of its lines
    done = 0
    while done < moves:
        if used + 3 > len(draws):
            draws, used = rng.random(_BATCH).tolist(), 0
        u0, u1, u2 = draws[used], draws[used + 1], draws[used + 2]
        used += 3
        if improper is None:
            x, y = int(u0 * n), int(u1 * n)
            z1 = zs[x * n + y]
            z = int(u2 * (n - 1))
            z += z >= z1  # a value the cell does not hold, uniformly
            x1, y1 = xs[y * n + z], ys[x * n + z]
            # the lines through (x, y, z) keep the 1 the move puts there
            zs[x * n + y], xs[y * n + z], ys[x * n + z] = z, x, y
        else:
            x, y, z = improper
            first = xs[y * n + z]
            x1, other = (first, x2) if u0 * 2 < 1 else (x2, first)
            xs[y * n + z] = other
            first = ys[x * n + z]
            y1, other = (first, y2) if u1 * 2 < 1 else (y2, first)
            ys[x * n + z] = other
            first = zs[x * n + y]
            z1, other = (first, z2) if u2 * 2 < 1 else (z2, first)
            zs[x * n + y] = other
        zs[x * n + y1] = zs[x1 * n + y] = z1
        xs[y1 * n + z] = xs[y * n + z1] = x1
        ys[x * n + z1] = ys[x1 * n + z] = y1
        if zs[x1 * n + y1] == z1:  # M[x', y', z'] was 1: the cube is proper
            zs[x1 * n + y1], xs[y1 * n + z1], ys[x1 * n + z1] = z, x, y
            improper = None
            done += 1
        else:  # M[x', y', z'] goes to -1: each of its lines gains a second 1
            z2, x2, y2 = z, x, y
            improper = (x1, y1, z1)
    return np.array(zs, dtype=np.int64).reshape(n, n)


def qwh_draws(seed, order: int, holes: int, moves: int) -> QWHDraws:
    """The instance of ``seed``: the square after ``moves`` proper moves,
    then ``holes`` cells emptied, drawn uniformly without replacement."""
    if not 0 <= holes <= order * order:
        raise ValueError(f"holes={holes} outside [0, {order * order}]")
    rng = np.random.default_rng(seed)
    square = latin_square(order, moves, rng)
    filled = np.ones(order * order, dtype=bool)
    filled[rng.choice(order * order, size=holes, replace=False)] = False
    return QWHDraws(order, square, filled)


def qwh_draws_job(job) -> QWHDraws:
    """`qwh_draws` of one ``(seed, knobs)``, for `lib.pool`'s workers."""
    seed, knobs = job
    return qwh_draws(seed, **knobs)


def pairs(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """The constrained ordered pairs (xs, ys): every two distinct cells that
    share a row or a column, both orientations, 2·N²·(N-1) of them."""
    cell = np.arange(order * order)
    r, c = cell // order, cell % order
    same = (r[:, None] == r[None]) | (c[:, None] == c[None])
    np.fill_diagonal(same, False)
    return np.nonzero(same)


def block(order: int) -> np.ndarray:
    """The allowed relation of every constrained pair, [a of x, b of y]:
    ``a != b``."""
    return ~np.eye(order, dtype=bool)


def root(draws: QWHDraws) -> np.ndarray:
    """(n, d) bool root domains: all values at a hole, the square's value
    alone at a filled cell."""
    n, d = draws.n, draws.d
    dom = np.ones((n, d), dtype=bool)
    cells = np.nonzero(draws.filled)[0]
    dom[cells] = False
    dom[cells, draws.square.reshape(-1)[cells]] = True
    return dom
