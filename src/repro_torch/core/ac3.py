"""AC3 — the sequential propagation baseline the paper compares against (§5.1).

Queue-based arc revision (Mackworth 1977), implemented with numpy row ops (the
paper used "Python + JIT"; vectorizing each `revise` over the domain is the
comparable treatment). Counts `#Revision` — the number of `revise` calls — which
is the quantity reported in paper Table 1.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Optional

import numpy as np


class AC3Result(NamedTuple):
    dom: np.ndarray
    consistent: bool
    n_revisions: int


def build_neighbours(mask: np.ndarray) -> list:
    """Adjacency lists — the host-side 'prepared network' for AC3."""
    return [np.nonzero(mask[x])[0] for x in range(mask.shape[0])]


def enforce_ac3(
    cons: np.ndarray,  # (n, n, d, d) bool
    mask: np.ndarray,  # (n, n) bool
    dom: np.ndarray,  # (n, d) bool
    changed0: Optional[np.ndarray] = None,  # (n,) bool — seed vars (None = all)
    neighbours: Optional[list] = None,  # precomputed build_neighbours(mask)
) -> AC3Result:
    n = dom.shape[0]
    dom = dom.copy()
    if neighbours is None:
        neighbours = build_neighbours(mask)

    # Arc queue: (x, y) means "revise dom(x) against c_xy".
    queue: deque = deque()
    in_queue = np.zeros((n, n), dtype=bool)

    def push(x: int, y: int) -> None:
        if not in_queue[x, y]:
            in_queue[x, y] = True
            queue.append((x, y))

    # Seed: every arc pointing at a changed variable (all arcs for a fresh net).
    seeds = range(n) if changed0 is None else np.nonzero(changed0)[0]
    for y in seeds:
        for x in neighbours[y]:
            push(int(x), int(y))

    n_revisions = 0
    while queue:
        x, y = queue.popleft()
        in_queue[x, y] = False
        n_revisions += 1
        # revise: keep a in dom(x) iff some b in dom(y) with cons[x,y,a,b]
        supported = (cons[x, y] & dom[y][None, :]).any(axis=1)  # (d,)
        new_row = dom[x] & supported
        if new_row.sum() == 0:
            return AC3Result(dom, False, n_revisions)
        if (new_row != dom[x]).any():
            dom[x] = new_row
            for z in neighbours[x]:
                if z != y:
                    push(int(z), x)
    return AC3Result(dom, True, n_revisions)


def assign_np(dom: np.ndarray, var_idx: int, val_idx: int) -> np.ndarray:
    out = dom.copy()
    out[var_idx] = False
    out[var_idx, val_idx] = True
    return out
