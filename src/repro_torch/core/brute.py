"""Independent brute-force oracles for tests (numpy only; the port's copy of
`repro.core.brute`).

``ac_closure_brute`` applies the *definition* of arc consistency directly with
plain Python loops (AC1-style sweep to fixpoint) — deliberately naive and
structurally unlike both RTAC and AC3, so agreement is meaningful.

``solve_brute`` enumerates complete assignments for end-to-end search tests.
"""

from __future__ import annotations

from itertools import product
from typing import List, Optional, Tuple

import numpy as np


def ac_closure_brute(
    cons: np.ndarray, mask: np.ndarray, dom: np.ndarray
) -> Tuple[np.ndarray, bool]:
    n, d = dom.shape
    dom = dom.copy()
    changed = True
    while changed:
        changed = False
        for x in range(n):
            for a in range(d):
                if not dom[x, a]:
                    continue
                for y in range(n):
                    if not mask[x, y]:
                        continue
                    has = False
                    for b in range(d):
                        if dom[y, b] and cons[x, y, a, b]:
                            has = True
                            break
                    if not has:
                        dom[x, a] = False
                        changed = True
                        break
    consistent = bool((dom.sum(axis=1) > 0).all())
    return dom, consistent


def solve_brute(
    cons: np.ndarray, mask: np.ndarray, dom: np.ndarray
) -> Optional[List[int]]:
    """First solution by exhaustive enumeration (tiny instances only)."""
    n, d = dom.shape
    choices = [list(np.nonzero(dom[x])[0]) for x in range(n)]
    for cand in product(*choices):
        ok = True
        for x in range(n):
            for y in range(x + 1, n):
                if mask[x, y] and not cons[x, y, cand[x], cand[y]]:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return list(cand)
    return None


def count_solutions(cons: np.ndarray, mask: np.ndarray, dom: np.ndarray) -> int:
    n, d = dom.shape
    choices = [list(np.nonzero(dom[x])[0]) for x in range(n)]
    count = 0
    for cand in product(*choices):
        ok = True
        for x in range(n):
            for y in range(x + 1, n):
                if mask[x, y] and not cons[x, y, cand[x], cand[y]]:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            count += 1
    return count
