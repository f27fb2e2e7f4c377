"""Structured families: pigeonhole, n-queens, seeded Sudoku puzzles.

The PyTorch counterpart of `repro.problems.structured`: the same numpy draws
in the same order, so a seed gives byte-identical instances.

Each has a seed and a difficulty knob, so it is batched like every other
family.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.csp import CSP, coloring_csp, nqueens_csp, sudoku_csp
from repro_torch.device import Device
from . import register_problem


@register_problem(
    "pigeonhole",
    difficulty_knob="n",
    description=(
        "n pigeons into h holes (all-different on a complete graph); "
        "holes=None ⇒ h = n − 1, the classically UNSAT pigeonhole principle "
        "that resolution-style solvers need exponential search to refute"
    ),
    deterministic=True,
)
def pigeonhole(seed=0, n: int = 6, holes: Optional[int] = None,
               device: Device = "cuda") -> CSP:
    del seed  # deterministic
    h = (n - 1) if holes is None else holes
    if h < 1:
        raise ValueError(f"need at least one hole, got holes={h}")
    adj = ~np.eye(n, dtype=bool)  # complete graph: every pair of pigeons differs
    return coloring_csp(adj, h, device=device)


@register_problem(
    "nqueens",
    difficulty_knob="n",
    description="n-queens as a binary CSP (one variable per column, domain = row)",
    deterministic=True,
)
def nqueens(seed=0, n: int = 8, device: Device = "cuda") -> CSP:
    del seed  # deterministic
    return nqueens_csp(n, device=device)


def sudoku_solution_grid(seed=0) -> np.ndarray:
    """A seeded complete Sudoku grid: the canonical band pattern
    ``(3·(r mod 3) + r//3 + c) mod 9`` relabelled and shuffled by the
    validity-preserving symmetries (digit permutation, row/column permutations
    within bands/stacks, band/stack permutations). Returns (9, 9) ints 1..9."""
    rng = np.random.default_rng(seed)
    r = np.arange(9)
    base = (3 * (r[:, None] % 3) + r[:, None] // 3 + r[None, :]) % 9

    def shuffled_axis() -> np.ndarray:
        groups = rng.permutation(3)
        return np.concatenate([3 * g + rng.permutation(3) for g in groups])

    grid = base[shuffled_axis()][:, shuffled_axis()]
    digits = rng.permutation(9)
    return digits[grid] + 1


@register_problem(
    "sudoku",
    difficulty_knob="givens",
    description=(
        "seeded 9×9 Sudoku: a shuffled complete grid with `givens` clues kept "
        "(fewer givens ⇒ harder; uniqueness of the solution is not enforced)"
    ),
)
def sudoku(seed=0, givens: int = 32, device: Device = "cuda") -> CSP:
    if not 0 <= givens <= 81:
        raise ValueError(f"givens={givens} outside [0, 81]")
    rng = np.random.default_rng(seed)
    solution = sudoku_solution_grid(seed=rng)
    keep = rng.choice(81, size=givens, replace=False)
    puzzle = np.zeros((81,), dtype=int)
    puzzle[keep] = solution.reshape(-1)[keep]
    return sudoku_csp(puzzle.reshape(9, 9), device=device)
