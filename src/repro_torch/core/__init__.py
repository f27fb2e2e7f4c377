"""RTAC core in PyTorch — the counterpart of `repro.core`."""

from .csp import (
    CSP,
    CSPBenchSpec,
    PAPER_GRID,
    coloring_csp,
    csp_from_numpy,
    make_csp,
    nqueens_csp,
    pad_domains,
    random_csp,
    sudoku_csp,
    to_paper_cons,
)
from .rtac import (
    EnforceResult,
    assign,
    einsum_support,
    enforce,
    enforce_batch,
    enforce_full,
    enforce_full_batch,
)
from .ac3 import AC3Result, assign_np, build_neighbours, enforce_ac3
from .brute import ac_closure_brute, count_solutions, solve_brute
from .engine import Engine, FrontierTable, PreparedMany, PreparedNetwork, SlotPool
from .search import (
    LockstepDriver,
    SearchStats,
    check_solution,
    mac_solve,
    resolve_engine,
    solve_many,
)

__all__ = [
    "CSP",
    "CSPBenchSpec",
    "PAPER_GRID",
    "coloring_csp",
    "csp_from_numpy",
    "make_csp",
    "nqueens_csp",
    "pad_domains",
    "random_csp",
    "sudoku_csp",
    "to_paper_cons",
    "EnforceResult",
    "assign",
    "einsum_support",
    "enforce",
    "enforce_batch",
    "enforce_full",
    "enforce_full_batch",
    "AC3Result",
    "assign_np",
    "build_neighbours",
    "enforce_ac3",
    "ac_closure_brute",
    "count_solutions",
    "solve_brute",
    "Engine",
    "FrontierTable",
    "PreparedMany",
    "PreparedNetwork",
    "SlotPool",
    "LockstepDriver",
    "SearchStats",
    "check_solution",
    "mac_solve",
    "resolve_engine",
    "solve_many",
]
