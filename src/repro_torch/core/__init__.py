"""RTAC core in PyTorch — the counterpart of `repro.core`."""

from .csp import CSP, csp_from_numpy, make_csp, random_csp
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
from .engine import Engine, FrontierTable, PreparedMany, PreparedNetwork
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
    "csp_from_numpy",
    "make_csp",
    "random_csp",
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
    "Engine",
    "FrontierTable",
    "PreparedMany",
    "PreparedNetwork",
    "LockstepDriver",
    "SearchStats",
    "check_solution",
    "mac_solve",
    "resolve_engine",
    "solve_many",
]
