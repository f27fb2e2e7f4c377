"""Graph k-coloring families: random G(n, p) graphs and Kneser graphs.

The PyTorch counterpart of `repro.problems.coloring`: the same numpy draws in
the same order, so a seed gives byte-identical instances.

Coloring maps onto the binary-CSP tensor encoding via `coloring_csp`
(one variable per vertex, domain = colors, ≠ on every edge). Two graph classes:

- ``coloring_random``: Erdős–Rényi G(n, p). The difficulty knob is the number
  of colors ``k`` — random graphs have a sharp k-colorability threshold in the
  average degree, so sweeping k (or ``edge_prob``) crosses SAT → UNSAT.
- ``coloring_kneser``: the Kneser graph K(m, j) — vertices are the j-subsets
  of {0..m−1}, edges between disjoint subsets. Its chromatic number is the
  celebrated χ = m − 2j + 2 (Lovász 1978), so ``excess`` colors relative to χ
  gives a calibrated knob: excess ≥ 0 is satisfiable, −1 provably not.
  K(5, 2) is the Petersen graph.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

from repro_torch.core.csp import CSP, coloring_csp
from repro_torch.device import Device
from . import register_problem


@register_problem(
    "coloring_random",
    difficulty_knob="k",
    description=(
        "k-coloring of an Erdős–Rényi G(n, edge_prob) graph; fewer colors / "
        "denser edges is harder"
    ),
)
def coloring_random(seed=0, n: int = 30, edge_prob: float = 0.2, k: int = 4,
                    device: Device = "cuda") -> CSP:
    """k-coloring of a seeded Erdős–Rényi G(``n``, ``edge_prob``) graph.

    Knobs: ``n`` vertices = CSP variables; ``edge_prob`` independent edge
    probability — mean degree (n−1)·edge_prob; ``k`` colors = domain size,
    the difficulty knob (the k-colorability threshold is sharp in the mean
    degree, so lowering k or raising edge_prob crosses SAT → UNSAT)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    edge = rng.random(len(iu[0])) < edge_prob
    adj = np.zeros((n, n), dtype=bool)
    adj[iu[0][edge], iu[1][edge]] = True
    adj |= adj.T
    return coloring_csp(adj, k, device=device)


def kneser_adjacency(m: int, j: int) -> np.ndarray:
    """Adjacency of K(m, j): j-subsets of an m-set, adjacent iff disjoint."""
    if not 0 < j or not 2 * j < m:
        raise ValueError(f"Kneser graph needs 0 < j and 2j < m, got m={m}, j={j}")
    verts = [frozenset(c) for c in combinations(range(m), j)]
    n = len(verts)
    adj = np.zeros((n, n), dtype=bool)
    for a in range(n):
        for b in range(a + 1, n):
            if not verts[a] & verts[b]:
                adj[a, b] = adj[b, a] = True
    return adj


@register_problem(
    "coloring_kneser",
    difficulty_knob="excess",
    description=(
        "k-coloring of the Kneser graph K(m, j) with k = χ + excess colors, "
        "χ = m − 2j + 2; excess ≥ 0 is SAT, −1 UNSAT (K(5,2) = Petersen)"
    ),
    deterministic=True,
)
def coloring_kneser(seed=0, m: int = 5, j: int = 2, excess: int = 0,
                    device: Device = "cuda") -> CSP:
    """Coloring of the Kneser graph K(``m``, ``j``) with χ + ``excess`` colors.

    Vertices are the C(m, j) j-subsets of an m-set (so the CSP has C(m, j)
    variables), edges join disjoint subsets, and χ = m − 2j + 2 exactly
    (Lovász 1978). ``excess`` is the calibrated difficulty knob: 0 gives a
    tight-but-SAT instance, −1 a provably UNSAT one, larger values are easy.
    The instance is deterministic — the seed is ignored."""
    del seed  # the graph is deterministic
    chromatic = m - 2 * j + 2
    k = chromatic + excess
    if k < 1:
        raise ValueError(f"excess={excess} leaves {k} colors")
    return coloring_csp(kneser_adjacency(m, j), k, device=device)
