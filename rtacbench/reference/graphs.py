"""A frozen copy of the port's G(n, p) draws (``coloring_random``,
`repro_torch.problems.coloring`): one numpy stream, one uniform draw a
vertex pair of the upper triangle in `numpy.triu_indices` order, an edge
where it falls below ``edge_prob``. A test holds them byte for byte against
the port. This module imports numpy only, so worker processes that draw
graphs load no torch.
"""

from __future__ import annotations

import numpy as np


def gnp_adjacency(seed, n: int, edge_prob: float) -> np.ndarray:
    """(n, n) bool adjacency of G(n, ``edge_prob``), symmetric, no loops."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    edge = rng.random(len(iu[0])) < edge_prob
    adj = np.zeros((n, n), dtype=bool)
    adj[iu[0][edge], iu[1][edge]] = True
    adj |= adj.T
    return adj


def gnp_adjacency_job(job) -> np.ndarray:
    """`gnp_adjacency` of one ``(seed, n, edge_prob)`` job (a worker's unit)."""
    return gnp_adjacency(*job)
