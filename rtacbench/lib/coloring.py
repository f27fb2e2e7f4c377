"""What the colouring cell adds to the search cells' pieces: its graphs
(drawn on `pool`'s workers, kept on the host as (n, n) adjacency), and the
replay of solves with the plain colouring MAC search
(`reference.coloring`), which recurses once a branching level: deeper, at
n = 1,000, than Python's default limit allows."""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from rtacbench.reference import coloring

from . import pool, roofline
from .harness import Check

#: below this many graphs or solves the jobs run in this process
SERIAL_BELOW = 4
#: the plain MAC search's recursion limit: a frame or two a level
RECURSION_LIMIT = 100_000


def deep_recursion() -> None:
    """Let this process's plain MAC search recurse to `RECURSION_LIMIT`."""
    sys.setrecursionlimit(max(sys.getrecursionlimit(), RECURSION_LIMIT))


def graphs(seeds: Sequence, config: dict) -> List[np.ndarray]:
    """The (n, n) bool adjacency of G(n, edge_prob) for each seed, in order."""
    return pool.run("rtacbench.reference.graphs:gnp_adjacency_job",
                    [(s, config["n"], config["edge_prob"]) for s in seeds], SERIAL_BELOW)


def root(adj: np.ndarray, k: int) -> torch.Tensor:
    """The root domains of colouring ``adj`` with ``k`` colours."""
    return torch.ones((adj.shape[0], k), dtype=torch.bool)


def batched(config: dict) -> bool:
    """Whether the configuration's searches ask for all children of a node
    in one request (``batched_children``, by default) or one at a time."""
    return bool(config.get("batched_children", True))


def solve_job(job) -> tuple:
    """One ``(adjacency, k, budget, max_steps, batched)`` solved with the
    plain MAC search: its `mac.Record.key`."""
    adj, k, budget, max_steps, batch = job
    deep_recursion()
    return coloring.solve(torch.as_tensor(adj), root(adj, k), budget,
                          max_steps=max_steps, batched=batch).key()


def control_solves(batch, k: int, budget: int, steps: int, batch_children: bool) -> List[tuple]:
    """The control's solves of a batch of graphs: each fixpoint cut after
    ``steps`` recurrences, on `pool`'s workers."""
    return pool.run("rtacbench.lib.coloring:solve_job",
                    [(adj, k, budget, steps, batch_children) for adj in batch], SERIAL_BELOW)


def replay_job(job) -> tuple:
    """One ``(adjacency, k, got, budget, bound, batched)`` replayed with the
    plain MAC search: (whether it differs from ``got``, and with ``bound``
    the (bytes, ANDs) of the fused fixpoint's work for each of its requests
    in turn)."""
    adj, k, got, budget, bound, batch = job
    deep_recursion()
    mask = torch.as_tensor(adj)
    parts = []
    observe = None
    if bound:
        n_p, d_p, entry = roofline.padded(adj.shape[0], k)
        cols = mask.sum(dim=0)[None]  # constrained x of each column y

        def observe(seeds, rows):
            parts.append(roofline.call_bytes(
                cols, torch.zeros(rows, dtype=torch.long), seeds, n_p, d_p, entry,
                out_bytes=rows * (n_p * d_p + 1 + 4), idx_bytes=4))

    want = coloring.solve(mask, root(adj, k), budget, observe=observe, batched=batch)
    return want.key() != got, parts


def replay(answers, k: int, budget: int, bound: Optional[roofline.Bound] = None,
           batch_children: bool = True) -> List[Check]:
    """Replay each ``(adjacency, got)`` with the plain MAC search and
    compare. With ``bound``, every search's k-th request is added to the
    k-th call (a search's k-th request rides its lockstep call's k-th
    round)."""
    out = pool.run("rtacbench.lib.coloring:replay_job",
                   [(adj, k, got, budget, bound is not None, batch_children)
                    for adj, got in answers],
                   SERIAL_BELOW)
    for _differs, parts in out:
        for i, part in enumerate(parts):
            bound.add(i, *part)
    mismatched = sum(differs for differs, _parts in out)
    return [Check("solves_mismatched", mismatched, 0),
            Check("solves_unchecked", 0 if answers else 1, 0)]
