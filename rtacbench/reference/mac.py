"""A plain MAC search (paper Alg. 2), written from the port's documented
rules, not from its code:

- the root is enforced with every variable seeded; a wiped-out root means
  no solution;
- the branching variable is the first unassigned variable of smallest
  domain in the child's closure (MRV, first index on ties); its values are
  tried in increasing order;
- all children of a node with more than one value are enforced in one
  request (frontier batching); a node with one value asks for its child
  alone, after counting the assignment;
- each value tried counts one assignment; the search stops, inconclusive
  (``exhausted``), on the assignment that passes ``max_assignments``; each
  child that wipes out or whose subtree fails counts one backtrack;
- a full assignment returns the closure's value of every variable;
- ``rounds`` counts the requests; ``recurrences`` lists, request by request,
  each enforced row's recurrence count ``k``.

The same search, with the same counts, is what `SearchStats` documents for
`mac_solve` and for every search of `solve_many` and the service.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from . import fixpoint as fx


@dataclasses.dataclass
class Record:
    """A search's outcome and counts, as the comparison reads them."""

    solution: Optional[List[int]] = None
    exhausted: bool = False
    n_assignments: int = 0
    n_backtracks: int = 0
    rounds: int = 0
    recurrences: List[int] = dataclasses.field(default_factory=list)

    def key(self):
        return (self.solution, self.exhausted, self.n_assignments, self.n_backtracks,
                self.rounds, tuple(self.recurrences))


class _Budget(Exception):
    pass


def solve(net: fx.Network, dom0: torch.Tensor, max_assignments: Optional[int] = None,
          max_steps: Optional[int] = None,
          observe: Optional[Callable[[List[torch.Tensor], int], None]] = None) -> Record:
    """MAC from the root domain ``dom0`` (n, d) bool. ``max_steps`` cuts
    every fixpoint short: the control's broken guarantee. ``observe(seeds,
    rows)`` sees each request's recurrence seeds (the benchmark's byte
    bound reads them)."""
    n, d = net.n, net.d
    dev = net.device
    rec = Record()
    assigned = torch.zeros(n, dtype=torch.bool)
    big = torch.iinfo(torch.int64).max

    def request(rows: torch.Tensor, seed: torch.Tensor, mask: torch.Tensor):
        seeds: List[torch.Tensor] = []
        out = fx.fixpoint(net, rows, seed, max_steps=max_steps,
                          on_step=None if observe is None else seeds.append)
        if observe is not None:
            observe(seeds, rows.shape[0])
        rec.rounds += 1
        k = out.k.tolist()
        rec.recurrences.extend(k)
        doms = fx.unpack(out.dom, d).cpu()
        sizes = doms.sum(dim=-1).to(torch.int64)
        sizes[:, mask] = big
        branch = sizes.argmin(dim=-1)
        return [(out.dom[i], bool(ok), int(branch[i]),
                 doms[i, int(branch[i])].nonzero().flatten().tolist())
                for i, ok in enumerate(out.consistent.tolist())]

    def children(bits: torch.Tensor, var: int, values: List[int], mask: torch.Tensor):
        rows = bits[None].repeat(len(values), 1)
        rows[:, var] = torch.tensor([1 << v for v in values], dtype=torch.int64, device=dev)
        seed = torch.zeros((len(values), n), dtype=torch.bool, device=dev)
        seed[:, var] = True
        return request(rows, seed, mask)

    def dfs(bits: torch.Tensor, var: int, values: List[int]) -> Optional[List[int]]:
        if bool(assigned.all()):
            return [int(v) for v in fx.unpack(bits, d).to(torch.int8).argmax(dim=-1).tolist()]
        mask = assigned.clone()
        mask[var] = True
        replies = children(bits, var, values, mask) if len(values) > 1 else None
        assigned[var] = True
        try:
            for i, val in enumerate(values):
                rec.n_assignments += 1
                if max_assignments and rec.n_assignments > max_assignments:
                    raise _Budget
                child = replies[i] if replies is not None else children(bits, var, [val],
                                                                        mask)[0]
                if child[1]:
                    sol = dfs(child[0], child[2], child[3])
                    if sol is not None:
                        return sol
                rec.n_backtracks += 1
            return None
        finally:
            assigned[var] = False

    root = fx.pack(torch.as_tensor(dom0, device=dev).bool())[None]
    bits, ok, var, values = request(root, torch.ones((1, n), dtype=torch.bool, device=dev),
                                    assigned.clone())[0]
    if not ok:
        return rec
    try:
        rec.solution = dfs(bits, var, values)
    except _Budget:
        rec.exhausted = True
    return rec
