"""Graph colouring: the frozen G(n, p) draws, and a plain fixpoint and MAC
search for not-equal networks of any number of colours.

- `gnp_adjacency` (`graphs`) draws exactly as the port's
  ``coloring_random``.
- `fixpoint` is the incremental Jacobi recurrence of `fixpoint.fixpoint`
  (paper Eq. 1 with Prop. 2's seeds) specialised to colouring: a pair of
  adjacent vertices allows every pair of distinct colours, so value a of x
  loses its support from a seeded neighbour y iff dom(y) = {a}. Domains are
  bitsets of as many 32-bit words as d needs, so any d works (`fixpoint`
  packs a domain into one 64-bit word). ``k``, the seeds of each step
  (``on_step``) and ``max_steps`` are as there.
- `solve` is `mac.solve` over that fixpoint: the same branching, value
  order, frontier batching, counts and budget; with ``batched=False`` it
  asks for one child a request instead, a node's values in turn (the
  classical schedule, the port's ``batched_children=False``), which changes
  the requests and nothing else of the search.

This module imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .graphs import gnp_adjacency  # noqa: F401  (the family's draws)
from .mac import Record, _Budget


def dense(adj: np.ndarray, k: int):
    """(cons (n, n, k, k), mask (n, n), dom (n, k)) bool numpy arrays of
    colouring ``adj`` with ``k`` colours, as ``coloring_csp`` builds them."""
    n = adj.shape[0]
    mask = adj.astype(bool) & ~np.eye(n, dtype=bool)
    cons = mask[:, :, None, None] & ~np.eye(k, dtype=bool)[None, None]
    return cons, mask, np.ones((n, k), dtype=bool)


class Closure(NamedTuple):
    dom: torch.Tensor  # (R, n, d) bool
    consistent: torch.Tensor  # (R,) bool
    k: torch.Tensor  # (R,) int32


#: values a domain word holds: 32 in an int64, so no shift or product of
#: the bit tricks below reaches the sign bit
WORD = 32


def words(dom: torch.Tensor) -> torch.Tensor:
    """(..., d) bool -> (..., ceil(d/32)) int64 bitsets, value a in bit
    a % 32 of word a // 32."""
    d = dom.shape[-1]
    w = -(-d // WORD)
    padded = torch.zeros((*dom.shape[:-1], w * WORD), dtype=torch.int64, device=dom.device)
    padded[..., :d] = dom
    bits = torch.ones(1, dtype=torch.int64, device=dom.device) << torch.arange(
        WORD, device=dom.device)
    return (padded.view(*dom.shape[:-1], w, WORD) * bits).sum(dim=-1)


def bools(bits: torch.Tensor, d: int) -> torch.Tensor:
    """The inverse of `words`: (..., W) int64 -> (..., d) bool."""
    shifts = torch.arange(WORD, device=bits.device)
    return ((bits[..., None] >> shifts) & 1).bool().flatten(-2)[..., :d]


def popcount(bits: torch.Tensor) -> torch.Tensor:
    """(..., W) int64 bitsets -> (...) int64 counts of their values."""
    v = bits - ((bits >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum(dim=-1)


def revise(mask: torch.Tensor, dom: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """(R, n, W) int64: the values that lose support from a seeded
    neighbour this step, on bitset domains ``dom`` (R, n, W) with no empty
    one: value a of x where some seeded neighbour y of x has dom(y) = {a}."""
    r, n, w = dom.shape
    rows, ys = (seed & (popcount(dom) == 1)).nonzero(as_tuple=True)
    dead = torch.zeros((r * w, n), dtype=torch.int64, device=dom.device)
    if rows.numel():
        single = dom[rows, ys]  # (T, W): one bit set in one word
        word = (single != 0).to(torch.int64).argmax(dim=-1)
        bit = single.gather(1, word[:, None])[:, 0]
        # the neighbourhoods of each (row, value) forced once, then its bit
        key, inverse = torch.unique((rows * w + word) * (1 << WORD) + bit,
                                    return_inverse=True)
        hit = torch.zeros((key.shape[0], n), dtype=torch.int32, device=dom.device)
        hit.index_add_(0, inverse, mask[ys].to(torch.int32))
        dead.index_add_(0, key >> WORD, (hit > 0).to(torch.int64) * (key & 0xFFFFFFFF)[:, None])
    return dead.view(r, w, n).transpose(1, 2)


def _fixpoint(mask: torch.Tensor, dom: torch.Tensor, seed: torch.Tensor,
              max_steps: Optional[int] = None,
              on_step: Optional[Callable[[torch.Tensor], None]] = None):
    """`fixpoint` on bitset domains (R, n, W) int64; returns the bitsets."""
    consistent = (dom != 0).any(dim=-1).all(dim=-1)
    changed = seed & consistent[:, None]
    k = torch.zeros(dom.shape[0], dtype=torch.int32, device=dom.device)
    steps = 0
    while max_steps is None or steps < max_steps:
        active = consistent & changed.any(dim=-1)
        if not bool(active.any()):
            break
        s = changed & active[:, None]
        if on_step is not None:
            on_step(s)
        new = torch.where(active[:, None, None], dom & ~revise(mask, dom, s), dom)
        changed = (new != dom).any(dim=-1)
        consistent = consistent & (new != 0).any(dim=-1).all(dim=-1)
        k += active.to(torch.int32)
        dom = new
        steps += 1
    return dom, consistent, k


def fixpoint(mask: torch.Tensor, dom: torch.Tensor, seed: torch.Tensor,
             max_steps: Optional[int] = None,
             on_step: Optional[Callable[[torch.Tensor], None]] = None) -> Closure:
    """R incremental fixpoints of the colouring network ``mask`` (n, n) at
    once: ``dom`` (R, n, d) bool, ``seed`` (R, n) bool. As
    `fixpoint.fixpoint`: a row is active while it is consistent and some
    variable changed in the last step; ``k`` counts its active steps. The
    domains are bitsets inside (`words`)."""
    bits, consistent, k = _fixpoint(mask.bool(), words(dom), seed, max_steps, on_step)
    return Closure(bools(bits, dom.shape[-1]), consistent, k)


def solve(mask: torch.Tensor, dom0: torch.Tensor, max_assignments: Optional[int] = None,
          max_steps: Optional[int] = None,
          observe: Optional[Callable[[List[torch.Tensor], int], None]] = None,
          batched: bool = True) -> Record:
    """MAC on the colouring network ``mask`` (n, n) from the root domain
    ``dom0`` (n, d) bool, by `mac.solve`'s rules. ``max_steps`` cuts every
    fixpoint short: the control's broken guarantee. ``observe(seeds, rows)``
    sees each request's recurrence seeds. ``batched`` asks for all children
    of a node with more than one value in one request; without it each
    child is a request of its own, asked when its value's turn comes."""
    mask = torch.as_tensor(mask).bool()
    dom0 = torch.as_tensor(dom0).bool()
    n, d = dom0.shape
    rec = Record()
    assigned = torch.zeros(n, dtype=torch.bool)
    big = torch.iinfo(torch.int64).max

    def values_of(bits: torch.Tensor) -> List[int]:
        return bools(bits, d).nonzero().flatten().tolist()

    def request(rows: torch.Tensor, seed: torch.Tensor, amask: torch.Tensor):
        seeds: List[torch.Tensor] = []
        out, consistent, k = _fixpoint(mask, rows, seed, max_steps=max_steps,
                                       on_step=None if observe is None else seeds.append)
        if observe is not None:
            observe(seeds, rows.shape[0])
        rec.rounds += 1
        rec.recurrences.extend(k.tolist())
        sizes = popcount(out)
        sizes[:, amask] = big
        branch = sizes.argmin(dim=-1)
        return [(out[i], bool(ok), int(branch[i]), values_of(out[i, int(branch[i])]))
                for i, ok in enumerate(consistent.tolist())]

    def children(bits: torch.Tensor, var: int, values: List[int], amask: torch.Tensor):
        rows = bits[None].repeat(len(values), 1, 1)
        one = torch.zeros((len(values), d), dtype=torch.bool)
        one[torch.arange(len(values)), torch.tensor(values)] = True
        rows[:, var] = words(one)
        seed = torch.zeros((len(values), n), dtype=torch.bool)
        seed[:, var] = True
        return request(rows, seed, amask)

    def dfs(bits: torch.Tensor, var: int, values: List[int]) -> Optional[List[int]]:
        if bool(assigned.all()):
            return [int(v) for v in bools(bits, d).to(torch.int8).argmax(dim=-1).tolist()]
        amask = assigned.clone()
        amask[var] = True
        replies = children(bits, var, values, amask) if batched and len(values) > 1 else None
        assigned[var] = True
        try:
            for i, val in enumerate(values):
                rec.n_assignments += 1
                if max_assignments and rec.n_assignments > max_assignments:
                    raise _Budget
                child = replies[i] if replies is not None else children(bits, var, [val],
                                                                        amask)[0]
                if child[1]:
                    sol = dfs(child[0], child[2], child[3])
                    if sol is not None:
                        return sol
                rec.n_backtracks += 1
            return None
        finally:
            assigned[var] = False

    bits, ok, var, values = request(words(dom0)[None], torch.ones((1, n), dtype=torch.bool),
                                    assigned.clone())[0]
    if not ok:
        return rec
    try:
        rec.solution = dfs(bits, var, values)
    except _Budget:
        rec.exhausted = True
    return rec
