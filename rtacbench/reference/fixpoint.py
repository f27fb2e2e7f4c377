"""The plain incremental RTAC fixpoint (paper Eq. 1 with Prop. 2's seeds).

A straightforward implementation over a sparse form of the network: the
constrained ordered pairs (x, y), grouped by y, each with the allowed
relation as one bitset per value of x (bit b of ``allow[p, a]`` is set iff
x=a, y=b is allowed). Domains are bitsets too: ``dom[r, x]`` holds value a
in bit a (d <= 64).

One recurrence revises every row that is still active (consistent, and some
variable changed in the last step): value a of x dies iff some *seeded*
neighbour y of x offers it no support in the current domains (a Jacobi step:
every test reads the domains of the step before). A row's first seeds are
given; later seeds are the variables whose domains changed. ``k`` counts the
recurrences in which a row was active; an inactive row is left as it is.
This is the closure and the count that the configuration's guarantee
defines, computed from the definition alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

#: triples (row, seeded y, constrained x) revised at once, bounding memory
CHUNK = 1 << 20


class Network(NamedTuple):
    """A network's constrained ordered pairs, grouped by y."""

    n: int
    d: int
    pair_x: torch.Tensor  # (P,) long
    ptr: torch.Tensor  # (n + 1,) long: pairs with y == j are ptr[j]:ptr[j + 1]
    allow: torch.Tensor  # (P, d) int64 bitsets over y's values

    @property
    def device(self) -> torch.device:
        return self.pair_x.device


def pack(bools: torch.Tensor) -> torch.Tensor:
    """(..., d) bool -> (...) int64 bitsets (bit a = value a)."""
    d = bools.shape[-1]
    if d > 64:
        raise ValueError(f"domains of {d} values do not fit one 64-bit word")
    weights = torch.ones(1, dtype=torch.int64, device=bools.device) << torch.arange(
        d, device=bools.device)
    # the bits are distinct, so the sum carries nowhere and equals their OR
    return (bools.to(torch.int64) * weights).sum(dim=-1)


def unpack(bits: torch.Tensor, d: int) -> torch.Tensor:
    """(...) int64 bitsets -> (..., d) bool."""
    return ((bits[..., None] >> torch.arange(d, device=bits.device)) & 1).bool()


def network(xs, ys, blocks, n: int, device="cpu") -> Network:
    """The sparse network of ordered pairs (xs[i], ys[i]) with allowed
    relations ``blocks[i]`` (d, d) [a of x, b of y]."""
    xs = torch.as_tensor(np.asarray(xs) if not torch.is_tensor(xs) else xs,
                         device=device).long()
    ys = torch.as_tensor(np.asarray(ys) if not torch.is_tensor(ys) else ys,
                         device=device).long()
    blocks = torch.as_tensor(np.asarray(blocks) if not torch.is_tensor(blocks) else blocks,
                             device=device).bool()
    d = blocks.shape[-1]
    order = torch.argsort(ys * n + xs)
    counts = torch.bincount(ys, minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.long, device=device)
    ptr[1:] = torch.cumsum(counts, 0)
    return Network(n, d, xs[order], ptr, pack(blocks[order]))


def rb_network(draws, device="cpu") -> Network:
    """A Model RB instance's network from its draws (both orientations of
    every scope)."""
    xs = np.concatenate([draws.xs, draws.ys])
    ys = np.concatenate([draws.ys, draws.xs])
    blocks = np.concatenate([draws.rels, draws.rels.transpose(0, 2, 1)])
    return network(xs, ys, blocks, draws.n, device)


def dense_network(cons, mask, device="cpu") -> Network:
    """A network from dense (n, n, d, d) / (n, n) arrays."""
    mask = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask)
    xs, ys = mask.nonzero(as_tuple=True)
    cons = torch.as_tensor(np.asarray(cons) if not torch.is_tensor(cons) else cons)
    return network(xs, ys, cons[xs, ys], mask.shape[0], device)


def revise(net: Network, dom: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """(R, n) int64 bitsets of the values that lose support from a seeded
    neighbour this step."""
    r_n = dom.shape[0] * net.n
    dead = torch.zeros((r_n, net.d), dtype=torch.int32, device=dom.device)
    rows, ys = seed.nonzero(as_tuple=True)
    deg = net.ptr[ys + 1] - net.ptr[ys]
    owner = torch.repeat_interleave(torch.arange(ys.shape[0], device=dom.device), deg)
    if owner.numel():
        start = torch.cumsum(deg, 0) - deg
        pair = net.ptr[ys][owner] + torch.arange(owner.shape[0], device=dom.device) - start[owner]
        for c in range(0, owner.shape[0], CHUNK):
            o, p = owner[c:c + CHUNK], pair[c:c + CHUNK]
            ydom = dom[rows[o], ys[o]]
            unsupported = (net.allow[p] & ydom[:, None]) == 0  # (K, d)
            dead.index_add_(0, rows[o] * net.n + net.pair_x[p], unsupported.to(torch.int32))
    return pack(dead.view(dom.shape[0], net.n, net.d) > 0)


class Closure(NamedTuple):
    dom: torch.Tensor  # (R, n) int64 bitsets
    consistent: torch.Tensor  # (R,) bool
    k: torch.Tensor  # (R,) int32


def fixpoint(net: Network, dom: torch.Tensor, seed: torch.Tensor,
             max_steps: Optional[int] = None,
             on_step: Optional[Callable[[torch.Tensor], None]] = None) -> Closure:
    """R incremental fixpoints at once: ``dom`` (R, n) bitsets, ``seed``
    (R, n) bool. ``on_step(seeds)`` sees each recurrence's seeds (the
    benchmark's byte bound reads them). ``max_steps`` cuts the loop short:
    the control's broken guarantee, never the reference's."""
    consistent = (dom != 0).all(dim=-1)
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
        new = torch.where(active[:, None], dom & ~revise(net, dom, s), dom)
        changed = new != dom
        consistent = consistent & (new != 0).all(dim=-1)
        k += active.to(torch.int32)
        dom = new
        steps += 1
    return Closure(dom, consistent, k)
