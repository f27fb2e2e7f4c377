"""What the quasigroup-with-holes cell adds to the search cells' pieces: its
instances (drawn on `pool`'s workers, built on the device by broadcast), the
plain reference's network of an instance, and the replay of solves with the
plain MAC search, which recurses once an assignment: deeper, at order 40,
than Python's default limit allows."""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import torch

from rtacbench.reference import fixpoint as fx
from rtacbench.reference import mac
from rtacbench.reference import qwh

from . import pool, roofline
from .harness import Check

#: below this many instances or solves the jobs run in this process
SERIAL_BELOW = 2
#: the plain MAC search's recursion limit: a frame or two an assignment
RECURSION_LIMIT = 100_000


def deep_recursion() -> None:
    """Let this process's plain MAC search recurse to `RECURSION_LIMIT`."""
    sys.setrecursionlimit(max(sys.getrecursionlimit(), RECURSION_LIMIT))


def knobs(config: dict) -> dict:
    """The generator's knobs of a configuration."""
    return {k: config[k] for k in ("order", "holes", "moves")}


def draws(seeds: Sequence, knobs: dict) -> List[qwh.QWHDraws]:
    """The instances of ``seeds`` (in order), with ``knobs``."""
    return pool.run("rtacbench.reference.qwh:qwh_draws_job", [(s, knobs) for s in seeds],
                    SERIAL_BELOW)


def on_device(draws: qwh.QWHDraws, device):
    """(cons, mask, dom) of an instance on ``device``, built there by
    broadcast: the cells that share a row or a column, each such pair's
    block ``a != b``; no (n, n, d, d) array is made on the host."""
    order = draws.order
    cell = torch.arange(draws.n, device=device)
    r, c = cell // order, cell % order
    mask = (r[:, None] == r[None]) | (c[:, None] == c[None])
    mask.fill_diagonal_(False)
    ne = ~torch.eye(order, dtype=torch.bool, device=device)
    cons = mask[:, :, None, None] & ne
    return cons, mask, torch.as_tensor(qwh.root(draws), device=device)


def network(draws: qwh.QWHDraws, device="cpu") -> fx.Network:
    """The plain reference's network of an instance: `fx.network` of
    `qwh.pairs` with `qwh.block` on every pair, built from the one block
    (the pairs' own (P, d, d) copies would take 200 MB at order 40)."""
    n, d = draws.n, draws.d
    xs, ys = (torch.as_tensor(a, device=device).long() for a in qwh.pairs(draws.order))
    order = torch.argsort(ys * n + xs)
    ptr = torch.zeros(n + 1, dtype=torch.long, device=device)
    ptr[1:] = torch.cumsum(torch.bincount(ys, minlength=n), 0)
    allow = fx.pack(torch.as_tensor(qwh.block(d), device=device))
    return fx.Network(n, d, xs[order], ptr, allow.expand(xs.shape[0], d).contiguous())


def replay_job(job) -> Tuple[bool, list]:
    """One ``(draws, got, budget, bound)`` replayed with the plain MAC search
    from the instance's root domains: (whether it differs from ``got``, and
    with ``bound`` the (bytes, ANDs) of each single-network revise call the
    search needs, one a recurrence of each request)."""
    dr, got, budget, bound = job
    deep_recursion()
    net = network(dr)
    parts: list = []
    observe = None
    if bound:
        n_p, d_p, entry = roofline.padded(dr.n, dr.d)
        cols = (net.ptr[1:] - net.ptr[:-1])[None]

        def observe(seeds, rows):
            for seed in seeds:
                parts.append(roofline.call_bytes(
                    cols, torch.zeros(rows, dtype=torch.long), [seed], n_p, d_p, entry,
                    out_bytes=rows * n_p * d_p, idx_bytes=0))

    want = mac.solve(net, torch.as_tensor(qwh.root(dr)), budget, observe=observe)
    return want.key() != got, parts


def replay(answers, budget: int) -> Tuple[List[Check], roofline.Bound]:
    """Replay each ``(draws, got, traced)`` with the plain MAC search and
    compare; the bound holds the revise calls of the traced solves."""
    out = pool.run("rtacbench.lib.qwh:replay_job",
                   [(dr, got, budget, traced) for dr, got, traced in answers], SERIAL_BELOW)
    bound = roofline.Bound()
    for _differs, parts in out:
        for part in parts:
            bound.add(len(bound.parts), *part)
    mismatched = sum(differs for differs, _parts in out)
    return [Check("solves_mismatched", mismatched, 0),
            Check("solves_unchecked", 0 if answers else 1, 0)], bound
