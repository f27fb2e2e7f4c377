"""Quasigroup with holes through the port's normal path.

The benchmark's generator (`rtacbench/reference/qwh.py`: the
Jacobson-Matthews chain, then the holes) gives Latin-square completion
instances; `mac_solve` on the Hopper engines and on `einsum` must equal the
benchmark's plain MAC search on them exactly, and the single-network path's
two shape gates must keep the order-40 shape (n_p = 1,600, d_p = 40) off the
fused kernel and on the wide revise (the word loop's on a fused packed
engine, the host loop's elsewhere). On the CPU each kernel wrapper computes its
plain version, so the gates are tested on the shapes alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.csp import CSP
from repro_torch.core.search import mac_solve
from repro_torch.engines import get_engine
from repro_torch.kernels import launch, ops
from rtacbench.lib import qwh as lib_qwh
from rtacbench.lib import searches
from rtacbench.reference import fixpoint as fx
from rtacbench.reference import mac
from rtacbench.reference import qwh

CPU = torch.device("cpu")

#: (seed, order, holes): orders 6-9; at the benchmark's hole fraction, 42 %,
#: the small orders solve without a backtrack, so the last three have more
#: holes (56-64 %): 38 backtracks at order 8, 123 at order 9, and at order 9
#: a search that stops on its budget of 300 assignments
INSTANCES = [(11, 6, 15), (12, 7, 21), (13, 9, 34), (0, 8, 36), (0, 9, 52), (0, 9, 48)]


def _draws(seed, order, holes):
    return qwh.qwh_draws(seed, order, holes, moves=order ** 3)


@pytest.mark.parametrize("seed,order,holes", INSTANCES)
def test_generator_draws_a_latin_square_with_exactly_its_holes(seed, order, holes):
    """The chain's square is Latin, exactly ``holes`` cells are empty, the
    filled cells' root domains are their values alone, and the same seed
    gives the same arrays."""
    dr = _draws(seed, order, holes)
    assert dr.square.shape == (order, order)
    for line in (*dr.square, *dr.square.T):
        assert sorted(line.tolist()) == list(range(order))
    assert int((~dr.filled).sum()) == holes
    dom = qwh.root(dr)
    assert (dom.sum(-1) == np.where(dr.filled, 1, order)).all()
    assert (dom[np.arange(dr.n), dr.square.reshape(-1)]).all()
    again = _draws(seed, order, holes)
    assert (again.square == dr.square).all() and (again.filled == dr.filled).all()
    other = _draws(seed + 100, order, holes)
    assert (other.square != dr.square).any() or (other.filled != dr.filled).any()


def test_generator_moves_away_from_the_cyclic_square():
    """A chain of N³ proper moves leaves the cyclic square it starts from."""
    order = 8
    cyclic = (np.arange(order)[:, None] + np.arange(order)[None]) % order
    assert (qwh.latin_square(order, 0, np.random.default_rng(0)) == cyclic).all()
    assert (qwh.latin_square(order, order ** 3, np.random.default_rng(0)) != cyclic).any()


@pytest.mark.parametrize("order", [4, 7])
def test_networks_of_the_device_build_and_the_reference_agree(order):
    """The broadcast build (`lib.qwh.on_device`) constrains exactly the pairs
    `qwh.pairs` lists, each with `qwh.block`; the reference's network from
    the one block equals `fixpoint.network` over the pairs' own blocks."""
    dr = _draws(3, order, order)
    cons, mask, dom = lib_qwh.on_device(dr, CPU)
    xs, ys = qwh.pairs(order)
    assert len(xs) == 2 * order * order * (order - 1)
    want = np.zeros((dr.n, dr.n), dtype=bool)
    want[xs, ys] = True
    assert (mask.numpy() == want).all()
    assert (cons[xs, ys].numpy() == qwh.block(order)).all()
    assert not cons[~mask].any()
    assert (dom.numpy() == qwh.root(dr)).all()
    blocks = np.broadcast_to(qwh.block(order), (len(xs), order, order)).copy()
    got, ref = lib_qwh.network(dr), fx.network(xs, ys, blocks, dr.n)
    assert (got.n, got.d) == (ref.n, ref.d)
    for a, b in zip(got[2:], ref[2:]):
        assert torch.equal(a, b)


ENGINES = [("einsum", None), ("hopper_packed", "fused"), ("hopper_packed", "stepped"),
           ("hopper_dense", "fused")]


@pytest.mark.parametrize("name,fixpoint", ENGINES)
@pytest.mark.parametrize("seed,order,holes", INSTANCES)
def test_mac_solve_equals_the_plain_search(seed, order, holes, name, fixpoint):
    """`mac_solve` on seeded QWH instances equals the benchmark's plain MAC
    search from the same root domains: solution, exhaustion, assignments,
    backtracks, rounds and every row's k."""
    dr = _draws(seed, order, holes)
    kw = {} if fixpoint is None else {"fixpoint": fixpoint}
    engine = get_engine(name, device=CPU, **kw)
    sol, st = mac_solve(CSP(*lib_qwh.on_device(dr, CPU)), engine=engine, max_assignments=300)
    want = mac.solve(lib_qwh.network(dr), torch.as_tensor(qwh.root(dr)), 300)
    assert searches.record(sol, st) == want.key()
    assert st.n_assignments > 0 and st.rounds > 0
    if sol is not None:
        grid = np.asarray(sol).reshape(order, order)
        for line in (*grid, *grid.T):
            assert sorted(line.tolist()) == list(range(order))
        assert (grid.reshape(-1)[dr.filled] == dr.square.reshape(-1)[dr.filled]).all()


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("n_p,d_p,fused,wide", [
    (104, 40, True, False),  # rb100-40: one launch of the fused kernel a call
    (300, 40, True, False),  # the narrow CTA owning a row still fits
    (1224, 40, False, True),  # above the fused CTA: the host loop, the wide revise
    (1600, 40, False, True),  # QWH order 40
    (4096, 32, False, True),  # the production CSP
])
def test_single_network_routes_follow_the_padded_shape(kind, n_p, d_p, fused, wide):
    """`ops.single_fused` and `launch.single_wide`: the fused kernel where its
    CTA fits below n = 2048; else the host loop, whose revise takes the wide
    launch from n = 2048 or where a narrow CTA owning a row would not fit."""
    assert ops.single_fused(kind, n_p, d_p) is fused
    assert launch.single_wide(n_p, d_p) is wide
    assert wide == (n_p >= launch.SINGLE_WIDE_N
                    or launch.single_revise_smem(n_p, d_p) > launch.SMEM_OPT_IN_LIMIT)


def test_mac_solve_nests_deeper_than_the_default_recursion_limit():
    """The search nests a generator a branching level: at order 40 a solve
    goes more than 1,000 levels deep (every filled cell is a level), past
    Python's default recursion limit. Here 1,500 unconstrained variables,
    each with one value, on the host engine: 1,500 levels. The limit is
    back where it was once the search has ended."""
    import sys

    n = 1500
    dom = torch.zeros((n, 2), dtype=torch.bool)
    dom[:, 1] = True
    csp = CSP(torch.zeros((n, n, 2, 2), dtype=torch.bool), torch.zeros((n, n), dtype=torch.bool),
              dom)
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(1000)
    try:
        sol, st = mac_solve(csp, engine=get_engine("ac3", device=CPU))
        after = sys.getrecursionlimit()
    finally:
        sys.setrecursionlimit(old)
    assert after == 1000  # raised for the search only
    assert sol == [1] * n
    assert (st.n_assignments, st.n_backtracks, st.rounds) == (n, 0, n + 1)


@pytest.mark.parametrize("name,budget", [("hopper_packed", 30), ("hopper_packed", None),
                                         ("einsum", 30)])
def test_a_finished_mac_solve_lets_its_network_go_without_the_cycle_collector(name, budget):
    """Once `mac_solve` returns, solved or stopped on its budget, nothing of
    the search holds the CSP: at order 40 each solve's network is 3.8 GiB
    on the card, and a reference cycle left for the collector kept up to
    ten of them alive at once."""
    import gc
    import weakref

    cons, mask, dom = lib_qwh.on_device(qwh.qwh_draws(0, 9, 48, moves=729), CPU)
    ref = weakref.ref(cons)
    was = gc.isenabled()
    gc.disable()
    try:
        _sol, st = mac_solve(CSP(cons, mask, dom), engine=get_engine(name, device=CPU),
                             max_assignments=budget)
        del cons, mask, dom
        assert ref() is None
    finally:
        if was:
            gc.enable()
    assert st.exhausted == (budget is not None)
