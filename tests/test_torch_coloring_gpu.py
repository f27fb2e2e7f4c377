"""Colouring at the benchmark cell's shape on the card: G(1000, 0.5) at 83
colours, n_p = 1000, d_p = 88, W = 3.

- kernel 1 (`packed_fixpoint_stacked`, its run-time-W instantiation) on 32
  search nodes of 32 distinct slots, bit for bit its plain version, a CTA a
  row and each row split over a cluster of 2, 4 and 8 CTAs and as
  `launch.fixpoint_split` picks;
- ``fixpoint.split_launches`` ticks once a round of a two-graph `solve_many`
  at the cell's shape, and never at rb100-40's (`solve_many`, `mac_solve`);
- `solve_many` on four lazy instances against the benchmark's plain
  colouring MAC search (`rtacbench/reference/coloring`), within the memory
  of the tables and two instances' dense networks.

Marked ``gpu``; without a CUDA device every test skips. On the card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_coloring_gpu.py``.
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import coloring_csp, mac_solve, solve_many
from repro_torch.engines import get_engine
from repro_torch.kernels import bitpack_support as bs, launch, ops
from repro_torch.problems import generate
from rtacbench.reference import coloring as ref_coloring

pytestmark = pytest.mark.gpu


def _adjacency(seed, n, p):
    return ref_coloring.gnp_adjacency(seed, n, p)


#: the cell's configuration: G(1000, 0.5) at 83 colours (n_p, d_p, W =
#: 1000, 88, 3)
N, P, K = 1000, 0.5, 83


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _search_row(adj, rng, k=K):
    """A search node of colouring ``adj`` with ``k`` colours: a greedy
    partial colouring as large as leaves its closure consistent (the plain
    reference's fixpoint; at most 4/5 of the vertices), then one more
    variable assigned, the value that most of its neighbours of two or three
    values hold, seeded alone; every fourth row is a root instead, the
    partial colouring seeded unpropagated."""
    mask = torch.as_tensor(adj)
    n = adj.shape[0]
    m = 4 * n // 5
    while True:
        col = -np.ones(n, dtype=np.int64)
        for v in rng.permutation(n)[:m]:
            used = np.zeros(k, dtype=bool)
            used[col[adj[v] & (col >= 0)]] = True
            free = np.nonzero(~used)[0]
            if free.size:
                col[v] = free[int(rng.integers(min(3, free.size)))]
        fixed = np.nonzero(col >= 0)[0]
        dom = torch.ones((n, k), dtype=torch.bool)
        dom[fixed] = False
        dom[fixed, col[fixed]] = True
        seed = torch.zeros(n, dtype=torch.bool)
        seed[fixed] = True
        out = ref_coloring.fixpoint(mask, dom[None], seed[None])
        if bool(out.consistent[0]):
            break
        m = int(m * 0.95)
    if rng.integers(4) == 0:
        return dom, seed
    closure = out.dom[0].clone()
    size = closure.sum(dim=-1)
    small = (closure & ((size >= 2) & (size <= 3))[:, None]).to(torch.int32)
    score = (mask.to(torch.int32) @ small) * closure
    score[size < 2] = -1
    v, a = divmod(int(score.argmax()), k)
    if score[v, a] <= 0:  # no such neighbours: the first value of a smallest domain
        v = int(torch.where(size < 2, k + 1, size).argmin())
        a = int(closure[v].nonzero()[0])
    closure[v] = False
    closure[v, a] = True
    seed = torch.zeros(n, dtype=torch.bool)
    seed[v] = True
    return closure, seed


@pytest.fixture(scope="module")
def cell_rows():
    """Kernel 1's operands at the cell's shape and its plain result: 32
    search nodes (`_search_row`) of 32 distinct slots of G(1000, 0.5) at 83
    colours, each routed to its own graph's slot, the slots in reverse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    adjs = [_adjacency(100 + s, N, P) for s in range(32)]
    eng = get_engine("hopper_packed", device=cuda)
    cons, mask = eng.prepare_many([lambda a=a: coloring_csp(a, K, device=cuda)
                                   for a in adjs]).payload
    n_p, d_p, w = eng._dims(N, K)
    assert (n_p, d_p, w) == (1000, 88, 3)
    rng = np.random.default_rng(5)
    doms, seeds = zip(*(_search_row(a, rng) for a in reversed(adjs)))
    dom_p = torch.zeros((32, n_p, d_p), dtype=torch.bool, device=cuda)
    dom_p[:, :, :K] = torch.stack(doms).to(cuda)
    words = ops.pack_words(dom_p).view(32, -1).contiguous()
    seed = torch.stack(seeds).to(cuda, torch.uint8).contiguous()
    idx = torch.arange(31, -1, -1, dtype=torch.int32, device=cuda)
    args = (cons, mask, idx, words, seed)
    want = bs.packed_fixpoint_stacked_plain(*args, d=d_p, w=w)
    assert int(want[2].max()) >= 2 and bool((want[1] == 0).any()) and bool((want[1] == 1).any())
    yield args, dict(d=d_p, w=w), want
    del args, cons, mask
    torch.cuda.empty_cache()


@pytest.mark.parametrize("split", [1, 2, 4, 8, None], ids=["c1", "c2", "c4", "c8", "rule"])
def test_kernel_1_at_the_cell_shape_equals_plain(cell_rows, split):
    """Kernel 1 (`packed_fixpoint_stacked`, run-time W = 3) on 32 search
    nodes of 32 distinct slots of G(1000, 0.5) at 83 colours (`cell_rows`),
    bit for bit its plain version: closures, verdicts and k; a CTA a row,
    each row over a cluster of 2, 4 or 8 CTAs, and as the rule picks (c > 1
    on a card of at least 32 SMs). A split launch ticks
    ``fixpoint.split_launches`` once."""
    args, kw, want = cell_rows
    before = obs.REGISTRY.counter("fixpoint.split_launches")
    got = bs.packed_fixpoint_stacked(*args, **kw, split=split)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    c = split
    if split is None:
        c = launch.fixpoint_split(32, N, launch.sm_count(args[0].device))
        assert c > 1 or launch.sm_count(args[0].device) < 32
    assert obs.REGISTRY.counter("fixpoint.split_launches") - before == (c > 1)


def test_split_launches_tick_every_round_at_the_cell_shape_and_never_at_rb100_40(cuda):
    """``fixpoint.split_launches`` (registry, always on) ticks once a round
    of a two-graph `solve_many` at the cell's shape and schedule (2 rows a
    round of n 1,000: each row over a cluster), and stays at 0 through a
    `solve_many` and a `mac_solve` on rb100-40 (n_p = 104, below
    `launch.SPLIT_MIN_N`)."""
    eng = get_engine("hopper_packed", device=cuda)
    count = lambda: obs.REGISTRY.counter("fixpoint.split_launches")  # noqa: E731
    before = count()
    tel = {}
    _, stats = solve_many([lambda s=s: coloring_csp(_adjacency(300 + s, N, P), K, device=cuda)
                           for s in range(2)], engine=eng, max_assignments=40,
                          batched_children=False, telemetry=tel)
    assert tel["rounds"] > 0 and count() - before == tel["rounds"] == tel["launches"]
    torch.cuda.empty_cache()
    csps = [generate("model_rb", seed=i, device=cuda, n=100, alpha=0.8, r=0.7, hardness=0.9)
            for i in range(4)]
    before = count()
    bs.reset_launches()
    solve_many(csps, engine=eng, max_assignments=200)
    mac_solve(csps[0], engine=eng, max_assignments=200)
    assert bs.packed_fixpoint_stacked.launches > 0 and count() == before


@pytest.mark.parametrize("batched,budget", [(False, 1000), (True, 100)])
def test_solve_many_at_the_cell_size_equals_the_plain_reference(cuda, batched, budget):
    """`solve_many` on four lazy G(1000, 0.5) instances at 83 colours on
    fused `hopper_packed` equals the plain colouring MAC search, and the
    call's peak memory stays under the tables plus two instances' dense
    networks (one instance's network at a time): at the cell's schedule and
    budget (one child a round, 1,000 assignments), and with a node's
    children asked for at once."""
    adjs = [_adjacency(200 + s, N, P) for s in range(4)]
    eng = get_engine("hopper_packed", device=cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    sols, stats = solve_many([lambda a=a: coloring_csp(a, K, device=cuda) for a in adjs],
                             engine=eng, max_assignments=budget, batched_children=batched)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    tables = 4 * eng.network_nbytes(N, K)
    dense = N * N * K * K
    assert peak < tables + 2 * dense, (peak, tables, dense)
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))
    for adj, sol, st in zip(adjs, sols, stats):
        want = ref_coloring.solve(torch.as_tensor(adj), torch.ones((N, K), dtype=torch.bool),
                                  budget, batched=batched)
        assert want.key() == (sol, st.exhausted, st.n_assignments, st.n_backtracks,
                              st.rounds, tuple(st.recurrences))
