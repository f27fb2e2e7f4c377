"""Colouring portfolios through `solve_many`, their networks prepared one
instance at a time.

- `coloring_csp` builds the network on the device by broadcast, bit for bit
  the numpy build of the JAX package;
- `Engine.prepare_many` writes each instance into its slot of tables
  allocated once: the tables equal those of the per-instance networks
  stacked, at W = 2 and W = 3, eager or lazy;
- `solve_many` on lazy instances (zero-argument callables that build a CSP)
  gives the solutions and `SearchStats` of eager ones, on `hopper_packed`
  and `einsum`, and those of the JAX package's `solve_many`;
- a lazy instance's network is freed before the next one is built;
- the benchmark's plain colouring reference (`rtacbench/reference/coloring`)
  agrees with the port.

The cell's shape on the card is `test_torch_coloring_gpu.py`'s.
"""

import gc
import sys
import weakref

import numpy as np
import pytest
import torch

from repro.core import csp as ref_csp_mod, solve_many as ref_solve_many
from repro.engines import get_engine as ref_get_engine

from repro_torch import obs
from repro_torch.core import coloring_csp, solve_many
from repro_torch.engines import get_engine
from repro_torch.kernels import ops
from repro_torch.problems import generate
from rtacbench.reference import coloring as ref_coloring

CPU = torch.device("cpu")


def _adjacency(seed, n, p):
    return ref_coloring.gnp_adjacency(seed, n, p)


def _stats_key(st, launches=True):
    key = (st.n_assignments, st.n_backtracks, st.recurrences, st.revisions, st.exhausted,
           st.rounds, st.rows, st.members, st.cancelled_members, st.quarantined)
    return key + ((st.launches,) if launches else ())


# ---------------------------------------------------------------------------
# coloring_csp on the device
# ---------------------------------------------------------------------------

ADJACENCIES = {
    "gnp": lambda: _adjacency(3, 17, 0.5),
    "int_with_loops": lambda: (np.random.default_rng(1).integers(0, 3, (9, 9))
                               * np.eye(9, k=2, dtype=np.int64).T) + np.eye(9, dtype=np.int64),
    "empty": lambda: np.zeros((5, 5), dtype=bool),
    "complete": lambda: ~np.eye(6, dtype=bool),
}


@pytest.mark.parametrize("colours", [1, 3, 70])
@pytest.mark.parametrize("name", sorted(ADJACENCIES))
def test_coloring_csp_on_the_device_equals_the_numpy_build(name, colours):
    adj = ADJACENCIES[name]()
    want = ref_csp_mod.coloring_csp(adj, colours)
    for given in (adj, torch.as_tensor(adj)):
        got = coloring_csp(given, colours, device=CPU)
        for part in ("cons", "mask", "dom"):
            t = getattr(got, part)
            assert t.dtype == torch.bool and t.is_contiguous()
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, part)))


def test_coloring_random_draws_the_reference_graph():
    """The port's G(n, p) family and the benchmark's frozen draws agree."""
    csp = generate("coloring_random", seed=11, n=23, edge_prob=0.5, k=4, device=CPU)
    np.testing.assert_array_equal(csp.mask.numpy(), _adjacency(11, 23, 0.5))


# ---------------------------------------------------------------------------
# prepare_many one instance at a time
# ---------------------------------------------------------------------------


def _stacked(kind, csps):
    """The tables as the per-instance networks stacked (what the stacked
    path built before it wrote slots in place)."""
    prepare = ops.prepare_packed if kind == "packed" else ops.prepare_dense
    nets = [prepare(c, memo=False)[0] for c in csps]
    return torch.stack([c for c, _ in nets]), torch.stack([m for _, m in nets])


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("n,k,w", [(16, 40, 2), (16, 70, 3), (13, 9, 1)])
def test_streamed_tables_equal_the_stacked_tables(n, k, w, kind, lazy, monkeypatch):
    """Slot tables written in place, with chunks of 3 x-rows padded alone,
    equal the stacked per-instance networks; the counter ticks once a slot."""
    adjs = [_adjacency(s, n, 0.5) for s in range(3)]
    csps = [coloring_csp(a, k, device=CPU) for a in adjs]
    want_cons, want_mask = _stacked(kind, csps)
    eng = get_engine(f"hopper_{kind}", device=CPU)
    n_p, d_p = eng._dims(n, k)[:2]
    assert (-(-d_p // 32) == w) or kind == "dense"
    monkeypatch.setattr(ops, "_PACK_CHUNK", 3 * n_p * d_p * d_p)
    before = obs.REGISTRY.counter("prepare.slots")
    instances = ([lambda a=a: coloring_csp(a, k, device=CPU) for a in adjs] if lazy
                 else csps)
    prepared = eng.prepare_many(instances)
    cons, mask = prepared.payload
    assert torch.equal(cons, want_cons) and torch.equal(mask, want_mask)
    assert obs.REGISTRY.counter("prepare.slots") - before == len(adjs)
    assert prepared.n_instances == 3 and (prepared.n_vars, prepared.dom_size) == (n, k)
    assert all(torch.equal(d, c.dom) for d, c in zip(prepared.doms, csps))


@pytest.mark.parametrize("lazy", [False, True])
def test_einsum_tables_equal_the_stacked_networks(lazy):
    adjs = [_adjacency(s, 11, 0.4) for s in range(3)]
    csps = [coloring_csp(a, 5, device=CPU) for a in adjs]
    instances = [lambda a=a: coloring_csp(a, 5, device=CPU) for a in adjs] if lazy else csps
    cons, mask = get_engine("einsum", device=CPU).prepare_many(instances).payload
    assert torch.equal(cons, torch.stack([c.cons for c in csps]))
    assert torch.equal(mask, torch.stack([c.mask for c in csps]))


def test_prepare_many_refuses_mixed_shapes_lazy_or_not():
    a = lambda: coloring_csp(_adjacency(0, 8, 0.5), 3, device=CPU)  # noqa: E731
    b = lambda: coloring_csp(_adjacency(0, 8, 0.5), 4, device=CPU)  # noqa: E731
    for eng in ("hopper_packed", "einsum", "ac3"):
        with pytest.raises(ValueError, match="must share"):
            get_engine(eng, device=CPU).prepare_many([a, b])
        with pytest.raises(ValueError, match="must share"):
            get_engine(eng, device=CPU).prepare_many([a(), b()])


@pytest.mark.parametrize("engine", ["hopper_packed", "hopper_dense", "einsum", "ac3"])
def test_a_lazy_network_is_freed_before_the_next_is_built(engine):
    """While instance i is built, no earlier instance's dense network is
    alive on a stacked engine (its slot holds the network now); the generic
    engines keep a prepared network per instance, as for eager CSPs."""
    refs = []
    alive_at_build = []

    def build(seed):
        def make():
            gc.collect()
            alive_at_build.append(sum(r() is not None for r in refs))
            csp = coloring_csp(_adjacency(seed, 12, 0.5), 4, device=CPU)
            refs.append(weakref.ref(csp.cons))
            return csp
        return make

    eng = get_engine(engine, device=CPU)
    prepared = eng.prepare_many([build(s) for s in range(4)])
    gc.collect()
    if eng.slot_table:
        assert alive_at_build == [0, 0, 0, 0]
        assert all(r() is None for r in refs)
    else:
        assert alive_at_build == [0, 1, 2, 3]
    assert prepared.n_instances == 4


# ---------------------------------------------------------------------------
# solve_many on lazy instances
# ---------------------------------------------------------------------------

#: (seed, n, p) of G(16, p) at 4 colours: solutions, refutations and
#: budget stops
GRAPHS = [(0, 16, 0.5), (2, 16, 0.5), (1, 16, 0.3), (3, 16, 0.3), (1, 16, 0.5)]
COLOURS = 4
BUDGET = 120


@pytest.fixture(scope="module")
def reference_solves():
    csps = [ref_csp_mod.coloring_csp(_adjacency(*g), COLOURS) for g in GRAPHS]
    out = {}
    for key, eng in (("einsum", "einsum"),
                     ("packed", ref_get_engine("pallas_packed", fixpoint="stepped"))):
        out[key] = ref_solve_many(csps, engine=eng, max_assignments=BUDGET)
    return out


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("name,opts,ref_key", [
    ("einsum", {}, "einsum"),
    ("hopper_packed", {"fixpoint": "fused"}, "packed"),
    ("hopper_packed", {"fixpoint": "stepped"}, "packed"),
])
def test_solve_many_lazy_equals_eager_and_the_reference(reference_solves, name, opts, ref_key,
                                                         lazy):
    adjs = [_adjacency(*g) for g in GRAPHS]
    instances = ([lambda a=a: coloring_csp(a, COLOURS, device=CPU) for a in adjs] if lazy
                 else [coloring_csp(a, COLOURS, device=CPU) for a in adjs])
    tel = {}
    sols, stats = solve_many(instances, engine=get_engine(name, device=CPU, **opts),
                             max_assignments=BUDGET, telemetry=tel)
    ref_sols, ref_stats = reference_solves[ref_key]
    fused = opts.get("fixpoint") == "fused"
    assert sols == ref_sols
    assert [_stats_key(s, not fused) for s in stats] == [_stats_key(s, not fused)
                                                         for s in ref_stats]
    assert any(s is not None for s in sols) and any(s.exhausted for s in stats)
    assert any(s is None and not st.exhausted for s, st in zip(sols, stats))
    assert 0 < tel["prepare_seconds"] < 60


def test_solve_many_on_a_sequential_engine_builds_lazy_instances_in_turn(reference_solves):
    adjs = [_adjacency(*g) for g in GRAPHS]
    sols, stats = solve_many([lambda a=a: coloring_csp(a, COLOURS, device=CPU) for a in adjs],
                             engine="ac3", max_assignments=BUDGET, device=CPU)
    ref_sols, ref_stats = reference_solves["einsum"]
    assert sols == ref_sols
    assert [(s.n_assignments, s.n_backtracks, s.exhausted) for s in stats] == [
        (s.n_assignments, s.n_backtracks, s.exhausted) for s in ref_stats]


def test_prepare_slot_spans_wrap_each_instance():
    tracer = obs.enable()
    try:
        solve_many([lambda s=s: coloring_csp(_adjacency(s, 10, 0.5), 4, device=CPU)
                    for s in range(3)], engine=get_engine("hopper_packed", device=CPU),
                   max_assignments=20)
        spans = [s for s in tracer.snapshot_spans() if s["name"] == "prepare.slot"]
    finally:
        obs.disable()
    assert [s["args"]["slot"] for s in spans] == [0, 1, 2]
    assert all(s["cat"] == "engine" for s in spans)
    (prep,) = [s for s in tracer.snapshot_spans() if s["name"] == "search.prepare"]
    assert all(s["parent"] == prep["sid"] for s in spans)


# ---------------------------------------------------------------------------
# The benchmark's plain colouring reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 2**31 + 7])
def test_plain_colouring_reference_agrees_with_the_port(seed, batched):
    """`reference.coloring.solve` at G(24, 0.5), 6 colours, equals
    `solve_many` on fused `hopper_packed`: solution, exhaustion, counts,
    rounds and every row's k, with a node's children asked for at once or
    one at a time."""
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10_000))
    adj = _adjacency(seed, 24, 0.5)
    want = ref_coloring.solve(torch.as_tensor(adj), torch.ones((24, 6), dtype=torch.bool), 300,
                              batched=batched)
    sols, stats = solve_many([lambda: coloring_csp(adj, 6, device=CPU)],
                             engine=get_engine("hopper_packed", device=CPU),
                             max_assignments=300, batched_children=batched)
    st = stats[0]
    assert want.key() == (sols[0], st.exhausted, st.n_assignments, st.n_backtracks,
                          st.rounds, tuple(st.recurrences))
