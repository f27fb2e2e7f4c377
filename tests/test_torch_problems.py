"""The port's CSP generators and padding contract against the reference.

Same numpy seeds through `repro` and `repro_torch` must give byte-identical
networks for every registered family, the CSP helpers and padding helpers
must produce the same tensors, and the brute-force oracles must agree with
both packages' `mac_solve`, so every later comparison starts from identical
inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csp as ref_csp_mod, engine as ref_engine, mac_solve as ref_mac_solve
from repro.problems import (
    available_problems as ref_available_problems,
    generate as ref_generate,
    generate_batch as ref_generate_batch,
)
from repro.problems import get_problem as ref_get_problem
from repro.problems.coloring import kneser_adjacency as ref_kneser
from repro.problems.structured import sudoku_solution_grid as ref_sudoku_solution_grid

from repro_torch.core import (
    PAPER_GRID,
    CSPBenchSpec,
    ac_closure_brute,
    check_solution,
    coloring_csp,
    count_solutions,
    csp_from_numpy,
    engine,
    enforce_ac3,
    mac_solve,
    nqueens_csp,
    pad_domains,
    random_csp,
    solve_brute,
    sudoku_csp,
    to_paper_cons,
)
from repro_torch.engines import get_engine
from repro_torch.kernels import ops
from repro_torch.problems import available_problems, generate, generate_batch, get_problem
from repro_torch.problems.coloring import kneser_adjacency
from repro_torch.problems.structured import sudoku_solution_grid

CPU = torch.device("cpu")

FAMILIES = [
    ("model_rb", dict(n=12, hardness=0.9)),
    ("model_rb", dict(n=20, alpha=0.7, r=0.6, hardness=1.1)),
    ("random_binary", dict(n=10, d=6, density=0.5)),
    ("random_binary", dict(n=16, d=10, density=1.0, tightness=0.4)),
    ("coloring_random", dict(n=12, edge_prob=0.25, k=3)),
    ("coloring_random", dict(n=30)),
    ("coloring_kneser", dict()),
    ("coloring_kneser", dict(m=7, j=3, excess=-1)),
    ("pigeonhole", dict(n=5)),
    ("pigeonhole", dict(n=6, holes=7)),
    ("nqueens", dict(n=6)),
    ("nqueens", dict(n=10)),
    ("sudoku", dict(givens=40)),
    ("sudoku", dict(givens=25)),
]


def _assert_same(ref_csp, csp):
    for field in ("cons", "mask", "dom"):
        want = np.asarray(getattr(ref_csp, field))
        got = getattr(csp, field).numpy()
        assert got.dtype == np.bool_ and got.shape == want.shape, field
        assert got.tobytes() == want.tobytes(), field


@pytest.mark.parametrize("name,knobs", FAMILIES)
def test_generate_is_byte_identical(name, knobs):
    _assert_same(ref_generate(name, seed=7, **knobs), generate(name, seed=7, device=CPU, **knobs))


@pytest.mark.parametrize("name,knobs", FAMILIES)
def test_generate_batch_is_byte_identical(name, knobs):
    ref = ref_generate_batch(name, 3, seed=2, **knobs)
    got = generate_batch(name, 3, seed=2, device=CPU, **knobs)
    assert len(got) == 3
    for a, b in zip(ref, got):
        _assert_same(a, b)


def test_registry_knobs_exclude_seed_and_device():
    assert available_problems() == ref_available_problems()
    for name in available_problems():
        assert "device" not in get_problem(name).defaults
    with pytest.raises(TypeError):
        generate("model_rb", device=CPU, no_such_knob=1)


def test_csp_from_numpy_carries_a_reference_csp_across():
    ref = ref_generate("model_rb", seed=1, n=10)
    csp = csp_from_numpy(np.asarray(ref.cons), np.asarray(ref.mask), np.asarray(ref.dom), CPU)
    _assert_same(ref, csp)
    assert csp.n_vars == 10 and csp.device == CPU


SHAPE_SWEEP = [
    # (n_vars, dom_size, n_block) — the shapes of tests/test_kernels.py
    (4, 3, 4),
    (8, 5, 8),
    (10, 6, 8),
    (16, 8, 8),
    (24, 33, 8),
    (12, 64, 4),
]


@pytest.mark.parametrize("n,d,n_block", SHAPE_SWEEP)
def test_padding_helpers_match_reference(n, d, n_block, monkeypatch):
    ref = ref_generate("random_binary", seed=n + d, n=n, d=d, density=0.6)
    csp = generate("random_binary", seed=n + d, n=n, d=d, density=0.6, device=CPU)
    assert engine.padded_shape(n, d, n_block, 8) == ref_engine.padded_shape(n, d, n_block, 8)
    rc, rm, rn, rd = ref_engine.pad_network(ref, n_block, 8)
    n_p, d_p = engine.padded_shape(n, d, n_block, 8)
    assert (n_p, d_p) == (rn, rd)
    # the network is padded a chunk of x-rows at a time: three rows a chunk
    monkeypatch.setattr(ops, "_PACK_CHUNK", 3 * n_p * d_p * d_p)
    chunks = list(ops._network_chunks(csp.cons, n_p, d_p, CPU))
    assert [x0 for x0, _ in chunks] == list(range(0, n_p, 3))
    c = torch.cat([part for _, part in chunks])
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(ops._mask_u8(csp, n_p, CPU).numpy(),
                                  np.asarray(rm).astype(np.uint8))
    rng = np.random.default_rng(n * d)
    doms = rng.random((3, n, d)) < 0.7
    np.testing.assert_array_equal(
        engine.pad_dom(torch.as_tensor(doms), n_p, d_p).numpy(),
        np.asarray(ref_engine.pad_dom(jnp.asarray(doms), n_p, d_p)),
    )
    ch = rng.random((3, n)) < 0.5
    np.testing.assert_array_equal(
        engine.pad_changed(ch, n, n_p, batch=(3,)).numpy(),
        np.asarray(ref_engine.pad_changed(ch, n, n_p, batch=(3,))),
    )
    np.testing.assert_array_equal(
        engine.pad_changed(None, n, n_p, batch=(2,)).numpy(),
        np.asarray(ref_engine.pad_changed(None, n, n_p, batch=(2,))),
    )


def test_round_helpers_match_reference():
    for x in (1, 2, 3, 5, 64, 65, 1000):
        assert engine.next_pow2(x) == ref_engine.next_pow2(x)
        assert engine.round_up(x, 8) == ref_engine.round_up(x, 8)
    a = np.arange(6, dtype=np.int32).reshape(3, 2)
    for got, want in zip(engine.pad_round_rows([a, a[:, 0]], 8),
                         ref_engine.pad_round_rows([a, a[:, 0]], 8)):
        np.testing.assert_array_equal(got, want)
    for args in ((1, 10, 10), (32, 100, 40), (400, 100, 40)):
        assert engine.frontier_capacity(*args) == ref_engine.frontier_capacity(*args)
    idx = np.array([2, 0, 1], np.int32)
    np.testing.assert_array_equal(engine.resolve_instance_idx(idx, 3, 3),
                                  ref_engine.resolve_instance_idx(idx, 3, 3))
    with pytest.raises(ValueError):
        engine.resolve_instance_idx(np.array([3]), 3, 1)


def test_family_knobs_match_reference():
    for name in available_problems():
        fam, ref = get_problem(name), ref_get_problem(name)
        assert dict(fam.defaults) == dict(ref.defaults), name
        assert (fam.difficulty_knob, fam.deterministic) == (ref.difficulty_knob,
                                                            ref.deterministic), name


@pytest.mark.parametrize("seed", [0, 5, (3, 1)])
def test_sudoku_grid_and_kneser_match_reference(seed):
    np.testing.assert_array_equal(sudoku_solution_grid(seed), ref_sudoku_solution_grid(seed))
    np.testing.assert_array_equal(kneser_adjacency(5, 2), ref_kneser(5, 2))
    with pytest.raises(ValueError, match="Kneser"):
        kneser_adjacency(4, 2)


# --- CSP helpers ----------------------------------------------------------------


@pytest.mark.parametrize("build,ref_build", [
    (lambda: nqueens_csp(7, device=CPU), lambda: ref_csp_mod.nqueens_csp(7)),
    (lambda: coloring_csp(np.eye(6, k=1, dtype=bool) | np.eye(6, k=-1, dtype=bool), 3,
                          device=CPU),
     lambda: ref_csp_mod.coloring_csp(np.eye(6, k=1, dtype=bool) | np.eye(6, k=-1, dtype=bool),
                                      3)),
    (lambda: sudoku_csp(np.arange(81).reshape(9, 9) % 10, device=CPU),
     lambda: ref_csp_mod.sudoku_csp(np.arange(81).reshape(9, 9) % 10)),
    (lambda: random_csp(9, 5, 0.6, 0.4, seed=2, device=CPU),
     lambda: ref_csp_mod.random_csp(9, 5, 0.6, 0.4, seed=2)),
])
def test_csp_builders_and_helpers_match_reference(build, ref_build):
    csp, ref = build(), ref_build()
    _assert_same(ref, csp)
    np.testing.assert_array_equal(to_paper_cons(csp).numpy(),
                                  np.asarray(ref_csp_mod.to_paper_cons(ref)))
    d = csp.dom_size
    for pad_to in (d, d + 3):
        _assert_same(ref_csp_mod.pad_domains(ref, pad_to), pad_domains(csp, pad_to))
    with pytest.raises(ValueError):
        pad_domains(csp, d - 1)


def test_bench_grid_matches_reference():
    assert [(s.n_vars, s.density, s.dom_size, s.tightness, s.seed) for s in PAPER_GRID] == \
        [(s.n_vars, s.density, s.dom_size, s.tightness, s.seed) for s in ref_csp_mod.PAPER_GRID]
    spec = CSPBenchSpec(n_vars=12, density=0.5, seed=4)
    _assert_same(ref_csp_mod.CSPBenchSpec(n_vars=12, density=0.5, seed=4).build(),
                 spec.build(device=CPU))


# --- brute force against both packages' mac_solve -------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_random_csp_against_brute_and_both_packages(seed):
    csp = random_csp(7, 4, density=0.7, tightness=0.5, seed=seed, device=CPU)
    cons, mask, dom = (t.numpy() for t in (csp.cons, csp.mask, csp.dom))
    brute = solve_brute(cons, mask, dom)
    ref_sol, _ = ref_mac_solve(ref_csp_mod.random_csp(7, 4, density=0.7, tightness=0.5,
                                                       seed=seed), engine="einsum")
    for name in ("einsum", "ac3", "hopper_packed"):
        sol, _ = mac_solve(csp, engine=name, device=CPU)
        assert sol == ref_sol, name
        assert (sol is None) == (brute is None)
        if sol is not None:
            assert check_solution(csp, sol)
    assert (count_solutions(cons, mask, dom) == 0) == (brute is None)


@pytest.mark.parametrize("seed", range(4))
def test_ac_closure_brute_equals_ac3_and_the_engines(seed):
    csp = random_csp(8, 4, density=0.6, tightness=0.45, seed=seed, device=CPU)
    cons, mask, dom = (t.numpy() for t in (csp.cons, csp.mask, csp.dom))
    bd, bc = ac_closure_brute(cons, mask, dom)
    a3 = enforce_ac3(cons, mask, dom)
    assert bc == a3.consistent
    for name in ("einsum", "ac3", "hopper_dense"):
        res = get_engine(name, device=CPU).prepare(csp).enforce()
        assert bool(res.consistent) == bc, name
        if bc:
            np.testing.assert_array_equal(np.asarray(res.dom), bd)


@pytest.mark.parametrize("name,knobs,engine", [
    ("nqueens", dict(n=6), "hopper_dense"),
    ("pigeonhole", dict(n=5), "ac3"),
    ("coloring_kneser", dict(), "hopper_packed"),
    ("coloring_random", dict(n=10, k=3), "einsum"),
    ("sudoku", dict(givens=45), "hopper_packed"),
])
def test_new_families_solve_like_the_reference(name, knobs, engine):
    """`mac_solve` on each new family equals the reference's, solutions and
    statistics; the brute force agrees wherever it is small enough."""
    ref_name = {"hopper_dense": "pallas_dense", "hopper_packed": "pallas_packed"}.get(engine,
                                                                                     engine)
    csp = generate(name, seed=1, device=CPU, **knobs)
    ref_sol, ref_st = ref_mac_solve(ref_generate(name, seed=1, **knobs), engine=ref_name)
    sol, st = mac_solve(csp, engine=engine, device=CPU)
    assert sol == ref_sol
    assert (st.n_assignments, st.n_backtracks, st.recurrences, st.revisions) == \
        (ref_st.n_assignments, ref_st.n_backtracks, ref_st.recurrences, ref_st.revisions)
    if sol is not None:
        assert check_solution(csp, sol)
    if csp.dom_size ** csp.n_vars <= 10 ** 6:
        assert (solve_brute(csp.cons.numpy(), csp.mask.numpy(), csp.dom.numpy()) is None) \
            == (sol is None)
