"""The port against the reference: `solve_many` and `mac_solve`.

The port's `einsum`, `hopper_packed` and `hopper_dense` (fused and stepped,
on the CPU, where the kernel wrappers run their plain versions) must return
the solutions, `SearchStats` (except timings) and frontier byte meters of the
reference's `einsum`, `pallas_packed` and `pallas_dense` *stepped* engines on
the same instances; `mac_solve` on the Hopper engines (the single-network
kernels) those of the reference's `mac_solve` on `pallas_*`.
"""

import numpy as np
import pytest
import torch

from repro.core import mac_solve as ref_mac_solve, solve_many as ref_solve_many
from repro.engines import get_engine as ref_get_engine
from repro.problems import generate_batch as ref_generate_batch

from repro_torch.core import check_solution, mac_solve, solve_many
from repro_torch.engines import get_engine
from repro_torch.problems import generate_batch

CPU = torch.device("cpu")
WORKLOAD = dict(n=12, hardness=0.9, seed=1)
BUDGET = 300


def stats_key(st, launches=True):
    """Every SearchStats field except enforce_seconds (and, optionally, the
    launch bill, which differs between fused and stepped by design)."""
    key = (st.n_assignments, st.n_backtracks, st.recurrences, st.revisions, st.exhausted,
           st.rounds, st.rows, st.members, st.cancelled_members, st.quarantined)
    return key + ((st.launches,) if launches else ())


TELEMETRY = ("rounds", "rows_dispatched", "rows_padded", "host_bytes_per_round",
             "domain_bytes_per_round", "root_bytes", "extract_bytes", "rounds_per_instance",
             "rounds_hist")


@pytest.fixture(scope="module")
def reference():
    csps = ref_generate_batch("model_rb", 4, **WORKLOAD)
    out = {}
    for name, eng in (("einsum", "einsum"),
                      ("packed", ref_get_engine("pallas_packed", fixpoint="stepped")),
                      ("dense", ref_get_engine("pallas_dense", fixpoint="stepped"))):
        tel = {}
        sols, stats = ref_solve_many(csps, engine=eng, max_assignments=BUDGET, telemetry=tel)
        out[name] = (sols, stats, tel)
    return out


@pytest.mark.parametrize("name,opts,ref_key", [
    ("einsum", {}, "einsum"),
    ("hopper_packed", {"fixpoint": "fused"}, "packed"),
    ("hopper_packed", {"fixpoint": "stepped"}, "packed"),
    ("hopper_dense", {"fixpoint": "fused"}, "dense"),
    ("hopper_dense", {"fixpoint": "stepped"}, "dense"),
])
def test_solve_many_matches_reference(reference, name, opts, ref_key):
    csps = generate_batch("model_rb", 4, device=CPU, **WORKLOAD)
    tel = {}
    eng = get_engine(name, device=CPU, **opts)
    sols, stats = solve_many(csps, engine=eng, max_assignments=BUDGET, telemetry=tel)
    ref_sols, ref_stats, ref_tel = reference[ref_key]
    assert sols == ref_sols
    fused = opts.get("fixpoint") == "fused"
    assert [stats_key(s, not fused) for s in stats] == [stats_key(s, not fused) for s in ref_stats]
    for field in TELEMETRY:
        assert tel[field] == ref_tel[field], field
    assert any(s is not None for s in sols)
    for csp, sol in zip(csps, sols):
        if sol is not None:
            assert check_solution(csp, sol)
    # launch bill: one per round fused, the deepest recurrence per round stepped
    assert tel["launches"] == (tel["rounds"] if fused else ref_tel["launches"])


def test_speculative_solve_many_matches_reference():
    """Split siblings and portfolio racers (admit_group) take the reference's
    decisions too."""
    knobs = dict(n=10, hardness=1.0, seed=3)
    ref_sols, ref_stats = ref_solve_many(ref_generate_batch("model_rb", 3, **knobs),
                                         split_budget=2, portfolio=2, max_assignments=200)
    sols, stats = solve_many(generate_batch("model_rb", 3, device=CPU, **knobs),
                             split_budget=2, portfolio=2, max_assignments=200, device=CPU)
    assert sols == ref_sols
    assert [stats_key(s) for s in stats] == [stats_key(s) for s in ref_stats]


@pytest.mark.parametrize("seed", [0, 4])
def test_mac_solve_einsum_matches_reference(seed):
    ref_csps = ref_generate_batch("model_rb", 2, n=12, hardness=0.95, seed=seed)
    csps = generate_batch("model_rb", 2, n=12, hardness=0.95, seed=seed, device=CPU)
    for ref_csp, csp in zip(ref_csps, csps):
        for kw in ({}, {"batched_children": False}, {"max_assignments": 5}):
            ref_sol, ref_st = ref_mac_solve(ref_csp, **kw)
            sol, st = mac_solve(csp, device=CPU, **kw)
            assert sol == ref_sol
            assert stats_key(st) == stats_key(ref_st)


def test_mac_solve_on_hopper_waits_for_the_single_network_kernel():
    """`mac_solve` on `hopper_packed`, which waited for the single-network
    kernel, now runs it and equals the reference on `pallas_packed`."""
    ref_csp = ref_generate_batch("model_rb", 1, n=8)[0]
    csp = generate_batch("model_rb", 1, n=8, device=CPU)[0]
    ref_sol, ref_st = ref_mac_solve(ref_csp, engine="pallas_packed")
    sol, st = mac_solve(csp, engine="hopper_packed", device=CPU)
    assert sol == ref_sol
    assert stats_key(st) == stats_key(ref_st)


@pytest.mark.parametrize("name,ref_name,fixpoint", [
    ("hopper_packed", "pallas_packed", "fused"), ("hopper_dense", "pallas_dense", "fused"),
    ("hopper_packed", "pallas_packed", "stepped"), ("hopper_dense", "pallas_dense", "stepped"),
], ids=["hopper_packed-pallas_packed", "hopper_dense-pallas_dense",
        "hopper_packed-pallas_packed-stepped", "hopper_dense-pallas_dense-stepped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mac_solve_on_hopper_matches_reference(name, ref_name, fixpoint, seed):
    """Batched children, one child at a time and a budget stop, on two
    solvable instances that backtrack (24 and 6 backtracks), on both routes
    of the single-network path: the fused kernel, one launch a round, and
    the stepped host loop. The launch bill is the reference's either way."""
    ref_csp = ref_generate_batch("model_rb", 1, n=12, hardness=0.8, seed=seed)[0]
    csp = generate_batch("model_rb", 1, n=12, hardness=0.8, seed=seed, device=CPU)[0]
    eng = get_engine(name, fixpoint=fixpoint, device=CPU)
    for kw in ({"max_assignments": 60}, {"batched_children": False, "max_assignments": 60},
               {"max_assignments": 15}):
        ref_sol, ref_st = ref_mac_solve(ref_csp, engine=ref_name, **kw)
        sol, st = mac_solve(csp, engine=eng, **kw)
        assert sol == ref_sol
        assert stats_key(st) == stats_key(ref_st)


def test_frontier_meters_and_network_bytes():
    eng = get_engine("hopper_packed", device=CPU)
    dense = get_engine("hopper_dense", device=CPU)
    ref_eng = ref_get_engine("pallas_packed")
    ref_dense = ref_get_engine("pallas_dense")
    for n, d in ((100, 40), (160, 10), (12, 7)):
        assert eng.network_nbytes(n, d) == ref_eng.network_nbytes(n, d)
        assert dense.network_nbytes(n, d) == ref_dense.network_nbytes(n, d)
    # the main path's tables: 32 n=100, d=40 networks ≈ 111 MB packed, 554 MB dense
    assert 32 * eng.network_nbytes(100, 40) == 111_101_952
    assert 32 * dense.network_nbytes(100, 40) == 554_125_312
    csps = generate_batch("model_rb", 2, n=10, seed=2, device=CPU)
    tel = {}
    solve_many(csps, engine=eng, telemetry=tel)
    assert tel["host_bytes_per_round"] < tel["domain_bytes_per_round"]
    np.testing.assert_equal(tel["fused_fixpoint"], True)
