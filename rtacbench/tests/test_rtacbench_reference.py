"""The plain reference against the port, on the CPU at small sizes."""

import pytest
import torch

from rtacbench.reference import fixpoint as fx
from rtacbench.reference import generators as gen
from rtacbench.reference import hashed
from rtacbench.reference import mac


def test_pack_round_trip_at_64_values():
    bools = torch.rand((5, 7, 64), generator=torch.Generator().manual_seed(0)) < 0.5
    assert torch.equal(fx.unpack(fx.pack(bools), 64), bools)


@pytest.mark.parametrize("seeded", ["all", "one"])
def test_fixpoint_matches_port_enforce_batch(seeded):
    from repro_torch.core import rtac

    cons, mask, dom = hashed.hashed_random_csp(48, 8, 0.2, 0.55, seed=3, device="cpu")
    doms = torch.as_tensor(gen.search_nodes(dom.numpy(), 12, seed=1))
    seed = torch.ones((12, 48), dtype=torch.bool)
    if seeded == "one":
        seed = ~doms.all(dim=-1)
    want = rtac.enforce_batch(cons, mask, doms, seed)
    got = fx.fixpoint(fx.dense_network(cons, mask), fx.pack(doms), seed)
    assert torch.equal(got.consistent, want.consistent)
    assert torch.equal(got.k, want.n_recurrences.to(torch.int32))
    ok = want.consistent
    assert torch.equal(fx.unpack(got.dom, 8)[ok], want.dom[ok])


@pytest.mark.parametrize("seed", [(11, 0), (11, 1), (2**31 + 1, 2)])
def test_mac_matches_port_mac_solve_and_solve_many(seed):
    from repro_torch.core.search import mac_solve, solve_many
    from repro_torch.problems import generate

    draws = gen.model_rb_draws(seed, n=24, hardness=0.9)
    want = mac.solve(fx.rb_network(draws), torch.ones((draws.n, draws.d), dtype=torch.bool),
                     400)
    csp = generate("model_rb", seed=seed, n=24, hardness=0.9, device="cpu")
    for sol, st in (mac_solve(csp, engine="hopper_packed", max_assignments=400, device="cpu"),
                    *zip(*solve_many([csp], engine="hopper_packed", max_assignments=400,
                                     device="cpu"))):
        assert want.key() == (sol, st.exhausted, st.n_assignments, st.n_backtracks,
                              st.rounds, tuple(st.recurrences))


def test_mac_observer_sees_every_recurrence():
    draws = gen.model_rb_draws(4, n=12, hardness=0.9)
    seen = []
    rec = mac.solve(fx.rb_network(draws), torch.ones((draws.n, draws.d), dtype=torch.bool),
                    60, observe=lambda seeds, rows: seen.append((len(seeds), rows)))
    assert len(seen) == rec.rounds
    assert sum(r for _k, r in seen) == len(rec.recurrences)
    ks = iter(rec.recurrences)
    for steps, rows in seen:
        assert steps == max(next(ks) for _ in range(rows))
