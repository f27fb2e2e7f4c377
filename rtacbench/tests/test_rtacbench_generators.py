"""Each frozen generator against the port's own, byte for byte."""

import numpy as np
import pytest
import torch

from rtacbench.lib import instances
from rtacbench.reference import generators as gen
from rtacbench.reference import hashed


@pytest.mark.parametrize("seed", [0, (2**31 + 7, 3), (5, 1, 2)])
@pytest.mark.parametrize("n,hardness", [(12, 0.9), (20, 1.1)])
def test_model_rb_matches_port(seed, n, hardness):
    from repro_torch.problems import generate

    port = generate("model_rb", seed=seed, n=n, hardness=hardness, device="cpu")
    cons, mask, dom = gen.model_rb(seed, n=n, hardness=hardness)
    on_dev = instances.rb_on_device(gen.model_rb_draws(seed, n=n, hardness=hardness), "cpu")
    for want, got, dev in zip((port.cons, port.mask, port.dom), (cons, mask, dom), on_dev):
        assert np.array_equal(want.numpy(), got)
        assert torch.equal(want, dev)


@pytest.mark.parametrize("n,d,density,tightness,seed", [
    (24, 5, 0.3, 0.4, 0), (40, 8, 0.1, 0.6, 2**31 + 11), (17, 3, 0.5, 0.2, 2**33 + 5)])
def test_hashed_matches_port_and_pairs(n, d, density, tightness, seed):
    from repro_torch.core.csp import hashed_random_csp

    port = hashed_random_csp(n, d, density, tightness, seed=seed, device="cpu")
    cons, mask, dom = hashed.hashed_random_csp(n, d, density, tightness, seed=seed,
                                               device="cpu")
    assert torch.equal(port.cons, cons) and torch.equal(port.mask, mask)
    assert torch.equal(port.dom, dom)
    xs, ys, blocks = hashed.hashed_pairs(n, d, density, tightness, seed=seed)
    want_x, want_y = mask.nonzero(as_tuple=True)
    assert torch.equal(xs, want_x) and torch.equal(ys, want_y)
    assert torch.equal(blocks, cons[xs, ys])


@pytest.mark.parametrize("seed", [0, 2**31 + 99])
def test_search_nodes_matches_port(seed):
    from repro_torch.launch.distributed_ac import search_nodes

    dom = np.ones((30, 6), dtype=bool)
    assert np.array_equal(search_nodes(dom, 17, seed), gen.search_nodes(dom, 17, seed))


@pytest.mark.parametrize("rate,duration,seed", [(6.0, 5.0, 0), (20.0, 2.0, 2**31 + 3)])
def test_poisson_trace_matches_port(rate, duration, seed):
    from repro_torch.service import poisson_trace

    variants = {"model_rb": [{"n": 10, "hardness": 0.9}, {"n": 12}], "nqueens": [{"n": 8}]}
    want = poisson_trace(["model_rb", "nqueens"], rate, duration, seed=seed, variants=variants)
    got = gen.poisson_trace(["model_rb", "nqueens"], rate, duration, seed, variants)
    assert [(e.t, e.family, e.knobs, e.seed) for e in want] == list(map(tuple, got))


def test_worker_draws_equal_serial_draws():
    seeds = [instances.seed_of(2**31 + 5, i) for i in range(instances.SERIAL_BELOW + 3)]
    knobs = {"n": 12, "alpha": 0.8, "r": 0.7, "hardness": 0.9}
    got = instances.rb_draws(seeds, knobs)
    for s, dr in zip(seeds, got):
        want = gen.model_rb_draws(s, **knobs)
        assert np.array_equal(want.xs, dr.xs) and np.array_equal(want.rels, dr.rels)


def test_service_arrivals_are_one_poisson_path_and_the_seed_orders_the_instances(benchmark):
    from types import SimpleNamespace

    from conftest import SEED, SERVICE_CELL

    from rtacbench.lib import spec

    cell = spec.load_cell(SERVICE_CELL, benchmark=benchmark)
    drv = spec.driver(cell.workload["driver"])

    def events(seed):
        return drv.events(SimpleNamespace(config=cell.config, workload=cell.workload,
                                          seconds=20.0, seed=seed))

    a, b = events(SEED), events(SEED + 1)
    assert [e.t for e in a] == [e.t for e in b]
    gaps = np.diff([0.0] + [e.t for e in a])
    assert gaps.min() < 0.5 / cell.workload["rate"] < gaps.max()  # not evenly spaced
    assert sorted(e.seed for e in a) == sorted(e.seed for e in b)
    assert [e.seed for e in a] != [e.seed for e in b]
