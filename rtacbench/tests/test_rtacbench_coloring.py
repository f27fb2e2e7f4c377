"""The colouring cell at a CPU size, and its plain reference.

- The not-equal fixpoint (`reference.coloring`) equals the generic plain
  fixpoint (`reference.fixpoint`, bitset domains, d <= 64) on colouring
  networks: closures, verdicts, k and the seeds of every step; its MAC
  search equals `reference.mac` there, and asking for one child a request
  changes its requests and nothing else.
- A tiny cell (n = 40, k = 8, batches of 4) gives a well-formed, correct
  result line traced and untraced, with a node's children asked for at
  once or one at a time, and its check fails on the control.
- A run's ``info`` carries the window's sync counters, an untraced run's
  the calls' ``prepare_seconds`` and a traced run's the fused fixpoint's
  ``fixpoint_bound_s``.
"""

import json
import time

import pytest
import torch
from conftest import SEED

from rtacbench.lib import harness
from rtacbench.reference import coloring
from rtacbench.reference import fixpoint as fx
from rtacbench.reference import mac

CELL = "dsjc1000.5-83.portfolio"
TINY = {"config": {"n": 40, "k": 8, "max_assignments": 150},
        "workload": {"batch": 4, "batches": 2, "warm_assignments": 20}}


def _generic(adj, k):
    cons, mask, _dom = coloring.dense(adj, k)
    return fx.dense_network(torch.as_tensor(cons), torch.as_tensor(mask))


@pytest.mark.parametrize("n,p,k", [(30, 0.5, 5), (24, 0.3, 3), (20, 0.9, 64)])
def test_not_equal_fixpoint_equals_the_generic_one(n, p, k):
    adj = coloring.gnp_adjacency(n + k, n, p)
    gen = torch.Generator().manual_seed(n)
    rows = 12
    doms = torch.rand((rows, n, k), generator=gen) < 0.6
    doms[..., 0] |= ~doms.any(dim=-1)  # no empty domain but the one below
    doms[torch.arange(rows), torch.arange(rows) % n] = False  # singletons to propagate
    doms[torch.arange(rows), torch.arange(rows) % n, torch.arange(rows) % k] = True
    doms[0, 1] = False  # an empty domain at entry
    seed = torch.rand((rows, n), generator=gen) < 0.3
    seed[1] = True
    got_seeds, want_seeds = [], []
    got = coloring.fixpoint(torch.as_tensor(adj), doms, seed, on_step=got_seeds.append)
    want = fx.fixpoint(_generic(adj, k), fx.pack(doms), seed, on_step=want_seeds.append)
    assert torch.equal(got.consistent, want.consistent)
    assert torch.equal(got.k, want.k)
    assert torch.equal(fx.pack(got.dom), want.dom)
    assert len(got_seeds) == len(want_seeds) and int(want.k.max()) >= 2
    assert all(torch.equal(a, b) for a, b in zip(got_seeds, want_seeds))
    cut = coloring.fixpoint(torch.as_tensor(adj), doms, seed, max_steps=1)
    assert torch.equal(fx.pack(cut.dom), fx.fixpoint(_generic(adj, k), fx.pack(doms), seed,
                                                     max_steps=1).dom)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_not_equal_mac_equals_the_generic_mac(seed):
    adj = coloring.gnp_adjacency(seed, 18, 0.5)
    want = mac.solve(_generic(adj, 4), torch.ones((18, 4), dtype=torch.bool), 200)
    got = coloring.solve(torch.as_tensor(adj), torch.ones((18, 4), dtype=torch.bool), 200)
    assert got.key() == want.key()


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_one_child_a_request_changes_only_the_requests(seed):
    adj = torch.as_tensor(coloring.gnp_adjacency(seed, 18, 0.5))
    root = torch.ones((18, 4), dtype=torch.bool)
    at_once = coloring.solve(adj, root, 200)
    one = coloring.solve(adj, root, 200, batched=False)
    assert (one.solution, one.exhausted, one.n_assignments, one.n_backtracks) == (
        at_once.solution, at_once.exhausted, at_once.n_assignments, at_once.n_backtracks)
    # the root, then a request a value tried (not the one past the budget)
    assert one.rounds == 1 + one.n_assignments - one.exhausted == len(one.recurrences)
    assert one.rounds > at_once.rounds


def _run(trace=False, program="port", seconds=0.5, after_s=0.0, batched=False):
    overrides = {"config": dict(TINY["config"], batched_children=batched),
                 "workload": dict(TINY["workload"], trace={"after_s": after_s, "min_s": 0.1})}
    return harness.run_cell(CELL, SEED, seconds, trace, time.perf_counter(), device="cpu",
                            overrides=overrides, program=program)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("trace", [0, 1])
def test_coloring_cell_runs_and_agrees_with_reference(trace, batched, capsys):
    # traced: the first call under the profiler (its solves replayed with
    # the bound), however long it takes; untraced: every call's
    # preparation counted
    line = json.loads(json.dumps(_run(bool(trace), seconds=3.0 if trace else 0.5,
                                      after_s=0.0, batched=batched)))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    info = json.loads(capsys.readouterr().err.split(" info=", 1)[1].splitlines()[0])
    # at least one blocking read a lockstep round
    assert 0 < info["syncs"]["driver.rounds"] <= info["syncs"]["sync.count"]
    if trace:
        # no card: no kernel time to read; the search driver's and the
        # frontier's counters, where the window had untraced calls
        assert set(line["metrics"]) <= {"round_ms", "pad_share", "idle_pct.assign",
                                        "packed_fixpoint_stacked_roofline", "prepare_share"}
        assert "pad_share" in line["metrics"]
        assert info["fixpoint_bound_s"] > 0
    else:
        assert info["prepare_seconds"] and all(s > 0 for s in info["prepare_seconds"])
        assert set(line["metrics"]) == {"assign_rate", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("batched", [False, True])
def test_coloring_control_is_not_correct(batched):
    assert _run(program="control", batched=batched)["correct"] is False
