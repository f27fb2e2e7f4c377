"""The port's robustness fabric against the reference: seeded fault plans,
retry and fallback recovery, the round watchdog, load shedding, and the chaos
drills — every future resolves under injected faults, and every verdict that
IS produced equals the reference's fault-free sequential `mac_solve`.
"""

import numpy as np
import pytest
import torch

from repro import faults as ref_faults
from repro.core import mac_solve as ref_mac_solve
from repro.service import poisson_trace as ref_poisson_trace

from repro_torch import faults
from repro_torch.problems import generate
from repro_torch.service import (
    FastForwardClock,
    InvalidRequest,
    RequestStatus,
    SolverService,
    poisson_trace,
    replay,
)

CPU = torch.device("cpu")
#: shortened backoffs so recovery tests run in milliseconds of trace time
FAST = {"backoff_base_s": 0.01, "backoff_cap_s": 0.05}


def _oracle(events, ref_events):
    """The reference's fault-free sequential `mac_solve` of every event; the
    two packages' traces are the same events."""
    assert [(e.t, e.family, e.seed) for e in events] == \
        [(e.t, e.family, e.seed) for e in ref_events]
    return [ref_mac_solve(ev.build(), engine="einsum") for ev in ref_events]


def _trace(families, rate, duration, seed):
    events = poisson_trace(families, rate=rate, duration=duration, seed=seed)
    return events, _oracle(events, ref_poisson_trace(families, rate=rate, duration=duration,
                                                     seed=seed))


def _ref_solution(family, seed, **knobs):
    from repro.problems import generate as ref_generate

    return ref_mac_solve(ref_generate(family, seed=seed, **knobs), engine="einsum")[0]


# --- plan / recipe layer ------------------------------------------------------


def test_recipes_parse_as_the_reference_does():
    assert faults.KNOWN_SITES == ref_faults.KNOWN_SITES
    for recipe in ("all:0.05", "all:0.05,round.resolve:0.2:garbage:3",
                   "frontier.step:0.1:oom", "cache.lookup:1.0:fault:2"):
        got, want = faults.parse_recipe(recipe), ref_faults.parse_recipe(recipe)
        assert {k: (s.rate, s.kind, s.max_fires) for k, s in got.items()} == \
            {k: (s.rate, s.kind, s.max_fires) for k, s in want.items()}
    for bad in ("", "kernel.launch", "nope.site:0.5", "cache.lookup:2.0",
                "cache.lookup:0.5:weird", "cache.lookup:0.5:fault:-1"):
        with pytest.raises(ValueError):
            faults.parse_recipe(bad)


@pytest.mark.parametrize("recipe,seed", [("all:0.3", 7), ("all:0.05", 0),
                                         ("kernel.launch:0.5:oom:3", 2)])
def test_fire_patterns_match_the_reference(recipe, seed):
    """Whether the k-th crossing of a site fires is the same pure function of
    (recipe, seed, k) in both packages."""
    plan = faults.FaultPlan(faults.parse_recipe(recipe), seed=seed)
    ref_plan = ref_faults.FaultPlan(ref_faults.parse_recipe(recipe), seed=seed)
    for k in range(40):
        for site in faults.KNOWN_SITES:
            assert plan.roll(site) == ref_plan.roll(site), (site, k)
    assert plan.fires == ref_plan.fires


def test_off_by_default_and_typed_errors():
    assert not faults.enabled()
    faults.inject("kernel.launch")  # no plan: a silent no-op
    with faults.injected("cache.lookup:1.0:stale") as plan:
        assert faults.active() is plan
        with pytest.raises(faults.StaleSchedule) as ei:
            faults.inject("cache.lookup", fingerprint="abc")
        assert ei.value.site == "cache.lookup" and "abc" in str(ei.value)
    assert not faults.enabled()
    assert issubclass(faults.OomError, MemoryError)
    assert not issubclass(faults.Overloaded, faults.FaultError)


# --- submit validation and load shedding -------------------------------------


def test_submit_validation_rejects_garbage_eagerly():
    svc = SolverService(engine="einsum", device=CPU)
    good = generate("nqueens", n=8, device=CPU)

    class Junk:
        dom = torch.ones(7, dtype=torch.bool)  # not 2-D

    with pytest.raises(InvalidRequest):
        svc.submit(Junk())
    with pytest.raises(InvalidRequest):
        svc.submit(good, deadline_s=float("inf"))
    with pytest.raises(InvalidRequest):
        svc.submit(good, deadline_s=-1.0)
    with pytest.raises(InvalidRequest):
        svc.submit(good, max_assignments=0)
    req = svc.submit(good)  # still healthy after rejecting garbage
    sol, _ = req.result()
    assert sol == _ref_solution("nqueens", 0, n=8)


def test_queue_depth_shed_returns_typed_overloaded():
    clock = FastForwardClock()
    svc = SolverService(engine="hopper_packed", device=CPU, clock=clock, shed_queue_depth=2)
    reqs = [svc.submit(generate("nqueens", n=8, seed=(0, i), device=CPU)) for i in range(6)]
    shed = [r for r in reqs if r.status is RequestStatus.SHED]
    kept = [r for r in reqs if r.status is not RequestStatus.SHED]
    assert shed and len(kept) >= 2  # the burst beyond the bound was refused
    for r in shed:
        assert isinstance(r.error, faults.Overloaded)
        assert r.error.retry_after_s > 0
        assert r.done() and r.solution is None
    svc.run_until_idle()
    want = _ref_solution("nqueens", 0, n=8)
    assert all(r.status is RequestStatus.DONE and r.solution == want for r in kept)
    assert svc.snapshot()["shed"] == len(shed)


# --- round watchdog -----------------------------------------------------------


@pytest.mark.parametrize("engine", ["einsum", "hopper_dense"])
def test_watchdog_recurrence_bound_quarantines_as_failed(engine):
    svc = SolverService(engine=engine, device=CPU, round_recurrences=1)
    req = svc.submit(generate("model_rb", n=10, hardness=1.0, seed=(5, 0), device=CPU))
    req.result()
    assert req.status is RequestStatus.FAILED
    assert isinstance(req.error, faults.FaultError)
    assert req.error.site == "round.watchdog"
    assert "recurrence depth" in str(req.error)
    snap = svc.snapshot()
    assert snap["failed"] == 1
    for b in snap["buckets"].values():
        assert b["active"] == 0
    assert all(e.pins == 0 for e in svc.cache._entries.values())


def test_watchdog_bounds_validated():
    with pytest.raises(ValueError):
        SolverService(engine="einsum", device=CPU, round_wall_s=0.0)
    with pytest.raises(ValueError):
        SolverService(engine="einsum", device=CPU, round_recurrences=0)


# --- fallback ladder ----------------------------------------------------------


@pytest.mark.parametrize("engine", ["full", "hopper_packed", "hopper_dense"])
def test_demotion_to_success_keeps_verdicts_correct(engine):
    """retry_cap=0 + one kernel fault: the faulted requests demote a rung
    down the ladder (fused → stepped on the Hopper engines, full → einsum)
    and still land the fault-free verdict."""
    seeds = [(3, i) for i in range(4)]
    csps = [generate("model_rb", n=10, hardness=1.0, seed=s, device=CPU) for s in seeds]
    with faults.injected("kernel.launch:1.0:oom:1", seed=1):
        svc = SolverService(engine=engine, device=CPU, retry_cap=0, **FAST)
        reqs = [svc.submit(c) for c in csps]
        svc.run_until_idle()
    snap = svc.snapshot()
    assert snap["demotions"] > 0
    assert snap["failed"] == 0 and snap["shed"] == 0
    assert any(key.endswith("@L1") for key in snap["buckets"])  # the next rung ran
    assert snap["engine_ladder"][1] == (engine if engine.startswith("hopper") else "einsum")
    for req, s in zip(reqs, seeds):
        assert req.status is RequestStatus.DONE
        assert req.solution == _ref_solution("model_rb", s, n=10, hardness=1.0)


@pytest.mark.parametrize("engine", ["full", "hopper_packed"])
def test_breaker_trips_floor_the_bucket(engine):
    """K consecutive faulted rounds on one bucket trip its circuit breaker:
    later admissions of that bucket start at the demoted level directly."""
    csp = generate("model_rb", n=10, hardness=1.0, seed=(9, 0), device=CPU)
    with faults.injected("round.resolve:1.0:garbage:4", seed=0):
        svc = SolverService(engine=engine, device=CPU, retry_cap=8, breaker_threshold=2,
                            **FAST)
        req = svc.submit(csp)
        req.result()
    snap = svc.snapshot()
    assert snap["breaker_trips"] >= 1
    assert snap["bucket_floor"]
    assert req.status is RequestStatus.DONE
    assert req.solution == _ref_solution("model_rb", (9, 0), n=10, hardness=1.0)


# --- chaos parity (the acceptance gate) ---------------------------------------

#: trace seconds a service round takes on `_RoundClock`: the mean of a step of
#: this replay on `einsum` on an unloaded host (5.5 ms; 1.8 on hopper_packed)
ROUND_S = 0.005


class _RoundClock(FastForwardClock):
    """Trace time that moves only by ``round_s`` each service step and by
    the replay's jumps over idle gaps, so how many requests share a round
    does not depend on the host's pace."""

    def __init__(self, round_s: float):
        self._t, self._round_s = 0.0, round_s

    def __call__(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        self._t = max(self._t, t)

    def tick(self) -> None:
        self._t += self._round_s


class _Rounds:
    """A service as `replay` drives it, its `_RoundClock` ticking after
    every step."""

    def __init__(self, service, clock: _RoundClock):
        self._service, self._clock = service, clock

    def __getattr__(self, name):
        return getattr(self._service, name)

    def step(self):
        try:
            return self._service.step()
        finally:
            self._clock.tick()


@pytest.mark.parametrize("engine", ["einsum", "hopper_packed"])
def test_chaos_parity_every_site_five_percent(engine):
    """A mixed replay with EVERY site injecting at 5% resolves 100% of its
    futures, and every DONE verdict (solution AND search stats) equals the
    reference's fault-free sequential mac_solve."""
    events, oracle = _trace(["model_rb", "coloring_random"], 12.0, 3.0, 0)
    with faults.injected("all:0.05", seed=0) as plan:
        clock = _RoundClock(ROUND_S)
        svc = SolverService(engine=engine, device=CPU, clock=clock, retry_cap=3, **FAST)
        reqs = replay(_Rounds(svc, clock), events, clock)
    assert plan.total_fires > 0  # the drill actually injected
    assert all(r.done() for r in reqs)  # liveness: no future left behind
    snap = svc.snapshot()
    assert snap["completed"] + snap["failed"] + snap["shed"] == snap["submitted"] == len(reqs)
    n_done = 0
    for req, (ref_sol, ref_st) in zip(reqs, oracle):
        if req.status is not RequestStatus.DONE:
            assert req.status is RequestStatus.FAILED
            assert isinstance(req.error, faults.FaultError)
            continue
        n_done += 1
        assert req.solution == ref_sol
        assert req.stats.n_assignments == ref_st.n_assignments
        assert req.stats.n_backtracks == ref_st.n_backtracks
        assert req.stats.recurrences == ref_st.recurrences
        assert req.stats.revisions == ref_st.revisions
    assert n_done > len(reqs) // 2  # recovery carried the bulk to verdicts
    for b in snap["buckets"].values():
        assert b["active"] == 0
        if b.get("device_frontier"):
            assert b["frontier_rows_live"] == 0
    assert all(e.pins == 0 for e in svc.cache._entries.values())


@pytest.mark.parametrize("site", faults.KNOWN_SITES)
def test_single_site_chaos_parity(site):
    """Each site alone at a high rate (bounded fires): the recovery path for
    that boundary preserves verdict parity."""
    events, oracle = _trace(["model_rb"], 8.0, 1.5, 2)
    with faults.injected(f"{site}:0.5:fault:3", seed=3):
        clock = FastForwardClock()
        svc = SolverService(engine="hopper_packed", device=CPU, clock=clock, retry_cap=4,
                            **FAST)
        reqs = replay(svc, events, clock)
    assert all(r.done() for r in reqs)
    for req, (ref_sol, ref_st) in zip(reqs, oracle):
        assert req.status is RequestStatus.DONE, (site, req.status, req.error)
        assert req.solution == ref_sol
        assert req.stats.recurrences == ref_st.recurrences


def test_device_frontier_chaos_frees_all_rows():
    """Faults on the device-resident frontier path: recovery plus the
    fallback ladder return every frontier row once the replay drains."""
    events, oracle = _trace(["model_rb"], 6.0, 1.5, 6)
    with faults.injected("frontier.step:0.3:fault:2,kernel.launch:0.3:oom:2", seed=7):
        clock = FastForwardClock()
        svc = SolverService(engine="hopper_dense", device=CPU, clock=clock, retry_cap=4,
                            **FAST)
        reqs = replay(svc, events, clock)
    assert all(r.done() for r in reqs)
    for req, (ref_sol, _) in zip(reqs, oracle):
        if req.status is RequestStatus.DONE:
            assert req.solution == ref_sol
    for b in svc.snapshot()["buckets"].values():
        assert b["active"] == 0
        if b.get("device_frontier"):
            assert b["frontier_rows_live"] == 0
    assert all(e.pins == 0 for e in svc.cache._entries.values())


def test_garbage_and_oom_kinds_recover_like_faults():
    events, oracle = _trace(["model_rb"], 8.0, 1.5, 4)
    recipe = "round.resolve:0.3:garbage:2,slot.install:0.3:oom:2"
    with faults.injected(recipe, seed=5):
        clock = FastForwardClock()
        svc = SolverService(engine="hopper_packed", device=CPU, clock=clock, retry_cap=4,
                            **FAST)
        reqs = replay(svc, events, clock)
    assert all(r.done() for r in reqs)
    for req, (ref_sol, _) in zip(reqs, oracle):
        assert req.status is RequestStatus.DONE
        assert req.solution == ref_sol
    np.testing.assert_equal(svc.snapshot()["failed"], 0)
