"""The port's own `obs`: the off path, the per-name totals, the spans'
mirror on a recording `torch.profiler`, and the spans and sync marks of the
fixpoint and search paths (``fixpoint.recurrence``, ``sync.wait``,
``driver.round`` with ``frontier.step`` and ``round.resolve``). Everything
runs on the CPU; the sync counts are derived from the recurrences and
rounds the searches report, not from the spans."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import engine as engine_mod
from repro_torch.core import mac_solve, rtac, search, solve_many
from repro_torch.engines import get_engine
from repro_torch.obs import tracing
from repro_torch.problems import generate_batch

CPU = torch.device("cpu")
WORKLOAD = dict(n=12, hardness=0.9, seed=1)
BUDGET = 300


@pytest.fixture
def tracer():
    """A fresh tracer for the test, switched off after it."""
    t = obs.enable()
    yield t
    obs.disable()


def _count(name):
    return obs.REGISTRY.counter(name)


def _names(t):
    return [s.name for s in t.spans]


def _ancestors(t, span):
    by_sid = {s.sid: s for s in t.spans}
    out, parent = [], span.parent
    while parent:
        s = by_sid[parent]
        out.append(s.name)
        parent = s.parent
    return out


def _user_annotations(prof):
    return {e.name: e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation}


# --- the off path -------------------------------------------------------------


@pytest.mark.parametrize("mark", ["span", "sync_wait"])
def test_off_path_is_the_shared_null_context_and_sync_count_still_counts(mark):
    obs.disable()
    before = _count("sync.count")
    ctx = obs.span("test.off") if mark == "span" else obs.sync_wait(rows=3)
    assert ctx is tracing._NULL_SPAN
    with ctx as s:
        assert s is None
    assert obs.get_tracer() is None
    assert _count("sync.count") - before == (1 if mark == "sync_wait" else 0)


def test_sync_wait_on_is_a_span_and_a_count(tracer):
    before = _count("sync.count")
    with obs.sync_wait(rows=2) as s:
        assert s.name == "sync.wait" and s.args == {"rows": 2}
    assert _count("sync.count") - before == 1
    assert _names(tracer) == ["sync.wait"]
    assert tracer.snapshot_totals()["sync.wait"][0] == 1


# --- per-name totals ----------------------------------------------------------


def test_totals_count_every_span_past_the_ring():
    clock = iter(float(i) for i in range(100))
    t = tracing.Tracer(capacity=2, clock=lambda: next(clock))
    for _ in range(3):
        outer = t.begin("a")
        t.end(t.begin("b"))  # 1 s
        t.end(outer)  # 3 s
    t.record_complete("c", 0.0, 0.5)
    assert t.dropped == 5 and len(t.spans) == 2
    assert t.snapshot_totals() == {"a": (3, 9.0), "b": (3, 3.0), "c": (1, 0.5)}


def test_totals_snapshot_is_a_copy(tracer):
    with obs.span("x"):
        pass
    snap = tracer.snapshot_totals()
    with obs.span("x"):
        pass
    assert snap["x"][0] == 1 and tracer.snapshot_totals()["x"][0] == 2


# --- the mirror on the profiler's clock ------------------------------------------


def test_span_under_a_profiler_is_a_user_annotation_that_brackets_its_child(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.outer"):
            with obs.span("test.inner"):
                torch.ones(4).add_(1)
    marks = _user_annotations(prof)
    outer, inner = marks["test.outer"].time_range, marks["test.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert _names(tracer) == ["test.inner", "test.outer"]


@pytest.mark.parametrize("case", ["tracer_off", "after_stop"])
def test_no_annotation_without_the_tracer_or_after_the_profiler_stops(case):
    obs.disable()
    if case == "after_stop":
        obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as first:
            with obs.span("test.during"):
                torch.ones(2)
        with obs.span("test.after"):
            torch.ones(2)
        with profile(activities=[ProfilerActivity.CPU]) as second:
            torch.ones(2)
        names = set(_user_annotations(first)) | set(_user_annotations(second))
        if case == "tracer_off":
            assert not names & {"test.during", "test.after"}
        else:
            assert "test.during" in names and "test.after" not in names
            assert obs.get_tracer().snapshot_totals()["test.after"][0] == 1
    finally:
        obs.disable()


# --- the fixpoint: one sync a recurrence and one before ------------------------


def _batch(seed, b=6, n=10, d=5):
    rng = np.random.default_rng(seed)
    cons = rng.random((n, n, d, d)) > 0.35
    mask = np.triu(rng.random((n, n)) < 0.5, 1)
    mask = mask | mask.T
    cons = cons & mask[:, :, None, None]
    cons = cons | np.swapaxes(np.swapaxes(cons, 0, 1), 2, 3)
    dom = rng.random((b, n, d)) > 0.2
    return (torch.from_numpy(cons), torch.from_numpy(mask), torch.from_numpy(dom))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fixpoint_rows_syncs_k_max_plus_one_and_spans_k_max(tracer, seed):
    cons, mask, dom = _batch(seed)
    if seed == 3:
        dom[:, 0] = False  # every row wiped out from the start: no recurrence
    before = _count("sync.count")
    res = rtac.enforce_batch(cons, mask, dom)
    k_max = int(res.n_recurrences.max())
    assert (k_max == 0) == (seed == 3)
    totals = tracer.snapshot_totals()
    assert _count("sync.count") - before == k_max + 1
    assert totals["sync.wait"][0] == k_max + 1
    assert totals.get("fixpoint.recurrence", (0, 0.0))[0] == k_max
    # every predicate after the first is read inside its recurrence
    waits = [s for s in tracer.spans if s.name == "sync.wait"]
    assert sum(_ancestors(tracer, s)[:1] == ["fixpoint.recurrence"] for s in waits) == k_max


# --- the search driver's rounds ------------------------------------------------------


def _spy_extract(monkeypatch, tracer, cls):
    """Record the open spans at every closure extraction: the coroutine's
    one call into the store, at its solution."""
    stacks = []
    real = cls.extract

    def extract(self, key, handle):
        stacks.append([s.name for s in tracer._stack])
        return real(self, key, handle)

    monkeypatch.setattr(cls, "extract", extract)
    return stacks


def _round_spans_hold(tracer):
    rounds = [s for s in tracer.spans if s.name == "driver.round"]
    for s in tracer.spans:
        if s.name in ("sync.wait", "frontier.step", "round.resolve", "kernel.launch"):
            assert "driver.round" in _ancestors(tracer, s), s.name
        if s.name == "kernel.launch":
            assert _ancestors(tracer, s)[0] == "frontier.step"
            assert s.args["fenced"] is False
    return rounds


@pytest.mark.parametrize("name,opts", [("einsum", {}),
                                       ("hopper_packed", {"fixpoint": "fused"})])
def test_solve_many_round_spans_and_syncs(tracer, monkeypatch, name, opts):
    csps = generate_batch("model_rb", 4, device=CPU, **WORKLOAD)
    eng = get_engine(name, device=CPU, **opts)
    stacks = _spy_extract(monkeypatch, tracer, engine_mod.FrontierTable)
    before, tel = _count("sync.count"), {}
    sols, _stats = solve_many(csps, engine=eng, max_assignments=BUDGET, telemetry=tel)
    solved = sum(s is not None for s in sols)
    assert solved and len(stacks) == solved
    assert all("round.resolve" in st and "driver.round" in st for st in stacks)
    rounds = _round_spans_hold(tracer)
    # pipelined: the last round is resolved by one more call with no dispatch
    assert len(rounds) == tel["rounds"] + 1
    totals = tracer.snapshot_totals()
    assert totals["search.prepare"][0] == 1
    assert totals["frontier.step"][0] == totals["round.resolve"][0] == tel["rounds"]
    # a round: its metadata's read; the host-loop fixpoint (einsum) also
    # reads its predicate once a recurrence of the deepest row and once more
    loop = 0 if eng.fused_fixpoint else tel["launches"] + tel["rounds"]
    assert _count("sync.count") - before == tel["rounds"] + solved + loop
    assert totals["sync.wait"][0] == tel["rounds"] + solved + loop


@pytest.mark.parametrize("name,fixpoint", [
    ("einsum", None), ("hopper_packed", "fused"), ("hopper_dense", "fused"),
    ("hopper_packed", "stepped"), ("hopper_dense", "stepped"),
], ids=["einsum", "hopper_packed", "hopper_dense", "hopper_packed-stepped",
        "hopper_dense-stepped"])
def test_mac_solve_round_spans_and_syncs(tracer, monkeypatch, name, fixpoint):
    csps = generate_batch("model_rb", 2, device=CPU, **WORKLOAD)
    eng = get_engine(name, device=CPU) if fixpoint is None else get_engine(
        name, fixpoint=fixpoint, device=CPU)
    stacks = _spy_extract(monkeypatch, tracer, search.HostFrontierStore)
    n_rounds = n_launches = solved = 0
    before = _count("sync.count")
    for csp in csps:
        sol, st = mac_solve(csp, engine=eng, max_assignments=BUDGET)
        solved += sol is not None
        n_rounds += st.rounds
        n_launches += st.launches
    assert solved and len(stacks) == solved
    assert all("round.resolve" in st and "driver.round" in st for st in stacks)
    rounds = _round_spans_hold(tracer)
    assert len(rounds) == n_rounds
    totals = tracer.snapshot_totals()
    assert totals["search.prepare"][0] == len(csps)
    assert totals["frontier.step"][0] == totals["round.resolve"][0] == n_rounds
    # a round: its read-back; the host-loop fixpoint (einsum, stepped) also
    # reads its predicate once a recurrence of the deepest row (`launches`)
    # and once more, each recurrence a span; the fused kernel neither
    one_launch = fixpoint == "fused"
    loop = 0 if one_launch else n_launches + n_rounds
    assert _count("sync.count") - before == n_rounds + loop
    assert totals["sync.wait"][0] == n_rounds + loop
    assert totals.get("fixpoint.recurrence", (0,))[0] == (0 if one_launch else n_launches)
    if name != "einsum":
        assert totals["enforce.upload"][0] == n_rounds


def test_kernel_launch_records_fenced(monkeypatch):
    t = obs.enable(timing="fenced")
    try:
        csps = generate_batch("model_rb", 2, device=CPU, **WORKLOAD)
        solve_many(csps, engine=get_engine("einsum", device=CPU), max_assignments=50)
        mac_solve(csps[0], engine="einsum", max_assignments=50, device=CPU)
    finally:
        obs.disable()
    launches = [s for s in t.spans if s.name == "kernel.launch"]
    assert launches and all(s.args["fenced"] is True for s in launches)


def test_the_frontier_gauges_are_gone():
    csps = generate_batch("model_rb", 2, device=CPU, **WORKLOAD)
    solve_many(csps, engine=get_engine("einsum", device=CPU), max_assignments=50)
    assert not {"frontier.rows_live", "frontier.capacity"} & set(obs.snapshot()["gauges"])
