"""The port's solver service against the reference.

The same seeded requests go through `repro_torch.service.SolverService` (on
the CPU, where the Hopper engines' kernel wrappers run their plain versions)
and through the reference's sequential `mac_solve`: every request's solution
and search statistics must be identical, under staggered admission, mixed
families and shapes, and searches joining and leaving rounds mid-flight. The
buckets, padding, fingerprints, traces, slot pools, cache and the traced
export are held against `repro.service` and `repro.obs` as well.
"""

import json

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import mac_solve as ref_mac_solve
from repro.launch.serve import serve as ref_serve
from repro.problems import generate as ref_generate
from repro.service import (
    bucket_for as ref_bucket_for,
    dedup_trace as ref_dedup_trace,
    network_fingerprint as ref_network_fingerprint,
    pad_csp as ref_pad_csp,
    poisson_trace as ref_poisson_trace,
)

import repro_torch.core.engine as engine_mod
from repro_torch import obs
from repro_torch.core import check_solution
from repro_torch.engines import get_engine
from repro_torch.launch.serve import serve
from repro_torch.problems import generate, generate_batch
from repro_torch.service import (
    Bucket,
    FastForwardClock,
    PreparedNetworkCache,
    RequestStatus,
    SolverService,
    bucket_for,
    dedup_trace,
    network_fingerprint,
    pad_csp,
    poisson_trace,
    replay,
)

CPU = torch.device("cpu")

#: the reference engine whose sequential `mac_solve` is each port engine's
#: oracle (the reference's fused Pallas path does not run under this jax;
#: its `mac_solve` runs the single-network revise kernels)
REF_ENGINE = {"einsum": "einsum", "ac3": "ac3",
              "hopper_packed": "pallas_packed", "hopper_dense": "pallas_dense"}


def _assert_matches_reference(req, family, knobs, seed, engine="einsum", **kw):
    """``req`` (the port's service) equals the reference's sequential
    `mac_solve` on the same seeded instance."""
    ref_sol, ref_st = ref_mac_solve(ref_generate(family, seed=seed, **knobs),
                                    engine=REF_ENGINE[engine], **kw)
    assert req.status is RequestStatus.DONE
    assert req.solution == ref_sol
    assert req.stats.n_assignments == ref_st.n_assignments
    assert req.stats.n_backtracks == ref_st.n_backtracks
    assert req.stats.recurrences == ref_st.recurrences
    assert req.stats.revisions == ref_st.revisions
    assert req.stats.exhausted == ref_st.exhausted


def _batch(family, count, seed, **knobs):
    """(family, knobs, seed) of instance i of a seeded batch, and the port's CSPs."""
    specs = [(family, knobs, (seed, i)) for i in range(count)]
    return specs, generate_batch(family, count, seed=seed, device=CPU, **knobs)


# --- continuous-batching parity ----------------------------------------------


def test_staggered_admission_matches_reference_mixed_families():
    """Requests arriving mid-flight across two buckets: results and stats are
    those of the reference's sequential mac_solve on every instance."""
    rb_specs, rb = _batch("model_rb", 6, 5, n=10, hardness=1.0)
    col_specs, col = _batch("coloring_random", 4, 1, n=12, edge_prob=0.3, k=3)
    svc = SolverService(engine="einsum", device=CPU, initial_slots=2)

    reqs = [svc.submit(c) for c in rb[:3]]
    svc.step()
    svc.step()  # first wave is mid-search when the second wave arrives
    reqs += [svc.submit(c) for c in rb[3:] + col]
    svc.run_until_idle()

    outcomes = set()
    for req, csp, spec in zip(reqs, rb + col, rb_specs + col_specs):
        _assert_matches_reference(req, *spec)
        if req.solution is not None:
            assert check_solution(csp, req.solution)
        outcomes.add(req.solution is not None)
    assert outcomes == {True, False}  # the mix straddles SAT and UNSAT


@pytest.mark.parametrize("engine", ["einsum", "ac3", "hopper_packed", "hopper_dense"])
def test_service_matches_reference_and_routes_per_engine(engine, monkeypatch):
    """Staggered admission on every engine: each request equals the
    reference's sequential mac_solve. The Hopper engines make ZERO
    `route_rows_on_host` calls — every round runs against the stacked slot
    table; AC3 rides the generic host-routing pool."""
    calls = []
    real = engine_mod.route_rows_on_host

    def counting(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(engine_mod, "route_rows_on_host", counting)
    specs, csps = _batch("model_rb", 3, 5, n=10, hardness=1.0)
    q_spec, queens = ("nqueens", {"n": 6}, 0), generate("nqueens", n=6, device=CPU)
    svc = SolverService(engine=engine, device=CPU, initial_slots=2)
    reqs = [svc.submit(c) for c in csps[:2]]
    svc.step()  # first wave mid-flight when the rest arrives
    reqs += [svc.submit(csps[2]), svc.submit(queens)]
    svc.run_until_idle()
    for req, spec in zip(reqs, specs + [q_spec]):
        _assert_matches_reference(req, *spec, engine=engine)
    if engine.startswith("hopper"):
        assert calls == []  # device-resident slot table: zero host routing
        assert all(info["device_frontier"] for info in svc.snapshot()["buckets"].values())
    elif engine == "ac3":
        assert calls  # the generic pool routes every row on the host


def test_single_request_future_api():
    csp = generate("nqueens", n=8, device=CPU)
    svc = SolverService(engine="einsum", device=CPU)
    req = svc.submit(csp)
    assert not req.done()
    sol, stats = req.result()  # drives the event loop
    assert req.done() and req.status is RequestStatus.DONE
    _assert_matches_reference(req, "nqueens", {"n": 8}, 0)
    assert req.latency_s is not None and req.latency_s >= 0
    assert sol is not None and check_solution(csp, sol)
    assert stats is req.stats


def test_per_request_assignment_budget():
    csp = generate("pigeonhole", n=7, device=CPU)  # hard UNSAT: the budget must bite
    svc = SolverService(engine="einsum", device=CPU)
    req = svc.submit(csp, max_assignments=5)
    sol, stats = req.result()
    assert sol is None
    assert stats.exhausted  # budget-capped is inconclusive, NOT a proof of UNSAT
    _assert_matches_reference(req, "pigeonhole", {"n": 7}, 0, max_assignments=5)


def test_unsat_without_budget_is_not_exhausted():
    svc = SolverService(engine="einsum", device=CPU)
    req = svc.submit(generate("pigeonhole", n=5, device=CPU))
    sol, stats = req.result()
    assert sol is None and not stats.exhausted  # genuine UNSAT proof
    _assert_matches_reference(req, "pigeonhole", {"n": 5}, 0)


def test_deadline_expires_only_the_late_request():
    clock = FastForwardClock()
    svc = SolverService(engine="einsum", device=CPU, clock=clock)
    hard = svc.submit(generate("pigeonhole", n=8, device=CPU), deadline_s=0.0)
    easy = svc.submit(generate("nqueens", n=8, device=CPU))
    svc.run_until_idle()
    assert hard.status is RequestStatus.TIMED_OUT and hard.solution is None
    _assert_matches_reference(easy, "nqueens", {"n": 8}, 0)


def test_cancel_frees_cache_pin():
    svc = SolverService(engine="einsum", device=CPU)
    req = svc.submit(generate("pigeonhole", n=8, device=CPU))
    svc.step()  # admitted + pinned
    entry = svc.cache.lookup(req.bucket, req.fingerprint)
    assert entry is not None and entry.pins == 1
    assert svc.cancel(req) and req.status is RequestStatus.CANCELLED
    assert entry.pins == 0
    assert not svc.cancel(req)  # already terminal
    svc.run_until_idle()


# --- traces ------------------------------------------------------------------


def test_traces_match_reference():
    """Event times, families, knobs and instance seeds are drawn identically,
    and each event builds the reference's network byte for byte."""
    for got, want in (
        (poisson_trace(["model_rb", "coloring_random", "sudoku"], rate=10.0, duration=2.0,
                       seed=3),
         ref_poisson_trace(["model_rb", "coloring_random", "sudoku"], rate=10.0,
                           duration=2.0, seed=3)),
        (dedup_trace(["model_rb", "nqueens"], rate=10.0, duration=2.0, seed=1, pool_size=2),
         ref_dedup_trace(["model_rb", "nqueens"], rate=10.0, duration=2.0, seed=1,
                         pool_size=2)),
    ):
        assert [(e.t, e.family, e.knobs, e.seed) for e in got] == \
            [(e.t, e.family, e.knobs, e.seed) for e in want]
        for e, r in zip(got[:4], want[:4]):
            assert network_fingerprint(e.build(CPU)) == ref_network_fingerprint(r.build())


def test_trace_replay_completes_and_measures():
    events = poisson_trace(["model_rb", "coloring_random"], rate=10.0, duration=1.5, seed=0)
    assert events and all(e.t < 1.5 for e in events)
    clock = FastForwardClock()
    svc = SolverService(engine="hopper_packed", device=CPU, clock=clock)
    requests = replay(svc, events, clock)
    assert len(requests) == len(events)
    for req, ev in zip(requests, events):
        _assert_matches_reference(req, ev.family, ev.knobs, ev.seed, engine="hopper_packed")
    snap = svc.snapshot()
    assert snap["completed"] == len(events)
    assert snap["throughput_rps"] > 0
    assert 0 <= snap["p50_ms"] <= snap["p95_ms"] <= snap["p99_ms"]
    assert snap["mean_rows_per_dispatch"] >= 1.0


# --- slot pools ----------------------------------------------------------------


def test_slot_table_advertisement_routes_pool_kind():
    """Engines advertise slot-table support; the pool kind follows the
    advertisement, and a stacked pool's tables live on the engine's device."""
    for name in ("einsum", "full", "hopper_dense", "hopper_packed"):
        eng = get_engine(name, device=CPU)
        assert eng.slot_table
        pool = eng.open_slot_pool(8, 4, 2)
        assert pool.stacked
        assert all(t.device == CPU and t.shape[0] == 2 and not t.any() for t in pool.tables)
    eng = get_engine("ac3", device=CPU)
    assert not eng.slot_table
    assert not eng.open_slot_pool(8, 4, 2).stacked


@pytest.mark.parametrize("engine", ["einsum", "hopper_packed", "hopper_dense"])
def test_slot_pool_grow_preserves_resident_networks(engine):
    """`SlotPool.grow` keeps installed networks intact (results identical
    before/after), opens usable new slots, and refuses to shrink."""
    csps = generate_batch("model_rb", 3, n=10, hardness=0.9, seed=3, device=CPU)
    d = csps[0].dom.shape[1]
    eng = get_engine(engine, device=CPU)
    pool = eng.open_slot_pool(10, d, 2)
    pool.install(0, csps[0])
    pool.install(1, csps[1])
    doms = np.stack([c.dom.numpy() for c in csps[:2]])
    before = pool.enforce_rows(doms, slot_idx=np.array([0, 1]))
    tables_before = [t.clone() for t in pool.tables]
    bytes_before = pool.resident_nbytes

    pool.grow(4)
    assert pool.capacity == 4
    for old, new in zip(tables_before, pool.tables):
        assert new.shape[0] == 4
        assert torch.equal(new[:2], old) and not new[2:].any()  # empty slots stay zero
    after = pool.enforce_rows(doms, slot_idx=np.array([0, 1]))
    assert torch.equal(before.dom, after.dom)
    assert torch.equal(before.n_recurrences, after.n_recurrences)
    assert pool.resident_nbytes == 2 * bytes_before  # the whole table is counted

    pool.install(3, csps[2])  # a newly grown slot is immediately usable
    got = pool.enforce_rows(csps[2].dom[None], slot_idx=np.array([3]))
    ref = eng.prepare(csps[2]).enforce()
    assert bool(got.consistent[0]) == bool(ref.consistent)
    if bool(ref.consistent):
        assert torch.equal(got.dom[0], ref.dom)

    with pytest.raises(ValueError, match="cannot shrink"):
        pool.grow(2)
    with pytest.raises(ValueError, match="empty"):
        pool.enforce_rows(doms[:1], slot_idx=np.array([2]))


@pytest.mark.parametrize("engine", ["hopper_packed", "hopper_dense"])
def test_slot_pool_install_keeps_one_copy_of_the_network(engine):
    """A slot install writes the padded network into the table and keeps no
    memoized copy of it; `prepare` of the same CSP still memoizes, and its
    network equals the slot's."""
    from repro_torch.kernels import ops

    csp = generate("model_rb", seed=5, n=10, hardness=0.9, device=CPU)
    eng = get_engine(engine, device=CPU)
    pool = eng.open_slot_pool(10, csp.dom.shape[1], 2)
    key = (id(csp.cons), id(csp.mask))
    memoized = lambda: [k for k in ops._NETWORK_CACHE if k[3:] == key]  # noqa: E731
    pool.install(1, csp)
    assert memoized() == []
    net = eng.prepare(csp).payload[0]
    assert len(memoized()) == 1
    for t, v in zip(pool.tables, net):
        assert torch.equal(t[1], v) and not t[0].any()


def test_slot_pool_grows_beyond_initial_capacity():
    specs, csps = _batch("model_rb", 5, 9, n=10, hardness=0.8)
    svc = SolverService(engine="hopper_dense", device=CPU, initial_slots=1)
    reqs = [svc.submit(c) for c in csps]
    svc.run_until_idle()
    for req, spec in zip(reqs, specs):
        _assert_matches_reference(req, *spec, engine="hopper_dense")
    (bucket_info,) = svc.snapshot()["buckets"].values()
    assert bucket_info["capacity"] >= 5


def test_ladder_rungs_follow_the_primary_device():
    """Every rung of the fallback ladder runs on the primary engine's device,
    and a Hopper primary demotes fused → stepped → einsum."""
    svc = SolverService(engine="hopper_packed", device=CPU)
    assert [e.name for e in svc._ladder] == ["hopper_packed", "hopper_packed", "einsum"]
    assert [getattr(e, "fixpoint", None) for e in svc._ladder] == ["fused", "stepped", None]
    assert all(e.device == CPU for e in svc._ladder)
    eng = get_engine("hopper_dense", fixpoint="stepped", device=CPU)
    svc = SolverService(engine=eng)  # an instance keeps its own device
    assert svc.device == CPU and [e.name for e in svc._ladder] == ["hopper_dense", "einsum"]
    assert all(e.device == CPU for e in svc._ladder)


# --- prepared-network cache ------------------------------------------------------


def test_packed_byte_accounting_admits_8x_more_networks():
    """The LRU budget counts the ENGINE's resident bytes: on the same budget,
    packed-word accounting holds 8 resident networks where the logical
    (unpacked bool) accounting holds exactly one."""
    n, d = 16, 32  # d = 32: one full word per variable, no packing waste
    packed = get_engine("hopper_packed", device=CPU).network_nbytes(n, d)
    unpacked = get_engine("einsum", device=CPU).network_nbytes(n, d)
    budget = 8 * packed
    assert budget // unpacked == 1  # unpacked accounting: ONE network fits

    evicted = []
    cache = PreparedNetworkCache(budget, on_evict=evicted.append)
    for i in range(8):
        entry, hit = cache.acquire(Bucket(n, d), f"fp{i}", packed, lambda i=i: i)
        assert not hit
        cache.release(entry)
    assert len(cache) == 8 and cache.evictions == 0  # all 8 stay resident
    assert cache.bytes_in_use <= cache.byte_budget


def test_pinned_entries_survive_accounting_pressure():
    """Eviction never touches pinned entries: over budget with everything
    pinned evicts nothing; releasing one pin makes exactly that entry
    evictable."""
    nbytes = get_engine("hopper_packed", device=CPU).network_nbytes(16, 32)
    evicted = []
    cache = PreparedNetworkCache(2 * nbytes, on_evict=evicted.append)
    e0, _ = cache.acquire(Bucket(16, 32), "fp0", nbytes, lambda: 0)
    e1, _ = cache.acquire(Bucket(16, 32), "fp1", nbytes, lambda: 1)
    e2, _ = cache.acquire(Bucket(16, 32), "fp2", nbytes, lambda: 2)
    assert cache.evictions == 0 and cache.bytes_in_use > cache.byte_budget
    cache.release(e0)  # fp0 unpinned -> the only legal victim
    e3, _ = cache.acquire(Bucket(16, 32), "fp3", nbytes, lambda: 3)
    assert [e.slot for e in evicted] == [0]
    assert cache.lookup(Bucket(16, 32), "fp0") is None
    assert all(cache.lookup(Bucket(16, 32), fp) is not None for fp in ("fp1", "fp2", "fp3"))
    for e in (e1, e2, e3):
        cache.release(e)


def test_cache_hit_shares_resident_slot():
    csp = generate("nqueens", n=8, device=CPU)  # deterministic: same network every time
    svc = SolverService(engine="hopper_packed", device=CPU)
    r1 = svc.submit(csp)
    r2 = svc.submit(csp)
    svc.step()
    entry = svc.cache.lookup(r1.bucket, r1.fingerprint)
    assert entry is not None and entry.pins == 2  # both flights share one slot
    svc.run_until_idle()
    assert svc.cache.hits == 1 and svc.cache.misses == 1
    assert entry.pins == 0  # warm but unpinned after both retire
    _assert_matches_reference(r1, "nqueens", {"n": 8}, 0, engine="hopper_packed")
    _assert_matches_reference(r2, "nqueens", {"n": 8}, 0, engine="hopper_packed")


def test_cache_eviction_never_evicts_inflight_network():
    """Byte budget of ~2 networks under 4 concurrent distinct networks: the
    cache must run over budget rather than evict anything pinned."""
    specs, csps = _batch("model_rb", 4, 5, n=10, hardness=0.8)
    bucket = bucket_for(10, csps[0].dom.shape[1])
    svc = SolverService(engine="einsum", device=CPU, cache_bytes=2 * bucket.network_nbytes + 1)
    reqs = [svc.submit(c) for c in csps]
    svc.step()  # all four admitted concurrently, all pinned
    entries = [svc.cache.lookup(r.bucket, r.fingerprint) for r in reqs]
    assert all(e is not None and e.pins == 1 for e in entries)
    assert svc.cache.evictions == 0  # over budget, but everything is in flight
    assert svc.cache.bytes_in_use > svc.cache.byte_budget
    svc.run_until_idle()
    for req, spec in zip(reqs, specs):
        _assert_matches_reference(req, *spec)

    # once unpinned, a new distinct admission DOES evict LRU entries
    more_specs, more = _batch("model_rb", 2, 77, n=10, hardness=0.8)
    extra = [svc.submit(c) for c in more]
    svc.run_until_idle()
    assert svc.cache.evictions > 0
    assert svc.cache.lookup(reqs[0].bucket, reqs[0].fingerprint) is None  # LRU gone
    for req, spec in zip(extra, more_specs):
        _assert_matches_reference(req, *spec)


def test_evicted_slot_is_reused():
    cache_calls = []
    cache = PreparedNetworkCache(100, on_evict=lambda e: cache_calls.append(e.slot))
    e1, hit = cache.acquire(Bucket(8, 4), "fp1", 60, lambda: 0)
    assert not hit and e1.pins == 1
    cache.release(e1)
    e2, hit = cache.acquire(Bucket(8, 4), "fp2", 60, lambda: 1)  # evicts fp1
    assert not hit and cache_calls == [0]
    assert cache.lookup(Bucket(8, 4), "fp1") is None
    _, hit = cache.acquire(Bucket(8, 4), "fp1", 60, lambda: 0)  # rebuilt
    assert not hit
    with pytest.raises(ValueError, match="without pin"):
        cache.release(e1)


@pytest.mark.parametrize("family,knobs", [("model_rb", {"n": 10}), ("sudoku", {"givens": 30}),
                                          ("coloring_kneser", {})])
def test_fingerprint_equals_reference_and_ignores_the_domain(family, knobs):
    csp = generate(family, seed=3, device=CPU, **knobs)
    ref = ref_generate(family, seed=3, **knobs)
    assert network_fingerprint(csp) == ref_network_fingerprint(ref)
    narrowed = csp._replace(dom=csp.dom.clone())
    narrowed.dom[0, 1:] = False  # a different domain on the same network
    assert network_fingerprint(narrowed) == network_fingerprint(csp)
    other = generate("model_rb", n=10, seed=4, device=CPU)
    assert network_fingerprint(csp) != network_fingerprint(other)


# --- shape buckets -------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(3, 2), (8, 4), (9, 5), (16, 8), (17, 9), (100, 20),
                                 (100, 40), (81, 9), (64, 64)])
def test_bucket_for_matches_reference(n, d):
    b = bucket_for(n, d)
    ref = ref_bucket_for(n, d)
    assert (b.n_p, b.d_p) == (ref.n_p, ref.d_p)
    assert b.contains(n, d) and bucket_for(b.n_p, b.d_p) == Bucket(b.n_p, b.d_p)
    assert b.network_nbytes == ref.network_nbytes


@pytest.mark.parametrize("family,knobs", [("model_rb", {"n": 10, "hardness": 1.0}),
                                          ("sudoku", {"givens": 32}),
                                          ("nqueens", {"n": 16})])
def test_pad_csp_matches_reference(family, knobs):
    csp = generate(family, seed=2, device=CPU, **knobs)
    ref = ref_generate(family, seed=2, **knobs)
    b = bucket_for(*csp.dom.shape)
    padded, ref_padded = pad_csp(csp, b), ref_pad_csp(ref, ref_bucket_for(*ref.dom.shape))
    for field in ("cons", "mask", "dom"):
        got, want = getattr(padded, field).numpy(), np.asarray(getattr(ref_padded, field))
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), field
    with pytest.raises(ValueError, match="does not fit"):
        pad_csp(csp, Bucket(4, 4))


def test_requests_route_to_distinct_buckets():
    svc = SolverService(engine="einsum", device=CPU)
    small = svc.submit(generate("model_rb", n=8, seed=0, device=CPU))
    big = svc.submit(generate("random_binary", n=20, d=10, density=0.3, tightness=0.3,
                              seed=0, device=CPU))
    assert small.bucket != big.bucket
    svc.run_until_idle()
    snap = svc.snapshot()
    assert len(snap["buckets"]) == 2
    for info in snap["buckets"].values():
        assert info["resident_nbytes"] > 0  # slot tables are device-resident
    _assert_matches_reference(small, "model_rb", {"n": 8}, 0)
    _assert_matches_reference(big, "random_binary",
                              dict(n=20, d=10, density=0.3, tightness=0.3), 0)


# --- the traced replay and its export ---------------------------------------------


#: names the port records and the reference does not: the blocking
#: device→host reads (`obs.sync_wait`) and the host-loop fixpoint's
#: recurrences
PORT_ONLY = {"spans": {"sync.wait", "fixpoint.recurrence"}, "counters": {"sync.count"},
             "gauges": set(), "histograms": set()}
#: names the reference records and the port does not: the frontier's two
#: gauges, which nothing read
REF_ONLY = {"spans": set(), "counters": set(),
            "gauges": {"frontier.rows_live", "frontier.capacity"}, "histograms": set()}


def test_traced_replay_exports_the_reference_names(tmp_path):
    """The same traced replay through both packages' `serve`: the run dumps
    and Perfetto timelines carry the same span, counter, gauge and histogram
    names, but for the port's own (`PORT_ONLY`, `REF_ONLY`), and the
    solutions are the same."""
    kw = dict(families=["model_rb", "nqueens"], rate=6.0, duration=1.0, quiet=True)
    ref_obs.REGISTRY.reset()
    obs.REGISTRY.reset()
    try:
        _, ref_reqs = ref_serve(trace_out=str(tmp_path / "ref" / "run.json"), **kw)
        _, reqs = serve(trace_out=str(tmp_path / "port" / "run.json"), device="cpu", **kw)
    finally:
        ref_obs.disable()
        obs.disable()
    assert [r.solution for r in reqs] == [r.solution for r in ref_reqs]
    ref_run = obs.load_run(tmp_path / "ref" / "run.json")
    run = obs.load_run(tmp_path / "port" / "run.json")
    assert {s["name"] for s in run["spans"]} - PORT_ONLY["spans"] == \
        {s["name"] for s in ref_run["spans"]} - REF_ONLY["spans"]
    assert PORT_ONLY["spans"] <= {s["name"] for s in run["spans"]}
    for kind in ("counters", "gauges", "histograms"):
        assert set(run["snapshot"][kind]) - PORT_ONLY[kind] == \
            set(ref_run["snapshot"][kind]) - REF_ONLY[kind], kind
    assert PORT_ONLY["counters"] <= set(run["snapshot"]["counters"])
    names = lambda p: {e["name"] for e in json.loads(p.read_text())["traceEvents"]}  # noqa: E731
    port_only = set().union(*PORT_ONLY.values())
    assert names(tmp_path / "port" / "run.perfetto.json") - port_only == \
        names(tmp_path / "ref" / "run.perfetto.json") - set().union(*REF_ONLY.values())
    doc = obs.export.export_run(run)
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "M"}
    assert obs.child_coverage(run["spans"]) > 0.5
