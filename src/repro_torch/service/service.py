"""SolverService — continuous-batching CSP solving over time.

The PyTorch counterpart of `repro.service.service`, on one device: the
service's engine, every rung of its fallback ladder, its slot tables and its
frontier tables all live on the ``device`` it is given (default ``"cuda"``).

`solve_many` takes a *closed* batch: every instance known up front, one
lockstep run to completion. A service faces an *open world* — requests arrive
over time, finish at different times, and must not wait for a batch to drain.
`SolverService` keeps the device saturated anyway:

- **submit** returns a futures-style `SolveRequest` immediately; the CSP is
  routed to its shape bucket (`buckets.bucket_for`) and queued;
- **admission** pads the CSP into its bucket, fingerprints the constraint
  network, and pins it in the prepared-network cache (`cache`) — a cache hit
  reuses an already-resident slot, a miss installs into a free slot of the
  bucket's `SlotPool` (growing by doubling when full);
- **step** runs ONE lockstep round per bucket with work: newly admitted
  searches' root propagations ride the same dispatch as everyone else's
  frontiers, and searches that finish free their rows (and their cache pins)
  mid-flight — continuous batching, one device dispatch per bucket round;
- per-request **deadlines** (checked between rounds) and **assignment
  budgets** bound work; `metrics.ServiceMetrics` tracks throughput, tail
  latency, queue depth, and rows-per-dispatch occupancy.

Single-threaded by design: ``step()`` is the event loop body, so tests and
trace replay drive the service deterministically (``request.result()`` just
steps until its request retires). Results and per-request `SearchStats` are
bit-identical to sequential `mac_solve` on the unpadded CSP — asserted by
`tests/test_torch_service.py`.

Failure handling: every `repro_torch.faults.FaultError` escaping admission or
a lockstep round is absorbed by the service, never the caller. A faulted
request is retried with capped exponential backoff, then demoted down the
engine fallback ladder (on the Hopper engines: fused kernel → stepped
kernel → einsum, all on the primary engine's device) with its rows
re-rooted on the fallback runtime, and only FAILED once the ladder is
exhausted. A faulted *round* rebuilds the bucket's driver + frontier store
from scratch (the slot pool and its resident networks survive) and requeues
every in-flight request; K consecutive faulted rounds trip the bucket's
circuit breaker, flooring all future admissions of that bucket at the next
ladder rung. Queue-depth and deadline-aware load shedding reject requests
with a typed `Overloaded` error before padding work is spent on them.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from enum import Enum
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

from repro_torch import faults, obs
from repro_torch.core.csp import CSP
from repro_torch.core.engine import (
    Engine,
    FrontierTable,
    SlotPool,
    StackedSlotPool,
    frontier_capacity,
)
from repro_torch.core.search import HostFrontierStore, LockstepDriver, SearchStats, resolve_engine
from repro_torch.device import Device
from .buckets import Bucket, bucket_for, pad_csp, speculative_budget
from .cache import CacheEntry, PreparedNetworkCache, network_fingerprint
from .metrics import ServiceMetrics


class RequestStatus(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    TIMED_OUT = "timed_out"
    CANCELLED = "cancelled"
    #: rejected by load shedding before (or at) admission; ``req.error`` is
    #: the `repro_torch.faults.Overloaded` carrying the retry-after hint
    SHED = "shed"
    #: gave up after exhausting retries + the whole engine fallback ladder,
    #: or evicted by the round watchdog; ``req.error`` is the last fault
    FAILED = "failed"


_TERMINAL = (
    RequestStatus.DONE,
    RequestStatus.TIMED_OUT,
    RequestStatus.CANCELLED,
    RequestStatus.SHED,
    RequestStatus.FAILED,
)


class InvalidRequest(ValueError):
    """A submit-time argument is unusable (non-positive deadline, absurd
    budget, malformed domain shape). Raised eagerly at `SolverService.submit`
    so a bad request fails in the caller's stack frame, not rounds later
    inside the lockstep."""


class SolveRequest:
    """Futures-style handle for one submitted CSP."""

    __slots__ = (
        "id", "csp", "n_vars", "dom_size", "bucket", "fingerprint",
        "deadline", "max_assignments", "status", "solution", "stats",
        "split_budget", "portfolio",
        "submitted_at", "admitted_at", "finished_at", "_service",
        "_trace_t0",
        # robustness state: the terminal error (Overloaded / FaultError),
        # retries burned at the current ladder level, the current fallback
        # level, the backoff gate (admission skips this request until then),
        # and the runtime key it is active on
        "error", "retries", "engine_level", "not_before", "_rt_key",
    )

    def __init__(self, req_id: int, csp: CSP, bucket: Bucket, fingerprint: str,
                 submitted_at: float, deadline: Optional[float],
                 max_assignments: Optional[int], service: "SolverService",
                 split_budget: Optional[int] = None,
                 portfolio: Optional[int] = None):
        self.id = req_id
        self.csp = csp
        self.n_vars, self.dom_size = csp.dom.shape
        self.bucket = bucket
        self.fingerprint = fingerprint
        self.submitted_at = submitted_at
        self.deadline = deadline
        self.max_assignments = max_assignments
        # requested speculation ceilings (None = service defaults); admission
        # clamps them against live load via buckets.speculative_budget
        self.split_budget = split_budget
        self.portfolio = portfolio
        self.status = RequestStatus.QUEUED
        self.solution: Optional[List[int]] = None
        self.stats: Optional[SearchStats] = None
        self.error: Optional[BaseException] = None
        self.retries = 0
        self.engine_level = 0
        self.not_before = 0.0
        self._rt_key = None
        self.admitted_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._service = service
        # tracer-clock submit stamp for the request-lifetime span; the service
        # clock may be a FastForwardClock, so the tracer keeps its own timebase
        self._trace_t0 = obs.now()

    def done(self) -> bool:
        return self.status in _TERMINAL

    def result(self) -> Tuple[Optional[List[int]], Optional[SearchStats]]:
        """(solution | None, stats). Drives the service's event loop until this
        request retires (single-threaded future). ``(None, stats)`` is only a
        proof of UNSAT when ``status is DONE`` and ``stats.exhausted`` is
        False — a timed-out/cancelled/shed/failed request (check ``status``;
        SHED and FAILED carry the reason in ``error``) or one that hit its
        assignment budget (``stats.exhausted``) is inconclusive."""
        while not self.done():
            self._service.step()
        return self.solution, self.stats

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"<SolveRequest #{self.id} {self.status.value} "
                f"({self.n_vars}x{self.dom_size})->{self.bucket}>")


class _BucketRuntime:
    """One (bucket, fallback level)'s live state: engine, slot pool, lockstep
    driver, slot free-list, and the in-flight requests (with their cache
    pins). A faulted round replaces ``driver``/``store`` in place — the pool
    (and every network the cache holds resident in it) survives the rebuild."""

    def __init__(self, bucket: Bucket, engine: Engine, level: int,
                 pool: SlotPool, driver: LockstepDriver, store):
        self.bucket = bucket
        self.engine = engine
        self.level = level
        self.pool = pool
        self.driver = driver
        self.store = store  # FrontierTable | HostFrontierStore
        self.free_slots: List[int] = list(range(pool.capacity))
        self.active: Dict[int, Tuple[SolveRequest, CacheEntry]] = {}
        #: consecutive faulted rounds — the circuit breaker's trip counter,
        #: reset by any cleanly resolved round
        self.consecutive_faults = 0

    def take_slot(self) -> int:
        if not self.free_slots:
            old = self.pool.capacity
            self.pool.grow(old * 2)
            self.free_slots.extend(range(old, old * 2))
        return self.free_slots.pop()


class SolverService:
    """Continuous-batching solver service over any registered Engine, on one
    device: an engine name is instantiated on ``device``; an Engine instance
    keeps its own device, and the whole ladder follows it."""

    def __init__(
        self,
        engine: Union[Engine, str] = "einsum",
        *,
        device: Device = "cuda",
        cache_bytes: int = 256 << 20,
        initial_slots: int = 8,
        max_active: Optional[int] = None,
        batched_children: bool = True,
        collect_stats: bool = True,
        split_budget: int = 0,
        portfolio: int = 0,
        portfolio_seed: int = 0,
        speculation_queue_limit: int = 4,
        n_floor: int = 8,
        d_floor: int = 4,
        clock: Optional[Callable[[], float]] = None,
        metrics_window: int = 100_000,
        retry_cap: int = 2,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        breaker_threshold: int = 3,
        round_wall_s: Optional[float] = None,
        round_recurrences: Optional[int] = None,
        shed_queue_depth: Optional[int] = None,
        shed_deadline_factor: Optional[float] = None,
    ):
        self.engine = resolve_engine(engine, device=device)
        self.device = self.engine.device
        if initial_slots < 1:
            raise ValueError("initial_slots must be >= 1")
        if max_active is not None and max_active < 1:
            raise ValueError("max_active must be >= 1 (or None)")
        self._initial_slots = initial_slots
        self._max_active = max_active
        self._batched_children = batched_children
        self._collect_stats = collect_stats
        if split_budget < 0 or portfolio < 0:
            raise ValueError("split_budget / portfolio must be >= 0")
        if speculation_queue_limit < 1:
            raise ValueError("speculation_queue_limit must be >= 1")
        self._split_budget = split_budget
        self._portfolio = portfolio
        self._portfolio_seed = portfolio_seed
        self._speculation_queue_limit = speculation_queue_limit
        self._n_floor = n_floor
        self._d_floor = d_floor
        self._clock = clock if clock is not None else time.monotonic
        if retry_cap < 0:
            raise ValueError("retry_cap must be >= 0")
        if backoff_base_s < 0 or backoff_cap_s < 0:
            raise ValueError("backoff_base_s / backoff_cap_s must be >= 0")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        # fail at construction, not at the first admitted round
        if round_wall_s is not None and round_wall_s <= 0:
            raise ValueError("round_wall_s must be > 0 (or None)")
        if round_recurrences is not None and round_recurrences < 1:
            raise ValueError("round_recurrences must be >= 1 (or None)")
        if shed_queue_depth is not None and shed_queue_depth < 1:
            raise ValueError("shed_queue_depth must be >= 1 (or None)")
        if shed_deadline_factor is not None and shed_deadline_factor <= 0:
            raise ValueError("shed_deadline_factor must be > 0 (or None)")
        self._retry_cap = retry_cap
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._breaker_threshold = breaker_threshold
        self._round_wall_s = round_wall_s
        self._round_recurrences = round_recurrences
        self._shed_queue_depth = shed_queue_depth
        self._shed_deadline_factor = shed_deadline_factor
        # the engine fallback ladder (level 0 = the primary engine); a
        # bucket's circuit breaker floors its admissions at _bucket_floor
        self._ladder: List[Engine] = self._build_ladder(self.engine)
        self._bucket_floor: Dict[Bucket, int] = {}
        # runtimes are keyed (Bucket, ladder level): a demoted request's rows
        # re-root on the fallback engine's own pool/frontier, never mixing
        # engines within one lockstep
        self._buckets: Dict[Tuple[Bucket, int], _BucketRuntime] = {}
        self._queue: Deque[SolveRequest] = deque()
        self._ids = itertools.count()
        self.cache = PreparedNetworkCache(cache_bytes, self._free_slot)
        self.metrics = ServiceMetrics(window=metrics_window)

    @staticmethod
    def _build_ladder(primary: Engine) -> List[Engine]:
        """fused → stepped → einsum, starting from whatever was configured,
        every rung on the primary engine's device. Each rung is strictly more
        conservative than the last; the final rung is the einsum engine whose
        verdicts the parity oracles pin, so a demotion never changes a result
        — only how it is computed."""
        ladder = [primary]
        name = getattr(primary, "name", None)
        device = primary.device
        from repro_torch.engines import get_engine

        if name and getattr(primary, "fused_fixpoint", False):
            try:
                ladder.append(get_engine(name, fixpoint="stepped", device=device))
            except (KeyError, TypeError, ValueError):
                pass
        if name != "einsum":
            ladder.append(get_engine("einsum", device=device))
        return ladder

    # --- submission ---------------------------------------------------------

    def submit(
        self,
        csp: CSP,
        *,
        deadline_s: Optional[float] = None,
        max_assignments: Optional[int] = None,
        split_budget: Optional[int] = None,
        portfolio: Optional[int] = None,
    ) -> SolveRequest:
        """Queue one CSP; returns immediately with a `SolveRequest` future.

        Per-request knobs (``submit_kwargs`` of `replay_rate_cell`):

        - ``deadline_s``: relative to submission; an in-flight request whose
          deadline passes is cancelled at the next round boundary. Bounds
          *latency* (queue wait included).
        - ``max_assignments``: search-budget cap — the request completes
          unsolved once its MAC search has tried this many assignments.
          Bounds *compute* per request without touching queueing, which is
          why capacity studies set it: p95 then measures load, not the solve
          time of one pathologically hard instance.
        - ``split_budget`` / ``portfolio``: override the service's
          speculation defaults for this request (ceilings — admission still
          clamps them against queue depth and spare frontier rows; the
          verdict is unchanged either way, speculation only spends slack
          rows to finish sooner).

        Raises `InvalidRequest` eagerly on unusable arguments. With
        ``shed_queue_depth`` configured and the queue at/over it, the request
        is SHED immediately: its future resolves with
        ``error = faults.Overloaded`` (retry-after hint included) instead of
        joining a queue it would only time out in."""
        self._validate_submit(csp, deadline_s, max_assignments,
                              split_budget, portfolio)
        now = self._clock()
        bucket = bucket_for(*csp.dom.shape, n_floor=self._n_floor, d_floor=self._d_floor)
        req = SolveRequest(
            next(self._ids), csp, bucket, network_fingerprint(csp),
            submitted_at=now,
            deadline=None if deadline_s is None else now + deadline_s,
            max_assignments=max_assignments,
            service=self,
            split_budget=split_budget,
            portfolio=portfolio,
        )
        self._queue.append(req)
        self.metrics.record_submit(now)
        if (
            self._shed_queue_depth is not None
            and len(self._queue) > self._shed_queue_depth
        ):
            self._shed(req, f"queue depth {len(self._queue)} > "
                            f"{self._shed_queue_depth}")
        return req

    def _validate_submit(self, csp: CSP, deadline_s, max_assignments,
                         split_budget, portfolio) -> None:
        dom = getattr(csp, "dom", None)
        if dom is None or getattr(dom, "ndim", 0) != 2 or min(dom.shape) < 1:
            raise InvalidRequest(
                "csp.dom must be a 2-D (n_vars, dom_size) array with both "
                f"dimensions >= 1, got {None if dom is None else dom.shape}"
            )
        if deadline_s is not None and not (
            math.isfinite(deadline_s) and 0 <= deadline_s < 1e7
        ):
            # zero is legal (expire at the next beat — a probe pattern the
            # deadline tests use); negative or absurd magnitudes are not
            raise InvalidRequest(
                f"deadline_s must be a finite number of seconds in [0, 1e7), "
                f"got {deadline_s!r}"
            )
        if max_assignments is not None and not (
            isinstance(max_assignments, int) and 1 <= max_assignments <= 10**9
        ):
            raise InvalidRequest(
                f"max_assignments must be an int in [1, 1e9], "
                f"got {max_assignments!r}"
            )
        for label, v in (("split_budget", split_budget), ("portfolio", portfolio)):
            if v is not None and (not isinstance(v, int) or v < 0):
                raise InvalidRequest(f"{label} must be an int >= 0, got {v!r}")

    def _shed(self, req: SolveRequest, why: str) -> None:
        """Reject ``req`` with a typed `Overloaded` (terminal SHED status).
        The retry-after hint is the recent mean latency scaled by how many
        requests stand in line per admission slot — rough, but it gives a
        well-behaved client a sensible pause instead of a stampede."""
        lat = self.metrics.latency_ms(50) / 1e3
        slots = self._max_active if self._max_active is not None else max(
            1, self.n_active
        )
        hint = max(0.05, lat * (1 + len(self._queue) / max(1, slots)))
        req.error = faults.Overloaded(hint, why)
        self._retire(req, None, RequestStatus.SHED)

    def cancel(self, req: SolveRequest) -> bool:
        """Cancel a queued or running request; False if already terminal."""
        if req.done():
            return False
        self._retire(req, None, RequestStatus.CANCELLED)
        return True

    # --- event loop ---------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(len(rt.active) for rt in self._buckets.values())

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(
            rt.driver.has_work for rt in self._buckets.values()
        )

    def next_wakeup(self) -> Optional[float]:
        """Earliest backoff gate among queued requests, IF backoff timers are
        the only thing the service is waiting on (no live driver work, nothing
        admittable now) — else None. Replay loops use this to fast-forward
        their clock over a pure backoff wait instead of busy-spinning."""
        if not self._queue or any(
            rt.driver.has_work for rt in self._buckets.values()
        ):
            return None
        gates = [r.not_before for r in self._queue]
        if min(gates) <= self._clock():
            return None
        return min(gates)

    def step(self) -> int:
        """One event-loop beat: expire deadlines, admit from the queue, then
        run ONE lockstep round per bucket with pending work. Returns the
        number of requests that reached a terminal state.

        A `faults.FaultError` escaping a round never escapes here: the
        runtime is recovered (driver + store rebuilt on the surviving pool)
        and its in-flight requests re-enter the queue through the
        retry/demote ladder."""
        now = self._clock()
        with obs.span("service.step", cat="service"):
            retired = self._expire(now)
            self._admit()
            for key, rt in list(self._buckets.items()):
                if not rt.driver.has_work:
                    continue
                try:
                    finished = rt.driver.round()
                except faults.FaultError as err:
                    self._recover_runtime(key, rt, err, now)
                    continue
                # rounds are pipelined: record the round the driver RESOLVED
                # this step (if any) — its row count and dispatch-to-metadata
                # seconds — not the one it just launched asynchronously. The
                # breaker counter resets only on a RESOLVED round: launch-only
                # rounds always succeed between faults and would otherwise
                # keep the count forever at 1
                info = rt.driver.last_round
                if info is not None:
                    rt.consecutive_faults = 0
                    self.metrics.record_round(
                        info.rows, info.searches, info.seconds, info.launches
                    )
                for req_id, (sol, stats) in finished.items():
                    req, _entry = rt.active[req_id]
                    # a watchdog quarantine is a FAILURE verdict — it must
                    # never read as UNSAT, so the check precedes (None, stats)
                    if stats is not None and stats.quarantined:
                        req.error = faults.FaultError(
                            "round.watchdog", stats.quarantined
                        )
                        self._retire(req, None, RequestStatus.FAILED)
                    else:
                        self._retire(req, sol, RequestStatus.DONE)
                    retired += 1
            self.metrics.record_queue_depth(len(self._queue))
        return retired

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            wake = self.next_wakeup()
            if wake is not None:
                # the only work left is behind backoff gates — yield instead
                # of burning the step budget busy-spinning on the clock
                time.sleep(min(0.01, max(0.0, wake - self._clock())))
            self.step()
        raise RuntimeError(f"service still busy after {max_steps} steps")

    # --- internals ----------------------------------------------------------

    def _runtime(self, bucket: Bucket, level: int = 0) -> _BucketRuntime:
        key = (bucket, level)
        rt = self._buckets.get(key)
        if rt is None:
            engine = self._ladder[level]
            pool = engine.open_slot_pool(bucket.n_p, bucket.d_p, self._initial_slots)
            driver, store = self._build_driver(engine, bucket, pool)
            rt = self._buckets[key] = _BucketRuntime(
                bucket, engine, level, pool, driver, store
            )
        return rt

    def _build_driver(self, engine: Engine, bucket: Bucket, pool: SlotPool):
        """Wire a fresh driver + frontier store over ``pool`` — used both at
        runtime creation and to rebuild a runtime whose round faulted (the
        pool, holding every cache-resident network, is reused as-is).

        Engines ADVERTISE their capabilities (Engine.device_frontier /
        slot_table); the bucket wiring follows the advertisement, never
        backend names. Device-frontier engines dispatch every round against
        a resident FrontierTable fed by the pool's live slot tables (installs
        and growth between rounds are picked up); everything else routes
        through the host store over the pool."""
        if engine.device_frontier and isinstance(pool, StackedSlotPool):
            store = engine.open_frontier(
                lambda: pool.tables, bucket.n_p, bucket.d_p,
                capacity=frontier_capacity(
                    self._initial_slots, bucket.n_p, bucket.d_p
                ),
                check_net=pool.require_installed,
            )
        else:
            store = HostFrontierStore(
                bucket.n_p, pool.enforce_rows, pad_rounds=engine.slot_table
            )
        driver = LockstepDriver(
            store, bucket.n_p, count_unit=engine.count_unit,
            round_wall_s=self._round_wall_s,
            round_recurrences=self._round_recurrences,
        )
        return driver, store

    def _recover_runtime(self, key, rt: _BucketRuntime,
                         err: faults.FaultError, now: float) -> None:
        """A lockstep round faulted somewhere between dispatch and resolve —
        the driver/store state is unknowable, so rebuild both from scratch on
        the surviving slot pool and route every in-flight request back through
        the queue (retry → demote → FAILED ladder). K consecutive faulted
        rounds trip the bucket's circuit breaker: future admissions of this
        bucket floor at the next ladder rung instead of flapping."""
        rt.consecutive_faults += 1
        obs.counter_add("faults.round_recoveries")
        with obs.span("service.recover", cat="service", bucket=str(rt.bucket),
                      level=rt.level, site=err.site,
                      n_requeued=len(rt.active)):
            actives = list(rt.active.values())
            rt.active.clear()
            for req, entry in actives:
                self.cache.release(entry)
                self._fault_requeue(req, err, now)
            rt.driver, rt.store = self._build_driver(
                rt.engine, rt.bucket, rt.pool
            )
        if (
            rt.consecutive_faults >= self._breaker_threshold
            and rt.level + 1 < len(self._ladder)
            and self._bucket_floor.get(rt.bucket, 0) <= rt.level
        ):
            self._bucket_floor[rt.bucket] = rt.level + 1
            self.metrics.record_breaker_trip()
            rt.consecutive_faults = 0

    def _fault_requeue(self, req: SolveRequest, err: faults.FaultError,
                       now: float) -> None:
        """Route one faulted request: capped-exponential-backoff retry at its
        current ladder level, demotion to the next level once retries are
        spent, terminal FAILED once the ladder is exhausted."""
        req.error = err
        req.status = RequestStatus.QUEUED
        req._rt_key = None
        req.stats = None
        if req.retries < self._retry_cap:
            req.retries += 1
            req.not_before = now + min(
                self._backoff_base_s * (2 ** (req.retries - 1)),
                self._backoff_cap_s,
            )
            self.metrics.record_retry()
            self._queue.append(req)
            return
        if req.engine_level + 1 < len(self._ladder):
            req.engine_level += 1
            req.retries = 0
            req.not_before = now
            self.metrics.record_demotion()
            self._queue.append(req)
            return
        # ladder exhausted: requeue-then-retire so the one _retire path
        # handles bookkeeping (it pops QUEUED requests from the queue)
        self._queue.append(req)
        self._retire(req, None, RequestStatus.FAILED)

    def _free_slot(self, entry: CacheEntry) -> None:
        """Cache eviction callback: return the slot to its runtime's free
        list. Level-0 entries carry a bare Bucket key, fallback entries the
        (bucket, level) composite — normalize to the runtime key."""
        key = entry.bucket if isinstance(entry.bucket, tuple) else (entry.bucket, 0)
        rt = self._buckets[key]
        rt.pool.release(entry.slot)
        rt.free_slots.append(entry.slot)

    def _admit(self) -> None:
        now = self._clock()
        deferred: List[SolveRequest] = []
        try:
            while self._queue:
                if self._max_active is not None and self.n_active >= self._max_active:
                    return
                req = self._queue.popleft()
                if req.not_before > now:
                    deferred.append(req)  # backoff gate still closed
                    continue
                with obs.span("service.admit", cat="service", req=req.id,
                              bucket=str(req.bucket)):
                    try:
                        self._admit_one(req, now)
                    except faults.FaultError as err:
                        # every admission-path site fires before the driver
                        # sees the request, so requeueing is all the cleanup
                        # there is (install() returns its slot on failure,
                        # cache.acquire registers nothing on a raise)
                        self._fault_requeue(req, err, now)
        finally:
            # preserve arrival order among the still-gated requests
            for r in reversed(deferred):
                self._queue.appendleft(r)

    def _admit_one(self, req: SolveRequest, now: float) -> None:
        faults.inject("service.admit", req=req.id)
        if (
            self._shed_deadline_factor is not None
            and req.deadline is not None
        ):
            # deadline-aware shed: if the recent median solve latency says
            # this request cannot make its deadline, reject it now instead of
            # spending padding + install work on a corpse (no latency history
            # yet → estimate 0 → never sheds)
            est = self._shed_deadline_factor * self.metrics.latency_ms(50) / 1e3
            if est > 0 and now + est > req.deadline:
                self._shed(
                    req,
                    f"deadline {req.deadline - now:.3f}s away < estimated "
                    f"{est:.3f}s to solve",
                )
                return
        level = max(req.engine_level, self._bucket_floor.get(req.bucket, 0))
        req.engine_level = level
        rt = self._runtime(req.bucket, level)
        padded = pad_csp(req.csp, req.bucket)

        def install() -> int:
            slot = rt.take_slot()
            try:
                rt.pool.install(slot, padded)
            except BaseException:
                # the pool registered nothing (its slot entry is only set on
                # success) — just return the slot to the free list
                rt.free_slots.append(slot)
                raise
            return slot

        # The cache budget counts the ENGINE's resident bytes for this
        # bucket shape — packed 32-bit words on hopper_packed (≈8× fewer
        # bytes than the logical bool network), padded u8 on hopper_dense,
        # the logical network elsewhere — so the same budget legally holds
        # proportionally more packed networks.
        # level-0 entries keep the bare Bucket as their cache key (the
        # public lookup(bucket, fp) contract); fallback levels key by
        # (bucket, level) so a demoted request's network never aliases the
        # primary engine's resident slot
        cache_key = req.bucket if level == 0 else (req.bucket, level)
        entry, _hit = self.cache.acquire(
            cache_key,
            req.fingerprint,
            rt.engine.network_nbytes(req.bucket.n_p, req.bucket.d_p),
            install,
        )
        # Size this request's speculation against live load: the spare-row
        # pool is what the store ACTUALLY has free, clamped by the engine's
        # advertised appetite, shared fairly with everyone still queued.
        # Under pressure (deep queue / no slack) this degrades to plain
        # admission — admit_group with (0, 0) is byte-identical to admit.
        want_split = req.split_budget if req.split_budget is not None else self._split_budget
        want_port = req.portfolio if req.portfolio is not None else self._portfolio
        split_eff, port_eff = speculative_budget(
            want_split,
            want_port,
            queue_depth=len(self._queue),
            spare_rows=min(
                rt.store.spare_rows(), rt.engine.speculative_rows_hint
            ),
            queue_limit=self._speculation_queue_limit,
        )
        req.stats = rt.driver.admit_group(
            req.id,
            padded.dom,
            idx=entry.slot,
            split_budget=split_eff,
            portfolio=port_eff,
            portfolio_seed=self._portfolio_seed + req.id,
            supports_batch=rt.engine.supports_batch,
            batched_children=self._batched_children,
            n_active=req.n_vars,
            max_assignments=req.max_assignments,
            collect_stats=self._collect_stats,
        )
        rt.active[req.id] = (req, entry)
        req._rt_key = (req.bucket, level)
        req.status = RequestStatus.RUNNING
        req.admitted_at = self._clock()

    def _expire(self, now: float) -> int:
        """Retire queued/running requests whose deadline has passed."""
        expired = [
            req for req in self._queue
            if req.deadline is not None and now >= req.deadline
        ]
        for rt in self._buckets.values():
            expired.extend(
                req for req, _e in rt.active.values()
                if req.deadline is not None and now >= req.deadline
            )
        for req in expired:
            self._retire(req, None, RequestStatus.TIMED_OUT)
        return len(expired)

    def _retire(self, req: SolveRequest, solution, status: RequestStatus) -> None:
        if req.status is RequestStatus.QUEUED:
            self._queue.remove(req)
        elif req.status is RequestStatus.RUNNING:
            rt = self._buckets[req._rt_key]
            _req, entry = rt.active.pop(req.id)
            if rt.driver.is_active(req.id):  # still mid-flight (deadline/cancel)
                rt.driver.cancel(req.id)
            self.cache.release(entry)
        req.solution = solution
        req.status = status
        req.finished_at = self._clock()
        self.metrics.record_finish(
            req.finished_at, req.finished_at - req.submitted_at, status.value
        )
        # request-lifetime span on its own Perfetto track, in the TRACER's
        # timebase (the service clock may fast-forward); only when the stamp
        # was taken with tracing already on, so the pair shares one origin
        if obs.enabled() and req._trace_t0 > 0.0:
            obs.record_complete(
                "service.request", req._trace_t0, obs.now(),
                cat="service", track="requests",
                id=req.id, status=status.value, bucket=str(req.bucket),
            )
        if req.stats is not None:  # was admitted: file lifetime row consumption
            self.metrics.record_request_rows(
                req.stats.rows, req.stats.members, req.stats.cancelled_members
            )

    # --- introspection ------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Service-wide metrics + cache + per-bucket occupancy (JSON-ready).
        Fallback-level runtimes (level > 0) key as ``<bucket>@L<level>``;
        level-0 keys are the bare bucket string as before."""
        snap = self.metrics.snapshot()
        snap["cache"] = self.cache.stats()
        snap["engine_ladder"] = [
            getattr(e, "name", type(e).__name__) for e in self._ladder
        ]
        snap["bucket_floor"] = {
            str(b): lvl for b, lvl in sorted(self._bucket_floor.items())
        }
        snap["buckets"] = {
            (str(b) if lvl == 0 else f"{b}@L{lvl}"): {
                "capacity": rt.pool.capacity,
                "free_slots": len(rt.free_slots),
                "active": len(rt.active),
                "level": lvl,
                "consecutive_faults": rt.consecutive_faults,
                "resident_nbytes": rt.pool.resident_nbytes,
                **(
                    {
                        "device_frontier": True,
                        "frontier_rows": rt.store.capacity,
                        "frontier_rows_live": rt.store.rows_live,
                        "host_bytes_per_round": rt.store.host_bytes_per_round,
                    }
                    if isinstance(rt.store, FrontierTable)
                    else {"device_frontier": False}
                ),
            }
            for (b, lvl), rt in sorted(self._buckets.items())
        }
        return snap
