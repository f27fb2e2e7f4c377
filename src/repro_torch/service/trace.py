"""Arrival traces: seeded workloads that hit the service *over time*.

The counterpart of `repro.service.trace`: the same seeded traces (event
times, families, knobs and instance seeds are drawn identically), built on
the service's device.

`poisson_trace` draws a reproducible Poisson process (exponential
inter-arrivals at ``rate`` requests/second) over the `repro_torch.problems`
registry: each event picks a family and a size variant, so a replay exercises
shape-bucketed admission with genuinely heterogeneous requests. Instance i is
seeded ``(seed, i)`` — the trace is deterministic and events are stable under
rate/duration changes of later events.

`replay` feeds a trace through a `SolverService` against a `FastForwardClock`:
arrivals are admitted when the service clock reaches their timestamp; while
requests are in flight the clock advances at wall speed (queueing delay is
real compute), and when the service goes idle the clock jumps to the next
arrival — a 20-second trace replays in however long the solving actually
takes, never sleeping.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.csp import CSP
from repro_torch.device import Device
from repro_torch.problems import generate
from .service import SolveRequest, SolverService

#: per-family size variants, deliberately CPU-small and shape-diverse so a
#: default trace spans several admission buckets
DEFAULT_VARIANTS: Dict[str, List[dict]] = {
    "model_rb": [
        {"n": 8, "hardness": 0.9},
        {"n": 10, "hardness": 1.0},
        {"n": 12, "hardness": 0.9},
    ],
    "coloring_random": [
        {"n": 12, "edge_prob": 0.25, "k": 3},
        {"n": 16, "edge_prob": 0.2, "k": 3},
    ],
    "random_binary": [
        {"n": 10, "d": 5, "density": 0.4, "tightness": 0.35},
    ],
    "coloring_kneser": [{"m": 5, "j": 2, "excess": 0}],
    "nqueens": [{"n": 8}, {"n": 10}],
    "pigeonhole": [{"n": 5}],
    "sudoku": [{"givens": 40}],
}


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: at time ``t``, submit family instance ``seed`` with knobs."""

    t: float
    family: str
    knobs: dict
    seed: tuple

    def build(self, device: Device = "cuda") -> CSP:
        return generate(self.family, seed=self.seed, device=device, **self.knobs)


def poisson_trace(
    families: Sequence[str],
    rate: float,
    duration: float,
    seed: int = 0,
    variants: Optional[Dict[str, List[dict]]] = None,
) -> List[TraceEvent]:
    """A seeded Poisson arrival process over the given problem families."""
    if rate <= 0 or duration <= 0:
        raise ValueError("poisson_trace needs rate > 0 and duration > 0")
    unknown = [f for f in families if f not in (variants or DEFAULT_VARIANTS)]
    if unknown:
        raise ValueError(
            f"no size variants for families {unknown}; "
            f"known: {sorted((variants or DEFAULT_VARIANTS))}"
        )
    vmap = variants or DEFAULT_VARIANTS
    rng = np.random.default_rng(seed)
    events: List[TraceEvent] = []
    t = 0.0
    for i in range(10**9):  # bounded by duration, not by count
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            break
        family = families[int(rng.integers(len(families)))]
        knobs = vmap[family][int(rng.integers(len(vmap[family])))]
        events.append(TraceEvent(t=t, family=family, knobs=dict(knobs), seed=(seed, i)))
    return events


def dedup_trace(
    families: Sequence[str],
    rate: float,
    duration: float,
    seed: int = 0,
    pool_size: int = 4,
    variants: Optional[Dict[str, List[dict]]] = None,
) -> List[TraceEvent]:
    """A Poisson arrival process over a SMALL pool of recurring instances.

    `poisson_trace` seeds every event uniquely (``(seed, i)``), so no two
    requests ever share a constraint fingerprint and the service's
    prepared-network LRU never hits. Real traffic is nothing like that —
    the same problem instance arrives again and again. This trace models it:
    arrival times and family/variant picks are drawn exactly like
    `poisson_trace`, but each event's instance seed is drawn from a pool of
    ``pool_size`` seeds per (family, variant), so repeated events rebuild
    byte-identical CSPs and the cache's ``hits`` counter actually moves."""
    if pool_size < 1:
        raise ValueError("dedup_trace needs pool_size >= 1")
    base = poisson_trace(families, rate, duration, seed=seed, variants=variants)
    rng = np.random.default_rng((seed, pool_size))
    # seeds must stay int tuples (they feed numpy.random.default_rng), so the
    # per-(family, variant) pool is keyed by a variant ordinal, not by name
    ordinals: Dict[tuple, int] = {}
    out = []
    for ev in base:
        key = (ev.family, tuple(sorted(ev.knobs.items())))
        v = ordinals.setdefault(key, len(ordinals))
        out.append(
            dataclasses.replace(ev, seed=(seed, v, int(rng.integers(pool_size))))
        )
    return out


class FastForwardClock:
    """Monotonic clock that advances at wall speed but can jump forward over
    idle gaps — trace replays complete as fast as the compute allows while
    queueing delay under load stays real."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._offset = 0.0

    def __call__(self) -> float:
        return time.perf_counter() - self._t0 + self._offset

    def advance_to(self, t: float) -> None:
        now = self()
        if t > now:
            self._offset += t - now


def replay_rate_cell(
    engine: str,
    families: Sequence[str],
    rate: float,
    duration: float,
    seed: int = 0,
    kind: str = "poisson",
    pool_size: int = 3,
    warmup: bool = False,
    service_kwargs: Optional[dict] = None,
    submit_kwargs: Optional[dict] = None,
    variants: Optional[Dict[str, List[dict]]] = None,
    device: Device = "cuda",
) -> dict:
    """ONE capacity-ramp cell: a fresh `SolverService` fed a seeded arrival
    trace at ``rate`` req/s for ``duration`` trace-seconds, replayed to
    completion on a `FastForwardClock`. Returns a flat JSON-ready record —
    offered vs achieved rate, p50/p95/p99 latency, dispatch occupancy, cache
    hit-rate, speculation occupancy — for the caller to judge against an SLO.

    This is the hook behind capacity studies (sweeping ``rate`` for the
    offered-rate ramp, ``pool_size`` with ``kind="dedup"`` for the cache
    hit-rate ramp). ``kind`` selects `poisson_trace` (every instance
    unique — the cold-cache worst case) or `dedup_trace` (instances recur from
    a ``pool_size`` pool per variant, so the prepared-network LRU serves real
    hits). The trace is a pure function of (families, rate, duration, seed),
    never of the engine or the service knobs.

    ``warmup=True`` first replays the same trace through a THROWAWAY service
    and discards it, so the measured replay starts warm (kernels built and
    loaded, closures cached) and its latencies are queueing + solving.
    Single-shot benchmarking of cold-start behavior leaves it off. The
    service runs on ``device``."""
    if kind == "dedup":
        events = dedup_trace(families, rate=rate, duration=duration,
                             seed=seed, pool_size=pool_size, variants=variants)
    elif kind == "poisson":
        events = poisson_trace(families, rate=rate, duration=duration,
                               seed=seed, variants=variants)
    else:
        raise ValueError(f"unknown trace kind {kind!r} (poisson | dedup)")
    if warmup:
        wclock = FastForwardClock()
        wsvc = SolverService(engine=engine, device=device, clock=wclock,
                             **(service_kwargs or {}))
        replay(wsvc, events, wclock, **(submit_kwargs or {}))
    clock = FastForwardClock()
    svc = SolverService(engine=engine, device=device, clock=clock,
                        **(service_kwargs or {}))
    t0 = time.perf_counter()
    requests = replay(svc, events, clock, **(submit_kwargs or {}))
    wall_s = time.perf_counter() - t0
    snap = svc.snapshot()
    cache = snap["cache"]
    lookups = cache.get("hits", 0) + cache.get("misses", 0)
    return {
        "engine": engine,
        "kind": kind,
        "families": list(families),
        "rate": rate,
        "duration": duration,
        "pool_size": pool_size if kind == "dedup" else None,
        "requests": len(requests),
        "completed": snap["completed"],
        "n_solved": sum(r.solution is not None for r in requests),
        # robustness outcomes (all zero on a fault-free replay): every future
        # must land in exactly one terminal bin — ``unresolved`` staying 0 is
        # the chaos acceptance gate
        "timed_out": snap["timed_out"],
        "shed": snap["shed"],
        "failed": snap["failed"],
        "retries": snap["retries"],
        "demotions": snap["demotions"],
        "breaker_trips": snap["breaker_trips"],
        "recovered": sum(
            r.status.value == "done" and (r.retries > 0 or r.engine_level > 0)
            for r in requests
        ),
        "unresolved": sum(not r.done() for r in requests),
        "wall_s": round(wall_s, 3),
        "throughput_rps": snap["throughput_rps"],
        "p50_ms": snap["p50_ms"],
        "p95_ms": snap["p95_ms"],
        "p99_ms": snap["p99_ms"],
        "mean_rows_per_dispatch": snap["mean_rows_per_dispatch"],
        "rounds": snap["rounds"],
        "launches": snap["launches"],
        "mean_launches_per_round": snap["mean_launches_per_round"],
        "cache": cache,
        "cache_hit_rate": (
            round(cache.get("hits", 0) / lookups, 4) if lookups else 0.0
        ),
        "median_rows_per_request": snap["median_rows_per_request"],
        "speculative_members": snap["speculative_members"],
        "speculative_cancel_rate": snap["speculative_cancel_rate"],
    }


def replay(
    service: SolverService,
    events: Sequence[TraceEvent],
    clock: FastForwardClock,
    **submit_kwargs,
) -> List[SolveRequest]:
    """Feed ``events`` through ``service`` (which must share ``clock``) and
    drive it to completion. ``submit_kwargs`` (deadline_s, max_assignments)
    apply to every request; each CSP is built on the service's device.
    Returns the requests in arrival order."""
    events = sorted(events, key=lambda e: e.t)
    requests: List[SolveRequest] = []
    i = 0
    while i < len(events) or service.has_work:
        now = clock()
        while i < len(events) and events[i].t <= now:
            requests.append(service.submit(events[i].build(service.device),
                                           **submit_kwargs))
            i += 1
        if service.has_work:
            # if the service is only waiting on fault-retry backoff gates,
            # jump the clock to the earlier of the next gate / next arrival
            # instead of busy-stepping through the wait
            wake = service.next_wakeup()
            if wake is not None:
                if i < len(events):
                    wake = min(wake, events[i].t)
                clock.advance_to(wake)
            service.step()
        elif i < len(events):
            clock.advance_to(events[i].t)
    return requests
