"""Service metrics: throughput, tail latency, queue depth, dispatch occupancy.

The counterpart of `repro.service.metrics`: request latency percentiles
(p50/p95/p99, submit → finish), sustained instances/second, queue depth over
time, and rows-per-dispatch — the continuous-batching occupancy figure that
says whether rounds actually ride full batches or the device is dispatching
single rows.

Memory is bounded for a long-lived service: totals (request counts, rows
dispatched, span) are exact O(1) counters, while the per-sample series
(latencies, queue depths, per-round rows/seconds) live in sliding windows of
the most recent ``window`` samples — percentiles and means are therefore
*recent-window* figures, which is what an operator watches anyway.

All reductions route through the shared `repro_torch.obs.registry` helpers
(`percentile` / `mean`), which guarantee empty-window → 0.0 (never NaN) in
ONE place; ``window=1`` degenerates to last-sample metrics but stays finite.
Every ``record_*`` call also publishes into the central obs registry
(``service.*`` counters/histograms), so a process-wide `obs.snapshot()`
carries the same figures without holding a service reference.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

from repro_torch import obs
from repro_torch.obs.registry import mean as _mean
from repro_torch.obs.registry import percentile as _percentile


class ServiceMetrics:
    """Counters + sliding-window samples; ``snapshot`` reduces to one dict.

    The snapshot schema is stable and NaN-free: on a freshly constructed
    instance (or any empty window) every value is an exact zero."""

    def __init__(self, window: int = 100_000) -> None:
        if window < 1:
            raise ValueError("metrics window must be >= 1")
        self.window = window
        # exact totals
        self.n_submitted = 0
        self.n_completed = 0
        self.n_timed_out = 0
        self.n_cancelled = 0
        # robustness outcomes: shed at/before admission,
        # failed after exhausting the fallback ladder (or quarantined), plus
        # the recovery work done on the way — retries, engine demotions,
        # circuit-breaker trips
        self.n_shed = 0
        self.n_failed = 0
        self.n_retries = 0
        self.n_demotions = 0
        self.n_breaker_trips = 0
        self.n_rounds = 0
        self.rows_dispatched = 0
        self.launches = 0
        self.first_submit_t: Optional[float] = None
        self.last_finish_t: Optional[float] = None
        # bounded recent-window samples
        self.latencies_s: Deque[float] = deque(maxlen=window)
        self.queue_depths: Deque[int] = deque(maxlen=window)
        self.round_rows: Deque[int] = deque(maxlen=window)
        self.round_searches: Deque[int] = deque(maxlen=window)
        self.round_seconds: Deque[float] = deque(maxlen=window)
        self.round_launches: Deque[int] = deque(maxlen=window)
        # speculation: rows each request consumed over its
        # lifetime, and how many speculative members were spawned / cancelled
        self.rows_per_request: Deque[int] = deque(maxlen=window)
        self.speculative_members_total = 0
        self.speculative_cancels_total = 0

    # --- recording ----------------------------------------------------------

    def record_submit(self, t: float) -> None:
        self.n_submitted += 1
        if self.first_submit_t is None:
            self.first_submit_t = t
        obs.counter_add("service.submitted")

    def record_finish(self, t: float, latency_s: float, status: str) -> None:
        if status == "done":
            self.n_completed += 1
            self.latencies_s.append(latency_s)
            obs.counter_add("service.completed")
            obs.observe("service.latency_ms", 1e3 * latency_s)
        elif status == "timed_out":
            self.n_timed_out += 1
            obs.counter_add("service.timed_out")
        elif status == "shed":
            self.n_shed += 1
            obs.counter_add("service.shed")
        elif status == "failed":
            self.n_failed += 1
            obs.counter_add("service.failed")
        else:
            self.n_cancelled += 1
            obs.counter_add("service.cancelled")
        self.last_finish_t = t

    def record_retry(self) -> None:
        """One faulted request re-queued for another attempt (same engine)."""
        self.n_retries += 1
        obs.counter_add("service.retries")

    def record_demotion(self) -> None:
        """One request demoted a rung down the engine fallback ladder."""
        self.n_demotions += 1
        obs.counter_add("fallback.demotions")

    def record_breaker_trip(self) -> None:
        """One bucket's circuit breaker opened (floor raised to a fallback)."""
        self.n_breaker_trips += 1
        obs.counter_add("fallback.breaker_trips")

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depths.append(depth)
        obs.gauge_set("service.queue_depth", depth)

    def record_round(
        self, rows: int, searches: int, seconds: float, launches: int = 1
    ) -> None:
        self.n_rounds += 1
        self.rows_dispatched += rows
        self.launches += launches
        self.round_rows.append(rows)
        self.round_searches.append(searches)
        self.round_seconds.append(seconds)
        self.round_launches.append(launches)
        obs.counter_add("service.rounds")
        obs.counter_add("service.rows_dispatched", rows)
        obs.observe("service.round_ms", 1e3 * seconds)

    def record_request_rows(self, rows: int, members: int, cancelled: int) -> None:
        """File one retired request's lifetime row consumption and speculation
        outcome: ``members`` counts every search that ran for it (1 = no
        speculation), ``cancelled`` the members killed when a sibling won."""
        self.rows_per_request.append(rows)
        self.speculative_members_total += max(0, members - 1)
        self.speculative_cancels_total += cancelled
        obs.observe("service.rows_per_request", rows)

    # --- reduction ----------------------------------------------------------

    def latency_ms(self, pct: float) -> float:
        """Latency percentile over the recent window, in milliseconds;
        0.0 (never NaN) on an empty window."""
        return 1e3 * _percentile(self.latencies_s, pct)

    @property
    def span_s(self) -> float:
        """First submit → last finish (the sustained-throughput denominator)."""
        if self.first_submit_t is None or self.last_finish_t is None:
            return 0.0
        return max(self.last_finish_t - self.first_submit_t, 0.0)

    @property
    def throughput_rps(self) -> float:
        span = self.span_s
        return self.n_completed / span if span > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {
            "submitted": self.n_submitted,
            "completed": self.n_completed,
            "timed_out": self.n_timed_out,
            "cancelled": self.n_cancelled,
            "shed": self.n_shed,
            "failed": self.n_failed,
            "retries": self.n_retries,
            "demotions": self.n_demotions,
            "breaker_trips": self.n_breaker_trips,
            "span_s": round(self.span_s, 4),
            "throughput_rps": round(self.throughput_rps, 3),
            "p50_ms": round(self.latency_ms(50), 3),
            "p95_ms": round(self.latency_ms(95), 3),
            "p99_ms": round(self.latency_ms(99), 3),
            "rounds": self.n_rounds,
            "rows_dispatched": self.rows_dispatched,
            "mean_rows_per_dispatch": round(
                self.rows_dispatched / self.n_rounds if self.n_rounds else 0.0, 3
            ),
            "launches": self.launches,
            "mean_launches_per_round": round(_mean(self.round_launches), 3),
            "mean_searches_per_round": round(_mean(self.round_searches), 3),
            "mean_queue_depth": round(_mean(self.queue_depths), 3),
            "max_queue_depth": int(max(self.queue_depths, default=0)),
            "median_rows_per_request": round(
                _percentile(self.rows_per_request, 50), 3
            ),
            "speculative_members": self.speculative_members_total,
            "speculative_cancel_rate": round(
                self.speculative_cancels_total / self.speculative_members_total
                if self.speculative_members_total
                else 0.0,
                3,
            ),
        }
