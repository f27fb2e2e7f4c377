"""Central metric registry — named counters / gauges / histograms.

Where the tracer (`obs.tracing`) answers "where did the wall-clock go",
the registry answers "how much of everything happened": every subsystem
publishes into ONE process-wide table under dotted names
(``driver.rounds``, ``cache.hits``, ``speculation.split_granted``,
``fixpoint.one_launch``, ...) and `snapshot()` reduces it to one JSON-ready
dict with the stable schema ``repro-obs/v1`` that the benchmarks, the
tracker history, and the CLI all consume.

The robustness fabric (DESIGN.md §12) publishes here too:
``faults.injected`` / ``faults.injected.<site>`` (fired injections),
``faults.round_recoveries`` (driver rebuilds after a faulted round),
``service.shed`` / ``service.retries`` / ``service.failed``,
``fallback.demotions`` / ``fallback.breaker_trips``, and
``watchdog.trips`` (round watchdog evictions).

Unlike the tracer the registry is ALWAYS on: publishing is a plain dict
int-add (no clock reads, no allocation on the hot path beyond a deque
append for histogram samples), cheap enough that the default path carries
it — benchmarks read the snapshot with tracing off.

This module also owns the shared reduction helpers (`percentile`,
`summarize`) that `service.metrics.ServiceMetrics` routes its per-field
reductions through — one implementation, with the empty-window → zeros
guarantee made in one place instead of per call site.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterable, List

import numpy as np

#: the snapshot wire schema — bump on any breaking key change
SCHEMA = "repro-obs/v1"

#: histogram sample percentiles reported by `summarize`
SUMMARY_PCTS = (50, 90, 95, 99)


def percentile(samples: Iterable[float], pct: float) -> float:
    """One percentile over a sample iterable; 0.0 on an empty window (never
    NaN — the shared guarantee every metrics snapshot leans on)."""
    arr = np.fromiter(samples, dtype=float)
    if arr.size == 0:
        return 0.0
    return float(np.percentile(arr, pct))


def mean(samples: Iterable[float]) -> float:
    """Mean with the same empty → 0.0 guarantee."""
    arr = np.fromiter(samples, dtype=float)
    return float(arr.mean()) if arr.size else 0.0


def summarize(samples: Iterable[float], pcts=SUMMARY_PCTS) -> Dict[str, float]:
    """count/mean/min/max + percentiles of a sample window; all-zeros (and
    NaN-free) on an empty window."""
    arr = np.fromiter(samples, dtype=float)
    if arr.size == 0:
        out = {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0}
        out.update({f"p{int(p)}": 0.0 for p in pcts})
        return out
    out = {
        "count": int(arr.size),
        "mean": float(arr.mean()),
        "min": float(arr.min()),
        "max": float(arr.max()),
    }
    out.update({f"p{int(p)}": float(np.percentile(arr, p)) for p in pcts})
    return out


class Registry:
    """Named counters (monotonic), gauges (last value), histograms (bounded
    sample windows). Names are dotted strings; one flat namespace."""

    def __init__(self, window: int = 65_536):
        if window < 1:
            raise ValueError("registry histogram window must be >= 1")
        self.window = window
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Deque[float]] = {}

    # --- publishing (the hot path: keep these dict-op cheap) ----------------

    def counter_add(self, name: str, value: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def gauge_set(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = deque(maxlen=self.window)
        h.append(value)

    # --- reading ------------------------------------------------------------

    def counter(self, name: str) -> float:
        return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        return self._gauges.get(name, 0.0)

    def samples(self, name: str) -> Deque[float]:
        return self._hists.get(name, deque())

    def snapshot(self) -> Dict[str, object]:
        """The whole table as one JSON-ready dict, schema ``repro-obs/v1``.
        Histograms reduce to their `summarize` dicts (the raw windows stay
        in memory)."""
        return {
            "schema": SCHEMA,
            "counters": {k: self._counters[k] for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "histograms": {k: summarize(self._hists[k]) for k in sorted(self._hists)},
        }

    def reset(self) -> None:
        """Drop every metric (benchmark scoping, tests)."""
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    def scope(self) -> "RegistryScope":
        """A delta view over this registry: ``with REGISTRY.scope() as sc:``
        marks the current counter values and histogram positions, and
        ``sc.delta()`` afterwards reduces ONLY what was published inside the
        block. Publishing stays global and always-on — a scope never mutates
        or pauses the registry, it just remembers where it stood — so scopes
        nest freely and cost two dict copies each.

        `repro.sweeps` wraps every sweep cell in one, so per-cell records
        carry exactly that cell's rounds/launches/speculation figures instead
        of the whole process history."""
        return RegistryScope(self)


class RegistryScope:
    """Per-block registry delta (see `Registry.scope`).

    Caveat: histogram windows are bounded deques, so a scope that outlives
    ``registry.window`` samples of one histogram under-reports that
    histogram's early samples (never its late ones). Sweep cells publish a
    few dozen samples each — far inside the default 65k window.
    """

    def __init__(self, registry: Registry):
        self._r = registry
        self._counters0: Dict[str, float] = {}
        self._hist0: Dict[str, int] = {}

    def __enter__(self) -> "RegistryScope":
        self._counters0 = dict(self._r._counters)
        self._hist0 = {k: len(v) for k, v in self._r._hists.items()}
        return self

    def __exit__(self, *exc) -> None:
        return None

    def counters(self) -> Dict[str, float]:
        """Counter increments since scope entry (zero-delta keys dropped)."""
        out = {}
        for k, v in self._r._counters.items():
            d = v - self._counters0.get(k, 0)
            if d:
                out[k] = d
        return out

    def samples(self, name: str) -> List[float]:
        """Histogram samples published under ``name`` since scope entry."""
        h = self._r._hists.get(name)
        if h is None:
            return []
        new = len(h) - self._hist0.get(name, 0)
        if new <= 0:
            return []
        return list(h)[-new:]

    def delta(self) -> Dict[str, object]:
        """JSON-ready reduction of everything published inside the scope:
        counter deltas plus `summarize` over each histogram's new samples
        (histograms with no new samples are dropped). Schema ``repro-obs/v1``
        like the full `Registry.snapshot`."""
        hists = {}
        for name in sorted(self._r._hists):
            new = self.samples(name)
            if new:
                hists[name] = summarize(new)
        return {
            "schema": SCHEMA,
            "counters": self.counters(),
            "histograms": hists,
        }


#: the process-wide registry every subsystem publishes into
REGISTRY = Registry()


def counter_add(name: str, value: float = 1) -> None:
    REGISTRY.counter_add(name, value)


def gauge_set(name: str, value: float) -> None:
    REGISTRY.gauge_set(name, value)


def observe(name: str, value: float) -> None:
    REGISTRY.observe(name, value)


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
