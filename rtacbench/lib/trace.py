"""The traced run: a slice of the window under `torch.profiler`, and the
benchmark's own spans around each call into the port.

A driver wraps each unit of its traffic (a ``solve_many`` call, a service
step, an ``enforce_batch`` call, a ``mac_solve``) in `Tracer.unit`. With
tracing on, the profiler starts before the first unit that begins at least
``after_s`` into the window and stops after the first unit that ends at
least ``min_s`` after the start, so whole units are traced. `Tracer.span`
names what the host is doing (a `record_function` range while the
profiler runs, nothing otherwise).

`summarize` reduces the trace to what the per-layer readers and the result
line read: the device's busy time (the union of its kernel and copy
intervals), each device operation's time, the host-to-device copies, and
the idle gaps, each labelled by the benchmark's span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

#: the span that covers the traced slice
WINDOW_SPAN = "rtacbench.trace_window"
NO_SPAN = "outside any span"


class Tracer:
    def __init__(self, on: bool, after_s: float = 0.0, min_s: float = 1.0, cuda: bool = True):
        self.on = on
        self.cuda = cuda
        self.after_s = after_s
        self.min_s = min_s
        self.t0: Optional[float] = None
        self.prof = None
        # the profiler's start and stop each stall the host for a second or two
        self.begun: Optional[float] = None  # before its start
        self.started: Optional[float] = None
        self.stopped: Optional[float] = None
        self.ended: Optional[float] = None  # after its stop
        self._window = None
        self.units = 0

    @property
    def active(self) -> bool:
        return self.prof is not None and self.stopped is None

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def warm(self, device) -> None:
        """Start and stop the profiler once in set-up, so its first start in
        the window does not pay for loading the device tracer."""
        if not self.on:
            return
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(1, device=device).add_(1)
            self._sync()

    def begin_window(self, t0: float) -> None:
        self.t0 = t0

    @contextlib.contextmanager
    def unit(self):
        start_now = (self.on and self.prof is None and self.t0 is not None
                     and time.perf_counter() - self.t0 >= self.after_s)
        if start_now:
            from torch.profiler import profile

            self.begun = time.perf_counter()
            self._sync()
            self.prof = profile(activities=self._activities())
            self.prof.start()
            self._window = torch.profiler.record_function(WINDOW_SPAN)
            self._window.__enter__()
            self.started = time.perf_counter()
        traced = self.active
        yield traced
        if traced:
            self.units += 1
            if time.perf_counter() - self.started >= self.min_s:
                self._stop()

    def _stop(self) -> None:
        self._sync()
        self.stopped = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.ended = time.perf_counter()

    def close(self) -> None:
        """Stop a slice the window ended inside of."""
        if self.active:
            self._stop()

    def traced(self, t: float) -> bool:
        """Whether ``t`` (``time.perf_counter``) fell in the traced slice,
        from the moment the profiler began to start to the end of its stop."""
        return (self.begun is not None and t >= self.begun
                and (self.ended is None or t <= self.ended))

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU and not e.is_user_annotation


def busy_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reached = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reached:
            total += end - max(start, reached)
            reached = end
    return total


def summarize(tracer: Tracer, top: int = 10) -> Optional[dict]:
    """The traced slice as numbers; None if nothing was traced."""
    if tracer.prof is None or tracer.stopped is None:
        return None
    events = list(tracer.prof.events())
    window = next((e for e in events if e.name == WINDOW_SPAN
                   and e.device_type == torch.autograd.DeviceType.CPU), None)
    if window is None:
        return None
    w0, w1 = window.time_range.start, window.time_range.end
    device = [e for e in events if _is_device(e)
              and e.time_range.end > w0 and e.time_range.start < w1]
    clip = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e, (s, t) in zip(device, clip):
        by_name[e.name][0] += (t - s) / 1e6
        by_name[e.name][1] += 1
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("rtacbench.") and e.name != WINDOW_SPAN),
                   key=lambda s: s[0])
    gaps: Dict[str, float] = defaultdict(float)
    reached = w0
    for s, t in sorted(clip) + [(w1, w1)]:
        if s > reached:
            gaps[_host_span(spans, reached, s)] += (s - reached) / 1e6
        reached = max(reached, t)
    ops = sorted(((name, v[0]) for name, v in by_name.items()), key=lambda x: -x[1])
    return {
        "busy_s": busy_us(clip) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "units": tracer.units,
        "ops": {name: {"seconds": v[0], "count": v[1]} for name, v in by_name.items()},
        "device_ops": [[name, sec] for name, sec in ops[:top]],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top],
    }


def _host_span(spans, g0: float, g1: float) -> str:
    """The innermost benchmark span the host was in at the gap's middle."""
    mid = (g0 + g1) / 2
    i = bisect.bisect_right(spans, (mid, float("inf"), "")) - 1
    # spans are sorted by start; the latest one that still covers the middle
    # is the innermost, and its ancestors sit a few places before it
    for s, t, name in reversed(spans[max(0, i - 64):i + 1]):
        if t >= mid:
            return name
    return NO_SPAN


def idle_pct(rec: dict) -> Optional[float]:
    """100 - the device's busy share of the traced slice; None untraced."""
    t = rec["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def seconds_of(summary: dict, *needles: str) -> Optional[float]:
    """Device seconds of the operations whose names hold any of ``needles``;
    None when the slice ran none."""
    hits = [v["seconds"] for k, v in summary["ops"].items() if any(n in k for n in needles)]
    return sum(hits) if hits else None
