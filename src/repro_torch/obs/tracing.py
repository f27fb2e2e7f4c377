"""Span tracer — nested wall-clock spans in a bounded in-memory ring.

The tracing contract (DESIGN.md §10):

- **Zero overhead when off.** The module-level tracer is ``None`` until
  `enable()` (or ``REPRO_TORCH_TRACE=1`` at import); `span()` then returns one
  shared null context manager — the off-path cost of an instrumentation
  point is a global read plus a no-op ``with``. No span objects, no clock
  reads, no ring writes.
- **Bounded memory.** Spans land in a ``deque(maxlen=capacity)`` ring; a
  long-lived service overwrites its oldest spans instead of growing, and
  the ``dropped`` counter says how many rolled off.
- **No semantic footprint.** Spans never touch device buffers. The one
  exception is opt-in: ``timing="fenced"`` makes `fence()` call
  ``torch.cuda.synchronize()`` so a span brackets real device time instead
  of an asynchronous launch — a synchronize moves no data and never changes
  values, so verdicts are bit-identical in every mode. The default
  ``timing="async"`` leaves CUDA's asynchronous launches untouched.

Span hierarchy is positional: a span opened while another is open is its
child (one implicit stack per tracer — the whole repo is single-threaded
by design, see `service.SolverService`). Request-lifetime spans that
bracket other work (``service.request``) are filed as pre-timed *complete*
events via `record_complete` instead of nesting.

Two more views of the same spans, both only while the tracer is on:

- **The profiler's clock.** A span opened while a `torch.profiler` is
  recording also opens ``torch.profiler.record_function(<its name>)``, so it
  lands in the profiler's trace as a CPU user annotation on the clock of the
  kernels and copies, and an idle gap of the card can be named by the span
  the host was in. The check runs once at span open; nothing is mirrored
  once the profiler stops.
- **Per-name totals.** Beside its ring the tracer keeps each span name's
  count and total seconds (`Tracer.snapshot_totals`), which no ring
  overwrites: a reader takes two snapshots and subtracts them.

`sync_wait` marks every blocking device→host read of the search and
fixpoint paths: it counts ``sync.count`` in the always-on registry, tracing
on or off, and opens a ``sync.wait`` span while the tracer is on.

The spans of the search and fixpoint paths, by what each brackets:

- ``search.prepare``: a `solve_many` or `mac_solve` call's preparation:
  the networks (`prepare`/`prepare_many`), the frontier store, and the
  admission of each search (its root read and the coroutine's first step).
  `solve_many`'s telemetry carries its wall time as ``prepare_seconds``.
- ``prepare.slot`` (cat ``engine``, arg ``slot``): one instance of
  `Engine.prepare_many` built (a lazy instance's network made only now)
  and prepared; on a stacked engine its network written into its slot in
  place, each such slot counted by the always-on ``prepare.slots``.
- ``driver.round``: one round of the search driver (`LockstepDriver.round`,
  `mac_solve`'s loop), holding ``frontier.step`` and ``round.resolve``.
- ``frontier.step``: the round's rows collected and dispatched.
- ``round.resolve``: the round's results waited for and read back, and
  every search's coroutine advanced on them.
- ``kernel.launch``: the enforcement a dispatch enqueues, up to its read-back
  (arg ``fenced``: whether `fence` waited for the device inside it). The
  fused fixpoint enqueues one launch; a host-loop fixpoint (a stepped
  engine) holds its ``fixpoint.recurrence`` spans, the word loop (a fused
  packed engine on a single network the fused kernel cannot take) its
  ``fixpoint.chunk`` spans.
- ``fixpoint.recurrence``: one recurrence of the host-loop fixpoint
  (`rtac._fixpoint_rows`): its step and the loop predicate's read.
- ``fixpoint.chunk``: one chunk of the word loop's recurrences
  (`kernels.ops.packed_word_fixpoint`; arg ``recurrences``): their launches
  and the one read of the count of rows left active.
- ``enforce.upload``: a single-network `enforce`/`enforce_batch` taking its
  domains onto the device and padding them (a pageable upload blocks; a
  staged one, counted by ``upload.staged``, returns once the host has
  copied its last chunk into pinned memory).
- ``sync.wait``: a blocking device→host read (`sync_wait`): a frontier
  round's metadata (`_PendingFrontierRound.resolve`), a fixpoint's loop
  predicate, a host store's read-back, a closure's extraction.
- ``group.spawn``, ``group.cancel``: speculative siblings admitted and
  cancelled; ``service.*``, ``cache.lookup``, ``slot.install``,
  ``autotune.search``: the service and autotune (their modules).
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from .registry import REGISTRY

#: ``REPRO_TORCH_TRACE=1`` enables tracing at import of `repro_torch.obs`
TRACE_ENV = "REPRO_TORCH_TRACE"
#: ``REPRO_TORCH_TRACE_TIMING=fenced`` selects fenced timing when env-enabled
TIMING_ENV = "REPRO_TORCH_TRACE_TIMING"
#: ``REPRO_TORCH_TRACE_RING=<n>`` overrides the ring capacity when env-enabled
RING_ENV = "REPRO_TORCH_TRACE_RING"
DEFAULT_RING = 65_536
TIMING_MODES = ("async", "fenced")


class Span:
    """One recorded interval. ``t0`` is tracer-clock seconds; ``dur`` is
    seconds (set at close; -1 while open). ``parent`` is the enclosing
    span's ``sid`` (0 = top-level). ``track`` groups spans into Perfetto
    rows (threads)."""

    __slots__ = ("sid", "parent", "name", "cat", "track", "t0", "dur", "args")

    def __init__(self, sid: int, parent: int, name: str, cat: str, track: str,
                 t0: float, dur: float, args: Dict[str, Any]):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.track = track
        self.t0 = t0
        self.dur = dur
        self.args = args

    def to_dict(self) -> Dict[str, Any]:
        return {
            "sid": self.sid, "parent": self.parent, "name": self.name,
            "cat": self.cat, "track": self.track, "t0": self.t0,
            "dur": self.dur, "args": self.args,
        }

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<Span {self.name} {self.dur * 1e3:.3f}ms args={self.args}>"


class Tracer:
    """The recording core: a span stack (nesting) + a bounded ring (storage).

    ``timing`` is "async" (default — record launch-side wall-clock, never
    synchronize) or "fenced" (`fence()` blocks on traced values so spans
    measure completed device work)."""

    def __init__(self, capacity: int = DEFAULT_RING, timing: str = "async",
                 clock=time.perf_counter):
        if timing not in TIMING_MODES:
            raise ValueError(f"timing must be one of {TIMING_MODES}, got {timing!r}")
        if capacity < 1:
            raise ValueError("tracer ring capacity must be >= 1")
        self.capacity = int(capacity)
        self.timing = timing
        self._clock = clock
        self.origin = clock()  # export rebases timestamps onto this
        self.spans: deque = deque(maxlen=self.capacity)
        self.dropped = 0  # spans that rolled off the ring
        self.force_closed = 0  # mismatched exits repaired by `end`
        self._totals: Dict[str, List[float]] = {}  # name -> [count, seconds]
        self._stack: List[Span] = []
        self._ids = itertools.count(1)

    def now(self) -> float:
        return self._clock()

    # --- recording ----------------------------------------------------------

    def begin(self, name: str, cat: str = "repro", track: str = "main",
              args: Optional[Dict[str, Any]] = None) -> Span:
        parent = self._stack[-1].sid if self._stack else 0
        s = Span(next(self._ids), parent, name, cat, track,
                 self.now(), -1.0, args if args is not None else {})
        self._stack.append(s)
        return s

    def end(self, span: Span) -> None:
        """Close ``span``. Tolerates mismatched nesting (an exception that
        skipped an inner exit): any span still open above ``span`` is
        force-closed at the same instant rather than left to corrupt the
        stack — integrity over precision."""
        t1 = self.now()
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
            top.dur = t1 - top.t0
            self._record(top)
            self.force_closed += 1
        span.dur = t1 - span.t0
        self._record(span)

    def record_complete(self, name: str, t0: float, t1: float,
                        cat: str = "repro", track: str = "main",
                        args: Optional[Dict[str, Any]] = None) -> Span:
        """File a pre-timed span (e.g. a request's submit → retire lifetime,
        measured around other spans rather than nested inside them)."""
        s = Span(next(self._ids), 0, name, cat, track, t0,
                 max(t1 - t0, 0.0), args if args is not None else {})
        self._record(s)
        return s

    def _record(self, span: Span) -> None:
        if len(self.spans) == self.capacity:
            self.dropped += 1
        self.spans.append(span)
        total = self._totals.get(span.name)
        if total is None:
            total = self._totals[span.name] = [0, 0.0]
        total[0] += 1
        total[1] += span.dur

    # --- introspection ------------------------------------------------------

    @property
    def open_spans(self) -> int:
        return len(self._stack)

    def snapshot_spans(self) -> List[Dict[str, Any]]:
        """The ring as plain dicts (JSON-ready), oldest first."""
        return [s.to_dict() for s in self.spans]

    def snapshot_totals(self) -> Dict[str, Tuple[int, float]]:
        """Every span name recorded so far: ``(count, total seconds)``,
        the ring's overwritten spans included."""
        return {name: (int(c), s) for name, (c, s) in self._totals.items()}


class _NullSpan:
    """The disabled-path context manager: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager binding one `span()` call to the live tracer. Enter
    returns the `Span` so call sites can attach result args
    (``s.args["hit"] = True``) before exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_span", "_mirror")

    def __init__(self, tracer: Tracer, name: str, cat: str, track: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args
        self._span: Optional[Span] = None
        self._mirror = None

    def __enter__(self) -> Span:
        if torch.autograd._profiler_enabled():
            # the same span on the profiler's clock (a CPU user annotation)
            self._mirror = torch.profiler.record_function(self._name)
            self._mirror.__enter__()
        self._span = self._tracer.begin(self._name, self._cat, self._track, self._args)
        return self._span

    def __exit__(self, *exc):
        # close against the tracer live at enter — a disable() mid-span
        # must not strand the stack
        if self._span is not None:
            self._tracer.end(self._span)
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
        return False


# --- the module-level tracer (what the instrumentation points talk to) ------

_TRACER: Optional[Tracer] = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enable(capacity: int = DEFAULT_RING, timing: str = "async") -> Tracer:
    """Install a fresh tracer (replacing any prior one) and return it."""
    global _TRACER
    _TRACER = Tracer(capacity=capacity, timing=timing)
    return _TRACER


def disable() -> Optional[Tracer]:
    """Remove the tracer; returns it (spans intact) for late export."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def enable_from_env(environ=os.environ) -> bool:
    """``REPRO_TORCH_TRACE=1`` (anything but ""/"0"/"false"/"off") enables
    tracing with ``REPRO_TORCH_TRACE_TIMING`` / ``REPRO_TORCH_TRACE_RING``
    knobs. Called once at `repro_torch.obs` import; safe to re-call."""
    flag = environ.get(TRACE_ENV, "").strip().lower()
    if not flag or flag in ("0", "false", "off"):
        return False
    timing = environ.get(TIMING_ENV, "async").strip().lower() or "async"
    capacity = int(environ.get(RING_ENV, DEFAULT_RING))
    enable(capacity=capacity, timing=timing)
    return True


def span(name: str, cat: str = "repro", track: str = "main", **args):
    """The one instrumentation macro: ``with obs.span("driver.round"): ...``.
    Returns the shared null context manager when tracing is off."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _SpanCtx(t, name, cat, track, args)


def sync_wait(**args):
    """Mark a blocking device→host read: ``with obs.sync_wait(): x.cpu()``.
    Counts ``sync.count`` in the always-on registry, and opens a
    ``sync.wait`` span while tracing is on (the shared null context
    otherwise)."""
    REGISTRY.counter_add("sync.count")
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _SpanCtx(t, "sync.wait", "sync", "main", args)


def fencing() -> bool:
    """Whether `fence` blocks: tracing on with ``timing="fenced"``."""
    t = _TRACER
    return t is not None and t.timing == "fenced"


def record_complete(name: str, t0: float, t1: float, cat: str = "repro",
                    track: str = "main", **args) -> None:
    t = _TRACER
    if t is not None:
        t.record_complete(name, t0, t1, cat, track, args)


def now() -> float:
    """Tracer-clock timestamp for `record_complete` pairs; 0.0 when off (the
    pair is never filed then, so the value is inert)."""
    t = _TRACER
    return t.now() if t is not None else 0.0


def fence(value):
    """Block until the device has finished the work queued so far — ONLY under
    ``timing="fenced"`` with tracing on, and only for a CUDA ``value`` (a
    tensor or a tuple of tensors); a no-op (one global read) otherwise. A
    synchronize moves no data and never changes values, so verdicts are
    bit-identical in every mode."""
    t = _TRACER
    if t is not None and t.timing == "fenced":
        first = value[0] if isinstance(value, (tuple, list)) and value else value
        if isinstance(first, torch.Tensor) and first.is_cuda:
            torch.cuda.synchronize(first.device)
    return value
