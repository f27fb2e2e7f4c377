"""Export — run dumps (``repro-obs/v1`` JSON) and Chrome-trace/Perfetto JSON.

The counterpart of `repro.obs.export`; the two packages write the same
schema, so either CLI reads either package's run dumps.

Two artifacts per traced run:

- **run dump** (`dump_run`): ``{"schema": "repro-obs/v1", "snapshot": ...,
  "spans": [...], "tracer": {...}}`` — the registry snapshot plus the span
  ring as neutral dicts. This is what ``python -m repro_torch.obs`` consumes.
- **timeline** (`chrome_trace` / `write_trace`): the Chrome trace-event
  format (https://ui.perfetto.dev loads it directly): one ``"X"``
  (complete) event per span with microsecond ``ts``/``dur`` rebased to the
  tracer origin, integer ``pid``/``tid``, and ``"M"`` metadata events
  naming the process and one thread per span track.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import registry, tracing

RUN_SCHEMA = registry.SCHEMA  # one schema governs snapshot and run dump
PID = 1


def spans_payload(tracer: tracing.Tracer) -> Dict[str, object]:
    """The tracer's state as JSON-ready dicts (ring oldest-first)."""
    return {
        "origin": tracer.origin,
        "timing": tracer.timing,
        "capacity": tracer.capacity,
        "dropped": tracer.dropped,
        "force_closed": tracer.force_closed,
        "spans": tracer.snapshot_spans(),
    }


def chrome_trace(spans: Sequence[dict], origin: float = 0.0) -> Dict[str, object]:
    """Spans (as `Span.to_dict` dicts) → a Chrome trace-event JSON object.

    Tracks map to synthetic thread ids in first-seen order; ``"M"``
    thread_name/process_name metadata events label them for Perfetto's
    track list. Timestamps/durations are microseconds (the format's unit),
    rebased to ``origin`` so traces start near t=0."""
    tids: Dict[str, int] = {}
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": "repro_torch"},
    }]
    body: List[dict] = []
    for s in spans:
        track = s.get("track", "main")
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
        body.append({
            "name": s["name"],
            "cat": s.get("cat", "repro_torch"),
            "ph": "X",
            "ts": (s["t0"] - origin) * 1e6,
            "dur": max(s["dur"], 0.0) * 1e6,
            "pid": PID,
            "tid": tid,
            "args": s.get("args", {}),
        })
    events.extend({
        "name": "thread_name", "ph": "M", "pid": PID, "tid": tid,
        "args": {"name": track},
    } for track, tid in tids.items())
    events.extend(body)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def child_coverage(spans: Sequence[dict], name: str = "driver.round") -> float:
    """Of the total wall-clock spent inside spans named ``name``, the
    fraction covered by their DIRECT children — the acceptance figure for
    "a round's time decomposes into its phases". 1.0 when no such spans
    were recorded (nothing to decompose)."""
    by_sid = {s["sid"]: s for s in spans}
    total = child = 0.0
    for s in spans:
        if s["name"] == name and s["dur"] > 0:
            total += s["dur"]
    if total <= 0.0:
        return 1.0
    for s in spans:
        p = by_sid.get(s["parent"])
        if p is not None and p["name"] == name and s["dur"] > 0:
            child += s["dur"]
    return child / total


def run_payload(tracer: Optional[tracing.Tracer] = None,
                extra: Optional[dict] = None) -> Dict[str, object]:
    """One run dump: registry snapshot + (if tracing) the span ring."""
    tracer = tracer if tracer is not None else tracing.get_tracer()
    payload: Dict[str, object] = {
        "schema": RUN_SCHEMA,
        "snapshot": registry.snapshot(),
    }
    if tracer is not None:
        tp = spans_payload(tracer)
        payload["spans"] = tp.pop("spans")
        payload["tracer"] = tp
    else:
        payload["spans"] = []
        payload["tracer"] = None
    if extra:
        payload.update(extra)
    return payload


def dump_run(path, tracer: Optional[tracing.Tracer] = None,
             extra: Optional[dict] = None) -> Dict[str, object]:
    """Write the run dump to ``path``; returns the payload."""
    payload = run_payload(tracer, extra)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1))
    return payload


def write_trace(path, tracer: Optional[tracing.Tracer] = None) -> Path:
    """Write the live tracer's ring as a Perfetto-loadable trace file."""
    tracer = tracer if tracer is not None else tracing.get_tracer()
    if tracer is None:
        raise RuntimeError("write_trace: tracing is not enabled")
    doc = chrome_trace(tracer.snapshot_spans(), origin=tracer.origin)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc))
    return p


def load_run(path) -> Dict[str, object]:
    payload = json.loads(Path(path).read_text())
    schema = payload.get("schema")
    if schema != RUN_SCHEMA:
        raise ValueError(f"unknown run schema {schema!r} (expected {RUN_SCHEMA!r})")
    return payload


def export_run(run: Dict[str, object]) -> Dict[str, object]:
    """A loaded run dump → its Chrome-trace document."""
    tracer_meta = run.get("tracer") or {}
    origin = float(tracer_meta.get("origin", 0.0))
    return chrome_trace(run.get("spans", []), origin=origin)
