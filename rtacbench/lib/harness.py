"""One run of one cell: set-up, the measured window, the check, the result.

`run_cell` loads the cell's files by name (`spec`), hands set-up, the
window and the check to the cell's driver, reads the per-layer metrics with
their readers, and prints the result line. A driver is a module with

- ``setup(ctx) -> state``: makes the inputs from ``ctx.seed``, builds the
  program's state and warms every shape the window uses;
- ``window(ctx, state) -> Outcome``: the traffic, for ``ctx.seconds``;
- ``release(ctx, state)``: drops the program's state before the check;
- ``check(ctx, state, outcome) -> [Check]``: the comparison with the plain
  reference; it may add the numbers the readers need (byte bounds) to
  ``outcome.counts``.

A per-layer reader is a module with ``read(rec) -> float | None`` over
``rec = {"counts", "trace", "memory_peak_bytes"}``; None leaves the metric
out of the line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

from . import spec
from .trace import Tracer, summarize

#: top-level module names that no run may load (JAX and the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Check(NamedTuple):
    """One number compared, with its limit: the run is correct iff every
    value is at most its limit."""

    name: str
    value: float
    limit: float


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    counts: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Ctx:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tracer: Tracer
    program: str = "port"  # "control": the reference with a broken guarantee
    t_start: float = 0.0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def workload(self) -> dict:
        return self.cell.workload

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (seconds since the process started)."""
        self.sync()
        self.phases[name] = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"


def _clean(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", root: Path = spec.HERE,
             benchmark: Optional[Path] = None, overrides: Optional[dict] = None,
             program: str = "port", err=None) -> Optional[dict]:
    """Run cell ``name`` once; returns the result line's object (None if a
    forbidden module is loaded once the result is ready). ``t_start`` is the
    process's start on the ``time.perf_counter`` clock. ``overrides`` replace workload and
    configuration keys (``{"workload": {...}, "config": {...}}``)."""
    err = err or sys.stderr
    cell = spec.load_cell(name, root, benchmark)
    for part in ("workload", "config"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    dev = torch.device(device)
    wl = cell.workload
    tr = wl.get("trace", {})
    tracer = Tracer(trace, after_s=tr.get("after_s", 0.0), min_s=tr.get("min_s", 1.0),
                    cuda=dev.type == "cuda")
    ctx = Ctx(cell, seed, seconds, trace, dev, tracer, program, t_start)
    drv = spec.driver(wl["driver"], root)
    readers = spec.readers(cell.per_layer, root) if trace else {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ctx.phase("imports")
    state = drv.setup(ctx)
    ctx.phase("driver")
    tracer.warm(dev)
    ctx.sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    tracer.begin_window(t0)
    outcome = drv.window(ctx, state)
    tracer.close()
    ctx.sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = summarize(tracer)

    drv.release(ctx, state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(ctx, state, outcome)
    correct = bool(checks) and all(c.value <= c.limit for c in checks)

    if trace:
        rec = {"counts": outcome.counts, "trace": summary, "memory_peak_bytes": peak}
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": devinfo}
    if trace and summary is not None:
        devinfo["busy_s"] = summary["busy_s"]
        devinfo["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {c.name: {"value": _clean(c.value), "limit": c.limit} for c in checks}

    if dev.type == "cuda":
        print(f"rtacbench: card {card()}", file=err)
    print(f"rtacbench: {name} seed={seed} setup_s={setup_s:.3f} "
          f"phases={json.dumps(ctx.phases)} info={json.dumps(outcome.info, default=str)}",
          file=err)
    for c in checks:
        print(f"check {c.name}: {c.value} (limit {c.limit})", file=err)
    # last of all: the window, the check and the readers are behind us
    bad = forbidden_modules()
    if bad:
        print(f"rtacbench: modules {bad} are loaded once the window has closed; "
              "no run may load JAX or the JAX package", file=err)
        return None
    return result
