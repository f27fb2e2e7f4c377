"""Resumable sweep runner: spec cells -> versioned JSONL artifacts.

The port's counterpart of `repro.sweeps.runner`: the same cells, seeds,
record layout and resume protocol, run on `repro_torch` on ``device``
(``"cuda"`` unless the caller passes ``device="cpu"``).

One sweep's artifacts live in ``<out_root>/<spec.name>/``:

    spec.toml       the spec exactly as expanded (the resume fingerprint)
    cells.jsonl     line 1: a header record {schema, sweep, n_cells, spec}
                    then ONE record per completed cell (append-only)

Resume semantics: `run_spec` reads any existing ``cells.jsonl``, verifies the
header's spec document matches the one being run (a changed spec refuses to
graft onto stale cells unless ``fresh=True`` wipes them), and executes only
the cells whose ``cell_id`` is not yet recorded — an interrupted sweep picks
up where it stopped and never duplicates a cell. Cell identity is the
resolved knob values (`Cell.cell_id`), not the grid position, so editing an
axis re-runs exactly the new points.

Every cell record carries the resolved params, the derived workload seed,
the device it ran on (``torch.cuda.get_device_name`` or ``"cpu"``),
per-cell metric medians, and an obs-registry delta (`Registry.scope`) of
just that cell's counters/histograms.

Three cell modes (`SweepSpec.mode`):

``solve_many``    generate ``replicates`` instances per cell and solve them to
                  completion through `repro_torch.core.solve_many`.
``assignments``   the paper's Table 1 / Fig. 3 protocol: AC-close the root,
                  sample assignments from surviving values, enforce each
                  against the prepared network, count recurrences (tensor
                  engines) or revisions (AC3) and per-assignment wall time
                  (device work finished: ``torch.cuda.synchronize``), plus
                  the batched `enforce_batch` amortized variant.
``service``       one `repro_torch.service.replay_rate_cell` per cell —
                  offered-rate capacity ramps and dedup cache-pool ramps.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import Device, resolve_device, to_numpy
from .spec import SCHEMA, Cell, SweepSpec

#: default artifact root of the port's studies (repo-root ``results_torch/``,
#: never the reference's ``results/``); scratch runs pass their own out_root
DEFAULT_OUT_ROOT = Path(__file__).resolve().parents[3] / "results_torch"


def _median(xs) -> float:
    return float(np.median(list(xs))) if len(xs) else 0.0


def _r(x: float, nd: int = 4) -> float:
    return round(float(x), nd)


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


# --------------------------------------------------------------------------
# cell executors
# --------------------------------------------------------------------------


def _run_solve_many_cell(spec: SweepSpec, cell: Cell, seed: int,
                         device: torch.device) -> Dict[str, Any]:
    from repro_torch.core import solve_many
    from repro_torch.problems import generate_batch

    p = dict(cell.params.get("problem", {}))
    family = p.pop("family")
    solver = dict(cell.params.get("solver", {}))
    engine = solver.pop("engine", "einsum")

    csps = generate_batch(family, spec.replicates, seed=seed, device=device, **p)
    telemetry: Dict[str, Any] = {}
    t0 = time.perf_counter()
    sols, stats = solve_many(csps, engine=engine, telemetry=telemetry, device=device, **solver)
    _sync(device)
    wall_s = time.perf_counter() - t0

    solved = [s is not None for s in sols]
    latency_ms = [1e3 * sum(st.enforce_seconds) for st in stats]
    return {
        "n_instances": len(csps),
        "n_solved": int(sum(solved)),
        "solve_rate": _r(sum(solved) / len(csps)),
        "exhausted": int(sum(st.exhausted for st in stats)),
        "wall_s": _r(wall_s, 3),
        "instances_per_s": _r(len(csps) / max(wall_s, 1e-9), 3),
        # per-instance medians — the cell's representative figures
        "median_latency_ms": _r(_median(latency_ms), 3),
        "p90_latency_ms": _r(float(np.percentile(latency_ms, 90)), 3),
        "median_assignments": _r(_median([st.n_assignments for st in stats]), 2),
        "p90_assignments": _r(
            float(np.percentile([st.n_assignments for st in stats], 90)), 2
        ),
        "median_rounds": _r(_median([st.rounds for st in stats]), 2),
        "median_recurrences": _r(
            _median([st.mean_recurrences for st in stats]), 3
        ),
        "launches_per_round": _r(telemetry.get("launches_per_round", 0.0), 3),
        "host_bytes_per_round": _r(telemetry.get("host_bytes_per_round", 0.0), 1),
    }


def _run_assignments_cell(spec: SweepSpec, cell: Cell, seed: int,
                          device: torch.device) -> Dict[str, Any]:
    from repro_torch.core import assign_np
    from repro_torch.engines import get_engine
    from repro_torch.problems import generate_batch

    p = dict(cell.params.get("problem", {}))
    family = p.pop("family")
    solver = dict(cell.params.get("solver", {}))
    engine = solver.pop("engine", "einsum")
    n_assignments = int(solver.pop("n_assignments", 10))
    batch_timing = bool(solver.pop("batch_timing", True))
    if solver:
        raise ValueError(f"assignments mode: unknown solver knobs {sorted(solver)}")

    eng = get_engine(engine, device=device)
    csps = generate_batch(family, spec.replicates, seed=seed, device=device, **p)
    rng = np.random.default_rng(seed)

    counts: List[float] = []
    times: List[float] = []
    batched: List[float] = []
    roots_ok = 0
    for csp in csps:
        n, d = csp.dom.shape
        prepared = eng.prepare(csp)  # once per instance — the expensive part
        root = prepared.enforce()
        if not bool(root.consistent):
            continue  # an AC-inconsistent root has no assignments to sample
        roots_ok += 1
        root_np = to_numpy(root.dom)

        # sample (var, surviving value) sites; seed is engine-independent
        # (see SweepSpec.workload_seed) so every engine enforces these exact
        # sites — the paper's Table 1 comparison stays apples-to-apples
        sites = []
        for _ in range(n_assignments):
            var = int(rng.integers(n))
            vals = np.nonzero(root_np[var])[0]
            sites.append((var, int(rng.choice(vals))))

        var0, val0 = sites[0]
        ch0 = np.zeros((n,), bool)
        ch0[var0] = True
        prepared.enforce(assign_np(root_np, var0, val0), ch0)  # warm: kernels built
        _sync(device)
        for var, val in sites:
            dom_a = assign_np(root_np, var, val)
            ch = np.zeros((n,), bool)
            ch[var] = True
            t0 = time.perf_counter()
            r = prepared.enforce(dom_a, ch)
            _sync(device)  # device work finished; no copy to the host timed
            times.append(time.perf_counter() - t0)
            counts.append(float(to_numpy(r.n_recurrences)))

        if batch_timing and eng.supports_batch:
            dom_b = np.stack([assign_np(root_np, v, a) for v, a in sites])
            ch_b = np.zeros((len(sites), n), bool)
            ch_b[np.arange(len(sites)), [v for v, _ in sites]] = True
            prepared.enforce_batch(dom_b, ch_b)  # warm
            _sync(device)
            t0 = time.perf_counter()
            prepared.enforce_batch(dom_b, ch_b)
            _sync(device)
            batched.append((time.perf_counter() - t0) / len(sites))

    out = {
        "count_unit": eng.count_unit,  # "recurrences" | "revisions"
        "n_instances": len(csps),
        "roots_consistent": roots_ok,
        "n_assignments": len(times),
        "mean_count": _r(float(np.mean(counts)) if counts else 0.0, 3),
        "max_count": _r(max(counts) if counts else 0.0, 1),
        "per_assignment_ms": _r(1e3 * _median(times), 4),
    }
    if batched:
        out["batched_per_assignment_ms"] = _r(1e3 * _median(batched), 4)
    return out


def _run_service_cell(spec: SweepSpec, cell: Cell, seed: int,
                      device: torch.device) -> Dict[str, Any]:
    from repro_torch.service import replay_rate_cell

    svc = dict(cell.params.get("service", {}))
    solver = dict(cell.params.get("solver", {}))
    engine = solver.pop("engine", "einsum")
    # per-request budgets go to SolverService.submit — a capacity study caps
    # work per request so p95 measures queueing, not one pathological instance
    submit = {
        k: svc.pop(k) for k in ("max_assignments", "deadline_s") if k in svc
    }
    row = replay_rate_cell(
        engine=engine,
        families=list(svc.pop("families")),
        rate=float(svc.pop("rate")),
        duration=float(svc.pop("duration")),
        seed=seed,
        kind=svc.pop("kind", "poisson"),
        pool_size=int(svc.pop("pool_size", 3)),
        warmup=bool(svc.pop("warmup", False)),
        service_kwargs=solver or None,
        submit_kwargs=submit or None,
        device=device,
    )
    slo = svc.pop("slo_p95_ms", None)
    if svc:
        raise ValueError(f"service mode: unknown service knobs {sorted(svc)}")
    if slo is not None:
        row["slo_p95_ms"] = float(slo)
        row["slo_breached"] = bool(row["p95_ms"] > float(slo))
    return row


_CELL_RUNNERS: Dict[str, Callable[[SweepSpec, Cell, int, torch.device], Dict[str, Any]]] = {
    "solve_many": _run_solve_many_cell,
    "assignments": _run_assignments_cell,
    "service": _run_service_cell,
}

#: obs counters worth carrying per cell (speculation + driver totals); the
#: full delta would drag every kernel build counter into every record
_OBS_COUNTERS = (
    "driver.rounds", "driver.launches", "driver.recurrences",
    "driver.cancelled_members",
    "speculation.denied", "speculation.split_granted",
    "speculation.portfolio_granted", "speculation.clamped",
    "cache.hits", "cache.misses",
)
_OBS_HISTS = (
    "many.rounds_per_instance", "many.launches_per_solve",
    "service.rows_per_request",
)


def _obs_delta(scope: obs.RegistryScope) -> Dict[str, Any]:
    delta = scope.delta()
    return {
        "counters": {
            k: delta["counters"][k] for k in _OBS_COUNTERS
            if k in delta["counters"]
        },
        "histograms": {
            k: delta["histograms"][k] for k in _OBS_HISTS
            if k in delta["histograms"]
        },
    }


# --------------------------------------------------------------------------
# the resumable runner
# --------------------------------------------------------------------------


def sweep_dir(spec: SweepSpec, out_root: Optional[Path] = None) -> Path:
    return Path(out_root or DEFAULT_OUT_ROOT) / spec.name


def _header(spec: SweepSpec) -> Dict[str, Any]:
    return {
        "schema": SCHEMA,
        "sweep": spec.name,
        "n_cells": len(spec.cells()),
        "spec": spec.to_doc(),
    }


def load_cells(path: Path) -> List[Dict[str, Any]]:
    """Completed cell records of one ``cells.jsonl`` (header line excluded).
    Raises on a schema mismatch; tolerates a truncated trailing line (the
    artifact of an interrupt mid-write — that cell simply reruns)."""
    records = []
    with path.open() as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == 0:
                    raise
                continue  # torn tail write — drop, the runner redoes the cell
            if rec.get("schema") != SCHEMA:
                raise ValueError(
                    f"{path}: record schema {rec.get('schema')!r} != {SCHEMA!r}"
                )
            if i == 0:
                if "spec" not in rec:
                    raise ValueError(f"{path}: first line is not a sweep header")
                continue
            records.append(rec)
    return records


def read_header(path: Path) -> Dict[str, Any]:
    with path.open() as f:
        return json.loads(f.readline())


def run_spec(
    spec: SweepSpec,
    out_root: Optional[Path] = None,
    fresh: bool = False,
    progress: Optional[Callable[[str], None]] = print,
    device: Device = "cuda",
) -> Path:
    """Execute every not-yet-recorded cell of ``spec`` on ``device``; returns
    the artifact directory. Append-only and interrupt-safe (see module
    docstring)."""
    device = resolve_device(device)
    say = progress or (lambda _msg: None)
    d = sweep_dir(spec, out_root)
    d.mkdir(parents=True, exist_ok=True)
    cells_path = d / "cells.jsonl"
    header = _header(spec)

    done: Dict[str, Dict[str, Any]] = {}
    if cells_path.exists() and not fresh:
        prior = read_header(cells_path)
        if prior.get("spec") != header["spec"]:
            raise RuntimeError(
                f"{cells_path} was produced by a different spec; rerun with "
                f"fresh=True (CLI: --fresh) to discard it"
            )
        done = {rec["cell"]: rec for rec in load_cells(cells_path)}
        # Repair a torn tail (interrupted mid-write): drop the partial line
        # so appended records don't concatenate onto it.
        raw = cells_path.read_text()
        if raw and not raw.endswith("\n"):
            cells_path.write_text(raw[: raw.rfind("\n") + 1])
    else:
        cells_path.write_text(json.dumps(header) + "\n")
    (d / "spec.toml").write_text(spec.to_toml())

    cells = spec.cells()
    todo = [c for c in cells if c.cell_id not in done]
    say(f"sweep {spec.name}: {len(cells)} cells, {len(done)} recorded, "
        f"{len(todo)} to run on {device_name(device)}")
    run_fn = _CELL_RUNNERS[spec.mode]
    for c in todo:
        seed = spec.workload_seed(c)
        t0 = time.perf_counter()
        with obs.REGISTRY.scope() as scope:
            metrics = run_fn(spec, c, seed, device)
        rec = {
            "schema": SCHEMA,
            "sweep": spec.name,
            "cell": c.cell_id,
            "params": c.flat(),
            "seed": seed,
            "replicates": spec.replicates,
            "device": device_name(device),
            "cell_seconds": _r(time.perf_counter() - t0, 3),
            "metrics": metrics,
            "obs": _obs_delta(scope),
        }
        with cells_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        say(f"  cell {c.index + 1}/{len(cells)} {c.cell_id}: "
            f"{rec['cell_seconds']:.2f}s")
    return d
