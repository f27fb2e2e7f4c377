"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each piece
sits in a file of its own under the benchmark's folder, found by its name:

- a configuration: ``configs/<config>.json``;
- a cell: ``workloads/<cell>.json``, which names its driver;
- a driver: ``drivers/<driver>.py`` (one module a kind of traffic);
- a per-layer metric's reader: ``metrics/<metric>.py``.

A new cell, configuration or metric is new files plus an entry in
``BENCHMARK.json``: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

#: the benchmark's folder
HERE = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    """One cell: its entry, workload file, configuration file, and the
    metrics it reports."""

    name: str
    entry: dict
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path = HERE, benchmark: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``benchmark`` (default: ``BENCHMARK.json`` beside
    the benchmark's folder ``root``)."""
    bench = _load_json(benchmark or root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _load_json(root / "workloads" / f"{name}.json")
    config = _load_json(root / "configs" / f"{entry['config']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, entry, workload, config, e2e, per_layer)


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"rtacbench_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = HERE) -> ModuleType:
    """The driver module ``drivers/<name>.py``."""
    return _module(root / "drivers" / f"{name}.py", f"driver_{name}")


def readers(metrics: List[dict], root: Path = HERE) -> Dict[str, ModuleType]:
    """Each per-layer metric's reader, ``metrics/<name>.py``."""
    return {m["name"]: _module(root / "metrics" / f"{m['name']}.py",
                               "metric_" + m["name"].replace(".", "_").replace("-", "_"))
            for m in metrics}
