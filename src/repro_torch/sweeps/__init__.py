"""`repro_torch.sweeps` — the declarative sweep harness + paper-claims
report, on the port (the counterpart of `repro.sweeps`).

Three layers, one module each:

- **spec** (`SweepSpec`, `load_spec`): TOML study definitions under
  ``specs/`` (byte-identical copies of the reference's) ↔ frozen
  dataclasses ↔ deterministic cell grids — any list-valued knob is a sweep
  axis.
- **runner** (`run_spec`): executes not-yet-recorded cells on ``device``
  (``"cuda"`` unless told ``"cpu"``) via `repro_torch.core.solve_many`, the
  Table-1/Fig-3 assignments protocol, or
  `repro_torch.service.replay_rate_cell`, appending per-cell records
  (metrics + obs-registry delta + the device's name) to resumable
  ``cells.jsonl`` artifacts under ``results_torch/``.
- **report** (`build_report`, `check_report`): pivots the artifacts into
  dependency-free SVG figures (`figures.line_chart`) and writes
  ``results_torch/RESULTS.md`` — one section per paper claim with a
  PASS/DEVIATES verdict. `check_report` is the byte-diff drift gate.

CLI: ``python -m repro_torch.sweeps {list | run | report}``.
"""

from .figures import Series, line_chart
from .report import CLAIMS, build_report, check_report, collect, pivot
from .runner import DEFAULT_OUT_ROOT, load_cells, read_header, run_spec, sweep_dir
from .spec import SCHEMA, Cell, SweepSpec, available_specs, dumps_toml, load_spec, loads_toml

__all__ = [
    "CLAIMS", "Cell", "DEFAULT_OUT_ROOT", "SCHEMA", "Series", "SweepSpec",
    "available_specs", "build_report", "check_report", "collect",
    "dumps_toml", "line_chart", "load_cells", "load_spec", "loads_toml",
    "pivot", "read_header", "run_spec", "sweep_dir",
]
