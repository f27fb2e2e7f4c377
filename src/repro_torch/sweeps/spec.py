"""Declarative sweep specs: TOML files ↔ `SweepSpec` dataclasses ↔ cell grids.

The port's own copy of `repro.sweeps.spec` (the parser included): the same
specs expand into the same cells and workload seeds. Problem knobs validate
against `repro_torch.problems`; the committed specs under ``specs/`` are
byte-identical copies of the reference's.

A sweep spec names ONE study — a problem family (or a service workload), the
knobs to hold fixed, and the knobs to sweep — and expands deterministically
into a list of *cells*: every point of the Cartesian product of its axes. Any
knob whose TOML value is a **list** is an axis; scalars are fixed. The cell
list is a pure function of the spec (axes expand in sorted ``(table, key)``
order), so the same spec file always produces the byte-identical grid — the
property the runner's resume protocol and the committed artifacts lean on.

Spec layout (``schema = "repro-sweep/v1"``)::

    schema = "repro-sweep/v1"
    name = "model_rb_phase"            # artifact directory + RESULTS anchor
    title = "..."                      # human heading for the report
    mode = "solve_many"                # solve_many | assignments | service
    seed = 0                           # base seed for every derived stream
    replicates = 12                    # instances per cell (per-cell medians)

    [problem]                          # solve_many / assignments modes
    family = "model_rb"
    [problem.knobs]                    # validated against the family registry
    n = [10, 14]                       # list  -> sweep axis
    hardness = [0.5, 1.0, 1.5]         # list  -> sweep axis
    alpha = 0.8                        # scalar -> fixed knob

    [solver]                           # engine / search knobs (axes allowed)
    engine = "einsum"
    max_assignments = 4000

    [service]                          # service mode (axes allowed)
    families = ["model_rb"]
    kind = "poisson"                   # poisson | dedup
    rate = [4.0, 8.0, 16.0]            # offered-rate axis
    duration = 3.0
    slo_p95_ms = 500.0

    [report]                           # hints for the analysis module
    x = "hardness"
    series = "n"
    claim = "..."

TOML support: Python 3.10 has no ``tomllib``, so this module carries a
minimal parser for exactly the subset
the specs use (``[table]`` / ``[table.sub]`` headers, ``key = value`` with
strings, ints, floats, booleans, and flat homogeneous arrays, ``#`` comments).
When ``tomllib`` is importable it is preferred; `dumps_toml` emits the same
subset, and the spec round-trip is tested through both parsers.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import zlib
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

try:  # Python >= 3.11
    import tomllib as _tomllib
except ImportError:  # Python 3.10: the subset parser below takes over
    _tomllib = None

#: artifact + spec wire schema; bump together with the cell-record layout
SCHEMA = "repro-sweep/v1"

#: spec search path for `load_spec("name")` — the committed study definitions
SPEC_DIR = Path(__file__).resolve().parent / "specs"

MODES = ("solve_many", "assignments", "service")

#: cell keys excluded from the workload seed, so e.g. every engine enforces
#: the same sampled assignment sites and every offered rate replays the same
#: arrival pattern (see `workload_seed`)
NON_WORKLOAD_KEYS = ("engine", "rate")


# --------------------------------------------------------------------------
# minimal TOML subset (read + write)
# --------------------------------------------------------------------------


def _parse_scalar(tok: str, where: str):
    tok = tok.strip()
    if not tok:
        raise ValueError(f"{where}: empty value")
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        body = tok[1:-1]
        if '"' in body or "\\" in body:
            raise ValueError(f"{where}: escapes/quotes in strings unsupported")
        return body
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise ValueError(f"{where}: cannot parse value {tok!r}") from None


def _split_array(body: str, where: str) -> List[str]:
    """Split a flat array body on commas, respecting string quotes."""
    items, depth, cur = [], False, []
    for ch in body:
        if ch == '"':
            depth = not depth
            cur.append(ch)
        elif ch == "," and not depth:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth:
        raise ValueError(f"{where}: unterminated string in array")
    tail = "".join(cur).strip()
    if tail:
        items.append(tail)
    return [i for i in (s.strip() for s in items) if i]


def _parse_toml_subset(text: str) -> Dict[str, Any]:
    """Parse the spec TOML subset (see module docstring) into nested dicts."""
    root: Dict[str, Any] = {}
    table = root
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"line {lineno}"
        line = raw.strip()
        # strip comments (respecting strings)
        if "#" in line:
            out, in_str = [], False
            for ch in line:
                if ch == '"':
                    in_str = not in_str
                if ch == "#" and not in_str:
                    break
                out.append(ch)
            line = "".join(out).strip()
        if not line:
            continue
        if line.startswith("["):
            if not line.endswith("]") or line.startswith("[["):
                raise ValueError(f"{where}: unsupported table header {line!r}")
            table = root
            for part in line[1:-1].strip().split("."):
                if not part:
                    raise ValueError(f"{where}: bad table name {line!r}")
                table = table.setdefault(part, {})
                if not isinstance(table, dict):
                    raise ValueError(f"{where}: {part!r} is not a table")
            continue
        if "=" not in line:
            raise ValueError(f"{where}: expected key = value, got {line!r}")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if not key:
            raise ValueError(f"{where}: empty key")
        if val.startswith("["):
            if not val.endswith("]"):
                raise ValueError(f"{where}: multiline arrays unsupported")
            table[key] = [
                _parse_scalar(t, where) for t in _split_array(val[1:-1], where)
            ]
        else:
            table[key] = _parse_scalar(val, where)
    return root


def loads_toml(text: str) -> Dict[str, Any]:
    """Parse spec TOML — via ``tomllib`` when available, else the subset
    parser (both accept everything `dumps_toml` emits)."""
    if _tomllib is not None:
        return _tomllib.loads(text)
    return _parse_toml_subset(text)


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        if '"' in v or "\\" in v or "\n" in v:
            raise ValueError(f"cannot emit string with quotes/escapes: {v!r}")
        return f'"{v}"'
    if isinstance(v, float):
        # repr keeps round-trip exactness; TOML floats need a '.' or exponent
        s = repr(v)
        return s if ("." in s or "e" in s or "inf" in s or "nan" in s) else s + ".0"
    if isinstance(v, int):
        return str(v)
    raise TypeError(f"unsupported TOML scalar {type(v).__name__}: {v!r}")


def _emit_table(out: List[str], table: Mapping[str, Any], prefix: str) -> None:
    subtables = []
    for k, v in table.items():
        if isinstance(v, Mapping):
            subtables.append((k, v))
        elif isinstance(v, (list, tuple)):
            out.append(f"{k} = [{', '.join(_fmt_scalar(i) for i in v)}]")
        else:
            out.append(f"{k} = {_fmt_scalar(v)}")
    for k, v in subtables:
        name = f"{prefix}.{k}" if prefix else k
        out.append("")
        out.append(f"[{name}]")
        _emit_table(out, v, name)


def dumps_toml(doc: Mapping[str, Any]) -> str:
    """Emit nested dicts as the TOML subset `loads_toml` accepts."""
    out: List[str] = []
    _emit_table(out, doc, "")
    return "\n".join(out).lstrip("\n") + "\n"


# --------------------------------------------------------------------------
# the spec dataclass
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cell:
    """One grid point: the fully resolved knob values of a single run cell.

    ``params`` maps table name (``problem`` / ``solver`` / ``service``) to its
    resolved scalar knobs. ``cell_id`` is the stable identity the runner's
    resume protocol dedupes on — a pure function of the resolved values,
    independent of axis declaration order.
    """

    index: int
    params: Dict[str, Dict[str, Any]]

    @property
    def cell_id(self) -> str:
        flat = self.flat()
        return ",".join(f"{k}={flat[k]}" for k in sorted(flat))

    def flat(self) -> Dict[str, Any]:
        """One flat knob dict (table prefixes dropped; keys are unique by
        spec validation)."""
        out: Dict[str, Any] = {}
        for tab in sorted(self.params):
            out.update(self.params[tab])
        return out


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One declarative study: fixed knobs + axes, expanded by `cells()`."""

    name: str
    mode: str
    title: str = ""
    seed: int = 0
    replicates: int = 1
    problem: Dict[str, Any] = dataclasses.field(default_factory=dict)
    solver: Dict[str, Any] = dataclasses.field(default_factory=dict)
    service: Dict[str, Any] = dataclasses.field(default_factory=dict)
    report: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- validation ---------------------------------------------------------

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"{self.name}: mode {self.mode!r} not in {MODES}")
        if self.replicates < 1:
            raise ValueError(f"{self.name}: replicates must be >= 1")
        if self.mode == "service":
            if self.problem:
                raise ValueError(f"{self.name}: service mode takes no [problem]")
            for req in ("families", "rate", "duration"):
                if req not in self.service:
                    raise ValueError(f"{self.name}: [service] needs {req!r}")
        else:
            fam = self.problem.get("family")
            if not fam:
                raise ValueError(f"{self.name}: [problem] needs family = ...")
            # knob names (and axis values) validate against the registry
            from repro_torch.problems import get_problem

            family = get_problem(fam)
            family.validate_sweep(self.problem.get("knobs", {}))
        seen: Dict[str, str] = {}
        for tab, knobs in self._tables():
            for k in knobs:
                if k in seen:
                    raise ValueError(
                        f"{self.name}: knob {k!r} appears in both "
                        f"[{seen[k]}] and [{tab}]"
                    )
                seen[k] = tab

    def _tables(self) -> List[Tuple[str, Dict[str, Any]]]:
        tabs = [("solver", self.solver)]
        if self.mode == "service":
            tabs.append(("service", self.service))
        else:
            tabs.insert(0, ("problem", self.problem.get("knobs", {})))
        return tabs

    # --- grid expansion -----------------------------------------------------

    def axes(self) -> Dict[Tuple[str, str], List[Any]]:
        """Ordered ``(table, knob) -> values`` for every list-valued knob,
        sorted by ``(table, knob)`` so the grid order never depends on file
        formatting. ``service.families`` is a fixed list, never an axis."""
        axes: Dict[Tuple[str, str], List[Any]] = {}
        for tab, knobs in self._tables():
            for k, v in knobs.items():
                if (tab, k) == ("service", "families"):
                    continue
                if isinstance(v, (list, tuple)):
                    if not v:
                        raise ValueError(f"{self.name}: axis {tab}.{k} is empty")
                    axes[(tab, k)] = list(v)
        return dict(sorted(axes.items()))

    def cells(self) -> List[Cell]:
        """The full deterministic grid: Cartesian product of `axes()` over
        the fixed knobs, one `Cell` per point, ``replicates`` handled by the
        runner inside each cell (not as an axis)."""
        axes = self.axes()
        fixed: Dict[str, Dict[str, Any]] = {}
        for tab, knobs in self._tables():
            fixed[tab] = {
                k: v for k, v in knobs.items() if (tab, k) not in axes
            }
        if self.mode != "service":
            fixed.setdefault("problem", {})
            fixed["problem"]["family"] = self.problem["family"]
        cells = []
        for i, combo in enumerate(itertools.product(*axes.values())):
            params = {tab: dict(kv) for tab, kv in fixed.items()}
            for (tab, k), v in zip(axes.keys(), combo):
                params.setdefault(tab, {})[k] = v
            cells.append(Cell(index=i, params=params))
        return cells

    # --- seeding ------------------------------------------------------------

    def workload_seed(self, cell: Cell) -> int:
        """The cell's workload seed: a CRC of the spec seed and every resolved
        knob EXCEPT `NON_WORKLOAD_KEYS` — so cells that differ only in engine
        enforce identical instances/sites, and capacity-ramp cells that differ
        only in offered rate replay the same arrival pattern."""
        flat = {
            k: v for k, v in cell.flat().items() if k not in NON_WORKLOAD_KEYS
        }
        blob = json.dumps([self.seed, flat], sort_keys=True)
        return zlib.crc32(blob.encode()) & 0x7FFFFFFF

    # --- (de)serialization --------------------------------------------------

    def to_doc(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "schema": SCHEMA,
            "name": self.name,
            "title": self.title,
            "mode": self.mode,
            "seed": self.seed,
            "replicates": self.replicates,
        }
        if self.problem:
            doc["problem"] = {
                k: v for k, v in self.problem.items() if k != "knobs"
            }
            if self.problem.get("knobs"):
                doc["problem"]["knobs"] = dict(self.problem["knobs"])
        if self.solver:
            doc["solver"] = dict(self.solver)
        if self.service:
            doc["service"] = dict(self.service)
        if self.report:
            doc["report"] = dict(self.report)
        return doc

    def to_toml(self) -> str:
        return dumps_toml(self.to_doc())

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "SweepSpec":
        schema = doc.get("schema")
        if schema != SCHEMA:
            raise ValueError(f"spec schema {schema!r} != {SCHEMA!r}")
        known = {
            "schema", "name", "title", "mode", "seed", "replicates",
            "problem", "solver", "service", "report",
        }
        unknown = set(doc) - known
        if unknown:
            raise ValueError(f"spec has unknown top-level keys {sorted(unknown)}")
        if "name" not in doc or "mode" not in doc:
            raise ValueError("spec needs name = ... and mode = ...")
        return cls(
            name=doc["name"],
            mode=doc["mode"],
            title=doc.get("title", ""),
            seed=int(doc.get("seed", 0)),
            replicates=int(doc.get("replicates", 1)),
            problem=dict(doc.get("problem", {})),
            solver=dict(doc.get("solver", {})),
            service=dict(doc.get("service", {})),
            report=dict(doc.get("report", {})),
        )

    @classmethod
    def from_toml(cls, text: str) -> "SweepSpec":
        return cls.from_doc(loads_toml(text))


def available_specs(spec_dir: Path = SPEC_DIR) -> List[str]:
    """Names of the committed study specs (``src/repro_torch/sweeps/specs/``)."""
    return sorted(p.stem for p in spec_dir.glob("*.toml"))


def load_spec(name_or_path: str, spec_dir: Optional[Path] = None) -> SweepSpec:
    """Load a spec by committed name (``model_rb_phase``) or by file path."""
    spec_dir = spec_dir or SPEC_DIR
    p = Path(name_or_path)
    if not p.suffix:
        p = spec_dir / f"{name_or_path}.toml"
    if not p.exists():
        raise FileNotFoundError(
            f"no sweep spec {name_or_path!r}; committed specs: "
            f"{available_specs(spec_dir)}"
        )
    return SweepSpec.from_toml(p.read_text())
