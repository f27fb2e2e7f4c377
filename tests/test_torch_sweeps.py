"""The port's sweep harness against the reference's: the same specs expand
into the same cells and seeds; the same tiny cells give the same metrics
(every one not read off a clock) and obs deltas in each mode; resume, torn
tails and changed specs behave alike; the port's report over the committed
artifacts gives the reference's verdicts and byte-identical figures. The
port runs with ``device="cpu"`` (the Hopper engines' plain kernel
versions)."""

import json
import shutil
from pathlib import Path

import pytest

from repro.sweeps import SweepSpec as RefSpec, load_cells as ref_load_cells
from repro.sweeps import report as ref_report, run_spec as ref_run_spec
from repro.sweeps import spec as ref_spec_mod
from repro_torch.sweeps import SCHEMA, SweepSpec, load_cells, load_spec, run_spec, sweep_dir
from repro_torch.sweeps import __main__ as cli, report, spec as spec_mod

ROOT = Path(__file__).resolve().parents[1]
COMMITTED_RESULTS = ROOT / "results"
SPEC_NAMES = ["cache_pool", "model_rb_phase", "recurrence_density", "service_capacity", "smoke"]
CLAIM_KEYS = ["recurrence-count", "per-assignment-time", "phase-transition", "hardness-effort",
              "service-capacity", "cache-pool"]

#: metrics read off a clock (the record's ``cell_seconds`` too)
CLOCK_METRICS = {"wall_s", "instances_per_s", "median_latency_ms", "p90_latency_ms",
                 "per_assignment_ms", "batched_per_assignment_ms"}
#: a service cell replays on a fast-forward clock that runs at wall speed,
#: so how many arrivals each round sees — and with it the rounds, launches,
#: dispatch widths and latencies — follows the host's pace; per-request
#: outcomes, cache hits, recurrences and rows a request do not
SERVICE_CLOCK_METRICS = {"throughput_rps", "p50_ms", "p95_ms", "p99_ms",
                         "mean_rows_per_dispatch", "rounds", "launches",
                         "mean_launches_per_round", "slo_breached"}
SERVICE_CLOCK_COUNTERS = {"driver.rounds", "driver.launches"}
HOPPER = ("hopper_packed", "hopper_dense")


def _tiny_doc(**overrides):
    """The reference's `tests/test_sweeps.py::_tiny_spec` grid."""
    doc = {
        "schema": SCHEMA, "name": "t_tiny", "title": "tiny", "mode": "solve_many",
        "seed": 3, "replicates": 2,
        "problem": {"family": "random_binary",
                    "knobs": {"n": [6, 8], "tightness": [0.2, 0.3], "d": 4, "density": 0.5}},
        "solver": {"engine": "einsum"},
    }
    doc.update(overrides)
    return doc


#: mode -> (spec doc without the engine, reference engines, port engines)
MODES = {
    "solve_many": (_tiny_doc(), ["einsum"], ["einsum", *HOPPER]),
    "assignments": (
        _tiny_doc(name="t_asg", mode="assignments", seed=1,
                  problem={"family": "random_binary",
                           "knobs": {"n": [6, 10], "d": 4, "density": 0.5, "tightness": 0.2}},
                  solver={"n_assignments": 3}),
        ["einsum", "ac3"], ["einsum", "ac3", *HOPPER]),
    "service": (
        {"schema": SCHEMA, "name": "t_svc", "mode": "service", "seed": 1,
         "service": {"families": ["model_rb", "coloring_random"], "kind": "dedup",
                     "pool_size": [1, 2], "rate": 6.0, "duration": 1.0,
                     "max_assignments": 50, "slo_p95_ms": 1000.0},
         "solver": {}},
        ["einsum"], ["einsum", *HOPPER]),
}
CASES = [(mode, engine) for mode, (_, _, engines) in MODES.items() for engine in engines]


def _with_engines(doc, engines):
    return {**doc, "solver": {**doc["solver"], "engine": engines}}


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    """mode -> (reference records, port records), each mode run once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            doc, ref_engines, port_engines = MODES[mode]
            root = tmp_path_factory.mktemp(mode)
            d_ref = ref_run_spec(RefSpec.from_doc(_with_engines(doc, ref_engines)),
                                 out_root=root / "ref", progress=None)
            d_port = run_spec(SweepSpec.from_doc(_with_engines(doc, port_engines)),
                              out_root=root / "port", progress=None, device="cpu")
            cache[mode] = (ref_load_cells(d_ref / "cells.jsonl"),
                           load_cells(d_port / "cells.jsonl"))
        return cache[mode]

    return get


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_committed_spec_copies_expand_as_the_reference(name):
    ours = spec_mod.SPEC_DIR / f"{name}.toml"
    theirs = ref_spec_mod.SPEC_DIR / f"{name}.toml"
    assert ours.read_bytes() == theirs.read_bytes()
    text = ours.read_text()
    assert spec_mod.loads_toml(text) == ref_spec_mod.loads_toml(text)
    assert spec_mod._parse_toml_subset(text) == ref_spec_mod._parse_toml_subset(text)
    ours_spec, theirs_spec = load_spec(name), ref_spec_mod.load_spec(name)
    assert ours_spec.to_toml() == theirs_spec.to_toml()
    ours_cells, theirs_cells = ours_spec.cells(), theirs_spec.cells()
    assert [(c.cell_id, c.params) for c in ours_cells] == \
        [(c.cell_id, c.params) for c in theirs_cells]
    assert [ours_spec.workload_seed(c) for c in ours_cells] == \
        [theirs_spec.workload_seed(c) for c in theirs_cells]
    assert spec_mod.NON_WORKLOAD_KEYS == ref_spec_mod.NON_WORKLOAD_KEYS


def test_spec_validation_matches_the_reference():
    assert set(spec_mod.available_specs()) == set(SPEC_NAMES)
    for bad, err in ((dict(mode="nope"), ValueError),
                     (dict(problem={"family": "random_binary", "knobs": {"bogus": [1]}}),
                      TypeError),
                     (dict(solver={"engine": "einsum", "n": 4}), ValueError)):
        for spec_cls in (SweepSpec, RefSpec):
            with pytest.raises(err):
                spec_cls.from_doc(_tiny_doc(**bad))


# --------------------------------------------------------------------------
# the runner: the same cells, the same metrics
# --------------------------------------------------------------------------


def _drop(d: dict, keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


@pytest.mark.parametrize("mode,engine", CASES)
def test_port_cells_equal_the_reference(mode_runs, mode, engine):
    ref_records, port_records = mode_runs(mode)
    _, ref_engines, _ = MODES[mode]
    ref_engine = engine if engine in ref_engines else "einsum"
    ref_by_cell = {json.dumps(_drop(r["params"], {"engine"}), sort_keys=True): r
                   for r in ref_records if r["params"]["engine"] == ref_engine}
    mine = [r for r in port_records if r["params"]["engine"] == engine]
    assert mine and len(mine) == len(ref_by_cell)
    for rec in mine:
        want = ref_by_cell[json.dumps(_drop(rec["params"], {"engine"}), sort_keys=True)]
        assert rec["device"] == "cpu"
        assert (rec["seed"], rec["cell"].replace(engine, ref_engine)) == (want["seed"],
                                                                          want["cell"])
        got_m, want_m = rec["metrics"], want["metrics"]
        assert set(got_m) == set(want_m)
        skip = set(CLOCK_METRICS)
        counters_skip = set()
        hists_skip = set()
        if mode == "service":
            skip |= SERVICE_CLOCK_METRICS | {"engine"}
            counters_skip |= SERVICE_CLOCK_COUNTERS
        if engine in HOPPER:
            # launches follow each engine's rule: one fused launch a round
            if mode == "solve_many":
                assert got_m["launches_per_round"] == 1.0
                obs_c = rec["obs"]["counters"]
                assert obs_c["driver.launches"] == obs_c["driver.rounds"]
                skip.add("launches_per_round")
                counters_skip.add("driver.launches")
                hists_skip.add("many.launches_per_solve")
            if mode == "service":
                assert got_m["launches"] == got_m["rounds"]
                # resident bytes count the engine's own network layout
                got_m = {**got_m, "cache": _drop(got_m["cache"], {"bytes_in_use"})}
                want_m = {**want_m, "cache": _drop(want_m["cache"], {"bytes_in_use"})}
        assert _drop(got_m, skip) == _drop(want_m, skip)
        assert _drop(rec["obs"]["counters"], counters_skip) == \
            _drop(want["obs"]["counters"], counters_skip)
        assert _drop(rec["obs"]["histograms"], hists_skip) == \
            _drop(want["obs"]["histograms"], hists_skip)


@pytest.mark.parametrize("case", ["interrupt", "torn_tail", "changed_spec"])
def test_runner_resume_protocol(tmp_path, case):
    """As the reference's runner: an interrupted sweep reruns only its
    missing cells, a torn tail line is dropped and its cell redone, and a
    changed spec is refused unless ``fresh=True``."""
    spec = SweepSpec.from_doc(_tiny_doc())
    d = run_spec(spec, out_root=tmp_path, progress=None, device="cpu")
    cells_path = d / "cells.jsonl"
    lines = cells_path.read_text().splitlines(keepends=True)
    assert len(lines) == 1 + 4
    full = {r["cell"]: r for r in load_cells(cells_path)}
    if case == "changed_spec":
        changed = SweepSpec.from_doc(_tiny_doc(seed=99))
        with pytest.raises(RuntimeError, match="different spec"):
            run_spec(changed, out_root=tmp_path, progress=None, device="cpu")
        d2 = run_spec(changed, out_root=tmp_path, fresh=True, progress=None, device="cpu")
        fresh = load_cells(d2 / "cells.jsonl")
        assert len(fresh) == 4
        assert all(r["seed"] != full[r["cell"]]["seed"] for r in fresh)
        return
    kept = 2 if case == "interrupt" else 3
    tail = "" if case == "interrupt" else lines[kept + 1][: len(lines[kept + 1]) // 2]
    cells_path.write_text("".join(lines[:kept + 1]) + tail)
    assert len(load_cells(cells_path)) == kept
    run_spec(spec, out_root=tmp_path, progress=None, device="cpu")
    resumed = load_cells(cells_path)
    ids = [r["cell"] for r in resumed]
    assert sorted(ids) == sorted(full) and len(set(ids)) == len(ids) == 4
    assert cells_path.read_text().endswith("\n")
    for r in resumed:
        assert r["seed"] == full[r["cell"]]["seed"]
        assert _drop(r["metrics"], CLOCK_METRICS) == _drop(full[r["cell"]]["metrics"],
                                                            CLOCK_METRICS)
    assert sweep_dir(spec, tmp_path) == d and (d / "spec.toml").exists()


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def committed():
    """(the port's, the reference's) collected committed artifacts."""
    return report.collect(COMMITTED_RESULTS), ref_report.collect(COMMITTED_RESULTS)


@pytest.mark.parametrize("key", CLAIM_KEYS)
def test_report_claim_matches_the_reference(committed, key):
    ours_loaded, theirs_loaded = committed
    ours = next(c for c in report.CLAIMS if c.key == key)
    theirs = next(c for c in ref_report.CLAIMS if c.key == key)
    assert (ours.sweep, ours.title, [f.filename for f in ours.figures]) == \
        (theirs.sweep, theirs.title, [f.filename for f in theirs.figures])
    spec, records = ours_loaded[ours.sweep]
    ref_spec, ref_records = theirs_loaded[theirs.sweep]
    assert ours.verdict(records, spec) == theirs.verdict(ref_records, ref_spec)
    for fig, ref_fig in zip(ours.figures, theirs.figures):
        svg = fig.build(records, spec)
        assert svg == ref_fig.build(ref_records, ref_spec)
        assert svg == (COMMITTED_RESULTS / "figures" / fig.filename).read_text()


def _copy_committed(out_root: Path) -> None:
    for name in {c.sweep for c in report.CLAIMS}:
        (out_root / name).mkdir(parents=True)
        shutil.copy(COMMITTED_RESULTS / name / "cells.jsonl", out_root / name / "cells.jsonl")


def _tree_state():
    watched = [ROOT / "RESULTS.md", *sorted(COMMITTED_RESULTS.rglob("*"))]
    return {p: p.read_bytes() for p in watched if p.is_file()}, (ROOT / "results_torch").exists()


def test_build_report_writes_only_under_its_out_root(tmp_path):
    _copy_committed(tmp_path)
    before = _tree_state()
    written = report.build_report(out_root=tmp_path)
    assert _tree_state() == before
    assert written and all(tmp_path in p.parents for p in written)
    assert written[0] == tmp_path / "RESULTS.md"
    md = written[0].read_text()
    assert "src/repro_torch/sweeps" in md and "CPU host" in md
    for claim in report.CLAIMS:
        assert f"(figures/{claim.figures[0].filename})" in md
        assert f"sweeps/specs/{claim.sweep}.toml)" in md
    assert report.check_report(tmp_path) == []
    fig = tmp_path / "figures" / report.CLAIMS[0].figures[0].filename
    fig.write_text(fig.read_text() + " ")
    assert any("drifts" in m for m in report.check_report(tmp_path))


def test_cli_list_run_and_report(tmp_path, capsys):
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in SPEC_NAMES)
    tiny = tmp_path / "tiny.toml"
    tiny.write_text(SweepSpec.from_doc(_tiny_doc()).to_toml())
    out = tmp_path / "out"
    assert cli.main(["run", str(tiny), "--device", "cpu", "--out", str(out)]) == 0
    assert len(load_cells(out / "t_tiny" / "cells.jsonl")) == 4
    _copy_committed(out)
    assert cli.main(["report", "--check", "--out", str(out)]) == 1  # nothing written yet
    assert cli.main(["report", "--out", str(out)]) == 0
    assert cli.main(["report", "--check", "--out", str(out)]) == 0
    assert "in sync" in capsys.readouterr().out
