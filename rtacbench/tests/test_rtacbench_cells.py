"""Every cell at a tiny size on the CPU, through the port's plain kernel
versions: a well-formed result line, agreeing with the reference."""

import json
import time

import pytest
from conftest import SEED, TINY

from rtacbench.lib import harness, spec


def _bench(path=spec.HERE.parent / "BENCHMARK.json"):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_and_agrees_with_reference(cell, trace, capsys, benchmark):
    result = harness.run_cell(cell, SEED, 0.6, bool(trace), time.perf_counter(),
                              device="cpu", benchmark=benchmark, overrides=TINY[cell])
    line = json.loads(json.dumps(result))  # the line is plain JSON
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["count"] == 1
    bench = _bench(benchmark)
    if trace:
        allowed = {m["name"] for m in bench["per_layer"]
                   if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) <= allowed
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    err = capsys.readouterr().err.strip().splitlines()
    names = list(line["checks"])
    assert [e.split(":")[0] for e in err[-len(names):]] == [f"check {n}" for n in names]


def test_every_cell_and_metric_has_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert (spec.HERE / "drivers" / f"{cell.workload['driver']}.py").is_file()
        assert cell.per_layer, w["name"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2
    for m in bench["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in bench["configs"]:
        assert (spec.HERE.parent / c["file"]).is_file()
