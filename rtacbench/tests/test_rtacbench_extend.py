"""A new configuration, cell and per-layer metric are new files plus entries
in BENCHMARK.json: the harness finds them by name, with no existing file
edited."""

import json
import shutil
import time

from conftest import SEED, SERVICE_CELL, TINY

from rtacbench.lib import harness, spec


def test_new_cell_config_and_metric_as_files_only(tmp_path):
    root = tmp_path / "rtacbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())

    config = json.loads((root / "configs" / "rb100-40.json").read_text())
    config.update(name="rb16-3", n=16, max_assignments=150)
    (root / "configs" / "rb16-3.json").write_text(json.dumps(config))
    (root / "workloads" / "rb16-3.single.json").write_text(json.dumps(
        {"config": "rb16-3", "driver": "single", "instances": 3, "warm_assignments": 20,
         "check_solves": 2, "pool_seed": 7}))
    (root / "metrics" / "rounds_counted.py").write_text(
        "def read(rec):\n"
        "    return float(rec['counts']['rounds'])\n")
    bench["configs"].append({"name": "rb16-3", "source": "https://doi.org/10.1613/jair.696",
                             "file": "rtacbench/configs/rb16-3.json", "reduced": ["n"],
                             "why": "a small Model RB"})
    bench["workloads"].append({"name": "rb16-3.single", "config": "rb16-3",
                               "traffic": "single", "chips": 1, "why": "a small cell"})
    bench["end_to_end"][0]["workloads"].append("rb16-3.single")
    bench["per_layer"].append({"name": "rounds_counted", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "search driver",
                               "moves": "assign_rate", "workloads": ["rb16-3.single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    for trace in (False, True):
        result = harness.run_cell("rb16-3.single", SEED, 0.4, trace, time.perf_counter(),
                                  device="cpu", root=root,
                                  benchmark=tmp_path / "BENCHMARK.json")
        assert result["correct"] is True
        assert set(result["metrics"]) >= ({"rounds_counted"} if trace
                                          else {"assign_rate", "setup_s"})
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_existing_cells_are_unchanged_by_an_added_one():
    assert set(TINY) == {SERVICE_CELL} | {w["name"] for w in json.loads(
        (spec.HERE.parent / "BENCHMARK.json").read_text())["workloads"]}
