"""The benchmark's own CPU tests: ``python -m pytest rtacbench/tests`` from
the repository's root. They run each cell at a tiny size through the port's
plain kernel versions (``device="cpu"``)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

#: tiny sizes of each cell, for the CPU
RB = {"n": 16, "max_assignments": 150}
TINY = {
    "rb100-40.portfolio": {"config": RB, "workload": {
        "batch": 4, "batches": 2, "warm_assignments": 20,
        "trace": {"after_s": 0.0, "min_s": 0.1}}},
    "rb100-40.single": {"config": RB, "workload": {
        "instances": 3, "warm_assignments": 20, "check_solves": 2,
        "trace": {"after_s": 0.0, "min_s": 0.1}}},
    "rb100-40.service": {"config": RB, "workload": {
        "rate": 20.0, "initial_slots": 4, "warm_requests": 2, "warm_assignments": 20,
        "check_requests": 3, "trace": {"after_s": 0.2, "min_s": 0.2}}},
    "prod4096.batch512": {"config": {"n": 64, "d": 8, "density": 0.2, "tightness": 0.5},
                          "workload": {"batch": 16, "pool": 2, "check_calls": 2,
                                       "trace": {"after_s": 0.0, "min_s": 0.1}}},
}
#: a seed past 32 signed bits, as the benchmark's callers give
SEED = 2**31 + 4321
#: a cell whose files are kept and tested but that BENCHMARK.json leaves
#: out (PERF.md, Open questions); `service_cell.json` holds its entries
SERVICE_CELL = "rb100-40.service"


@pytest.fixture(scope="session")
def benchmark(tmp_path_factory):
    """A copy of BENCHMARK.json with the service cell's entries added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(os.path.dirname(__file__), "service_cell.json")) as f:
        for key, entries in json.load(f).items():
            bench[key].extend(entries)
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
