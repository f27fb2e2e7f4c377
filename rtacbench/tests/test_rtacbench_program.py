"""What the benchmark reads from the port's own instrumentation: the
``syncs_per_round`` reader over the port's always-on registry, and the
port's tracer, which no untraced run switches on."""

import json
import time

import pytest
from conftest import SEED, TINY

from rtacbench.lib import harness, spec
from repro_torch import obs
from repro_torch.obs import tracing

METRIC = {"name": "syncs_per_round", "unit": "syncs"}


def _reader():
    """A fresh copy of the reader, as a run loads it before its set-up."""
    return spec.readers([METRIC])[METRIC["name"]]


@pytest.mark.parametrize("syncs,rounds,want", [(12, 4, 3.0), (5, 5, 1.0), (0, 4, None),
                                               (3, 0, None)])
def test_syncs_per_round_reads_the_counts_since_its_loading(syncs, rounds, want):
    obs.REGISTRY.counter_add("sync.count", 7)  # before the run: not counted
    obs.REGISTRY.counter_add("driver.rounds", 2)
    reader = _reader()
    obs.REGISTRY.counter_add("sync.count", syncs)
    obs.REGISTRY.counter_add("driver.rounds", rounds)
    rec = {"counts": {}, "trace": None, "memory_peak_bytes": 0}
    assert reader.read(rec) == want


@pytest.mark.parametrize("cell,low,high", [
    # one metadata read a round, one closure read a solved search
    ("rb100-40.portfolio", 1.0, 1.5),
    # the predicate once a recurrence and once more, the read-back: at least 3
    ("rb100-40.single", 3.0, 20.0),
])
def test_a_traced_search_cell_reports_syncs_per_round(cell, low, high, benchmark):
    result = harness.run_cell(cell, SEED, 0.6, True, time.perf_counter(), device="cpu",
                              benchmark=benchmark, overrides=TINY[cell])
    assert result["correct"] is True
    assert low <= result["metrics"]["syncs_per_round"]["value"] <= high
    bench = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == METRIC["name"])
    assert entry["workloads"] == ["rb100-40.portfolio", "rb100-40.single"]


@pytest.mark.parametrize("cell", ["rb100-40.portfolio", "rb100-40.single",
                                  "prod4096.batch512"])
def test_an_untraced_run_never_switches_the_program_tracer_on(cell, monkeypatch, benchmark):
    made = []
    real = tracing.Tracer.__init__

    def init(self, *args, **kwargs):
        made.append(args)
        real(self, *args, **kwargs)

    monkeypatch.setattr(tracing.Tracer, "__init__", init)
    obs.disable()
    result = harness.run_cell(cell, SEED, 0.4, False, time.perf_counter(), device="cpu",
                              benchmark=benchmark, overrides=TINY[cell])
    assert result["correct"] is True
    assert made == [] and obs.get_tracer() is None
