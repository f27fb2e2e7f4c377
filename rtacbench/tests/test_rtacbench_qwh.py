"""The quasigroup-with-holes cell at a CPU size: a well-formed, correct
result line traced and untraced, on both single-network routes (the tiny
shape fits the fused kernel; ``fixpoint: stepped`` takes the host loop the
order-40 cell takes on the card), and a check that fails on the control and
on faults planted in the host loop's fixpoint."""

import json
import time

import pytest
from conftest import SEED

from rtacbench.lib import harness

CELL = "qwh-40-672.single"
#: order 7, 42 % holes as at order 40, a budget that some solves reach
TINY = {"config": {"order": 7, "holes": 21, "moves": 343, "max_assignments": 60},
        "workload": {"instances": 3, "warm_assignments": 20, "check_solves": 2,
                     "trace": {"after_s": 0.0, "min_s": 0.1}}}


def _run(trace=False, program="port", fixpoint="fused", seconds=0.5):
    overrides = {"config": dict(TINY["config"], fixpoint=fixpoint),
                 "workload": TINY["workload"]}
    return harness.run_cell(CELL, SEED, seconds, trace, time.perf_counter(), device="cpu",
                            overrides=overrides, program=program)


@pytest.mark.parametrize("fixpoint", ["fused", "stepped"])
@pytest.mark.parametrize("trace", [0, 1])
def test_qwh_cell_runs_and_agrees_with_reference(trace, fixpoint):
    line = json.loads(json.dumps(_run(bool(trace), fixpoint=fixpoint)))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        # no card: no revise launch to count, no kernel time to read; the
        # search driver's untraced rounds, where the window had some
        assert set(line["metrics"]) <= {"round_ms", "idle_pct.assign", "wide_revises_per_round",
                                        "packed_revise_small_b_roofline"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"assign_rate", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_qwh_control_is_not_correct():
    assert _run(program="control")["correct"] is False


def _altered(res, dom):
    return type(res)(res.dom, res.consistent, res.n_recurrences + 1)


def _unchanged(res, dom):
    return type(res)(dom, res.consistent | True, res.n_recurrences.clamp(max=1))


@pytest.mark.parametrize("plant", [_altered, _unchanged])
def test_qwh_planted_fault_in_the_host_loop_is_not_correct(plant, monkeypatch):
    from repro_torch.core import rtac

    real = rtac.enforce_batch_generic

    def broken(network, dom, changed0=None, revise_fn=rtac._EINSUM_REVISE):
        return plant(real(network, dom, changed0, revise_fn), dom)

    monkeypatch.setattr(rtac, "enforce_batch_generic", broken)
    assert _run(fixpoint="stepped")["correct"] is False
