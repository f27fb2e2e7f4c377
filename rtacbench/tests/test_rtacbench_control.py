"""What decides ``correct`` has to fail: the control (the reference with a
broken guarantee in the program's place) and faults planted in the port's
timed path underneath a run make every cell come out not correct."""

import itertools
import time

import pytest
import torch
from conftest import SEED, TINY

from rtacbench.lib import harness

STACKED = ("rb100-40.portfolio", "rb100-40.service")  # the stacked fixpoint's cells
SINGLE = ("rb100-40.single", "prod4096.batch512")  # the single-network fixpoint's


def _run(cell, benchmark, program="port"):
    return harness.run_cell(cell, SEED, 0.4, False, time.perf_counter(), device="cpu",
                            benchmark=benchmark, overrides=TINY[cell], program=program)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell, benchmark):
    assert _run(cell, benchmark, program="control")["correct"] is False


def _unchanged(res, dom, n_rows):
    return type(res)(dom, res.consistent | True, torch.ones_like(res.n_recurrences))


_CALLS = itertools.count()


def _half(res, dom, n_rows):
    # every other row, the other half on the next call: each search is hit
    keep = (torch.arange(n_rows) + next(_CALLS)) % 2 == 1
    return type(res)(torch.where(keep[:, None, None], res.dom, dom),
                     torch.where(keep, res.consistent, torch.ones_like(res.consistent)),
                     torch.where(keep, res.n_recurrences, torch.zeros_like(res.n_recurrences)))


def _altered(res, dom, n_rows):
    # every row's count, so that whichever rows the check samples are hit
    return type(res)(res.dom, res.consistent, res.n_recurrences + 1)


FAULTS = {"state_unchanged": _unchanged, "half_the_batch_left_out": _half,
          "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_planted_fault_is_not_correct(cell, fault, monkeypatch, benchmark):
    from repro_torch.core import rtac
    from repro_torch.kernels import ops

    plant = FAULTS[fault]
    if cell in STACKED:
        real = ops.enforce_rows

        def broken(kind, fused, tables, dom_p, ch_p, idx, kdims):
            return plant(real(kind, fused, tables, dom_p, ch_p, idx, kdims), dom_p,
                         dom_p.shape[0])

        monkeypatch.setattr(ops, "enforce_rows", broken)
    else:
        real = rtac.enforce_batch_generic

        def broken(network, dom, changed0=None, revise_fn=rtac._EINSUM_REVISE):
            return plant(real(network, dom, changed0, revise_fn), dom, dom.shape[0])

        monkeypatch.setattr(rtac, "enforce_batch_generic", broken)
    assert _run(cell, benchmark)["correct"] is False
