"""Kernels on the card: each CUDA kernel against its plain version at the
main path's full width, and the fused and stepped engines against each other.

Marked ``gpu``; without a CUDA device every test skips. On the card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import check_solution, solve_many
from repro_torch.core.engine import pad_dom
from repro_torch.engines import get_engine
from repro_torch.kernels import bitpack_support as bs, ops, ref
from repro_torch.problems import generate

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(csps, n_rows, device):
    """Main-path-shaped rows: one assignment applied (one-hot seed) or an
    all-changed root row, each routed to a random slot."""
    tables, (n_p, d_p, w) = get_engine("hopper_packed", device=device).prepare_many(csps).payload
    n, d = csps[0].dom.shape
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, len(csps), n_rows), dtype=torch.int32, device=device)
    var = rng.integers(0, n, n_rows)
    var[rng.random(n_rows) < 0.125] = -1
    var = torch.as_tensor(var, device=device)
    val = torch.as_tensor(rng.integers(0, d, n_rows), device=device)
    doms = torch.stack([c.dom for c in csps])[idx.long()]
    dom_p = ops.assign_padded_rows(pad_dom(doms, n_p, d_p), var, val)
    words = ref.pack_bits_ref(dom_p).reshape(n_rows, n_p * w).contiguous()
    seed = ops._padded_seed(var, n, n_p).to(torch.uint8).contiguous()
    return (tables[0], tables[1], idx, words, seed), d_p, w


@pytest.mark.parametrize("family,knobs", [
    ("model_rb", dict(n=100, alpha=0.8, r=0.7, hardness=0.9)),  # n_p=104, d_p=40, W=2
    ("random_binary", dict(n=160, d=10, density=1.0)),  # n_p=160, d_p=16, W=1
])
def test_kernels_match_plain_at_full_width(cuda, family, knobs):
    csps = [generate(family, seed=i, device=cuda, **knobs) for i in range(8)]
    args, d_p, w = _rows(csps, 256, cuda)
    bs.reset_launches()
    got = bs.packed_fixpoint_stacked(*args, d=d_p, w=w)
    want = bs.packed_fixpoint_stacked_plain(*args, d=d_p, w=w)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    torch.testing.assert_close(bs.packed_revise_stacked(*args, d=d_p, w=w),
                               bs.packed_revise_stacked_plain(*args, d=d_p, w=w), rtol=0, atol=0)
    assert bs.packed_fixpoint_stacked.launches == 1
    assert bs.packed_revise_stacked.launches == 1


def test_cuda_wrapper_raises_on_a_layout_it_cannot_hold(cuda):
    n, d, w = 4096, 8, 1  # (2·n·W + n)·4 B of shared memory > 48 KB
    cons = torch.zeros((1, n * d, n * w), dtype=torch.int32, device=cuda)
    args = (cons, torch.zeros((1, n, n), dtype=torch.uint8, device=cuda),
            torch.zeros((1,), dtype=torch.int32, device=cuda),
            torch.zeros((1, n * w), dtype=torch.int32, device=cuda),
            torch.zeros((1, n), dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        bs.packed_fixpoint_stacked(*args, d=d, w=w)


def test_solve_many_fused_equals_stepped_on_card(cuda):
    csps = [generate("model_rb", seed=i, device=cuda, n=24, hardness=0.9) for i in range(8)]
    runs = []
    for fixpoint in ("fused", "stepped"):
        tel = {}
        sols, stats = solve_many(csps, engine=get_engine("hopper_packed", fixpoint=fixpoint,
                                                         device=cuda),
                                 max_assignments=500, telemetry=tel)
        runs.append((sols, [(s.n_assignments, s.n_backtracks, s.recurrences, s.rounds)
                            for s in stats], tel))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert runs[0][2]["launches"] == runs[0][2]["rounds"]
    for csp, sol in zip(csps, runs[0][0]):
        if sol is not None:
            assert check_solution(csp, sol)
