"""The Hopper engines' single-network path on its two routes.

A fused engine runs ``enforce``/``enforce_batch`` (so ``mac_solve``) as one
launch of the fused fixpoint kernel on the prepared network read as a
one-slot table, where `ops.single_fused` admits the padded shape; a stepped
engine, and every shape the gate refuses, runs the host loop over the
single-network revise. Both must give the same closures, verdicts and
recurrence counts on `mac_solve`'s row mixes: the root with its seedless
call, one child, five, and 40 padded to 64 as `mac_solve` pads them. On the
CPU each kernel wrapper computes its plain version.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.engine import pad_round_rows
from repro_torch.engines import get_engine
from repro_torch.kernels import launch, ops
from repro_torch.problems import generate

CPU = torch.device("cpu")

#: two padded shapes: n_p=32, d_p=16 (W=1) and n_p=40, d_p=40 (W=2)
SHAPES = [("model_rb", dict(n=30, hardness=0.9)),
          ("random_binary", dict(n=40, d=40, density=0.3, tightness=0.6))]


def _routes():
    return (obs.REGISTRY.counter("fixpoint.one_launch"),
            obs.REGISTRY.counter("fixpoint.host_loop"))


def _children(root, n_rows, rng):
    """``n_rows`` rows as `mac_solve` would meet them: the first half
    children of the root closure (a variable assigned, its one-hot seed),
    the rest children of a deeper node (four more variables assigned, all
    five seeded), most of which wipe out; the last but one a seedless copy
    of the row before it (it freezes before its first recurrence), the last
    an empty domain (inconsistent from the start)."""
    n = root.shape[0]
    doms, chs = [], []
    for i in range(n_rows):
        dom, ch = root.copy(), np.zeros(n, dtype=bool)
        picks = rng.choice(n, 1 if i < n_rows // 2 else 5, replace=False)
        for var in picks:
            vals = np.nonzero(dom[var])[0]
            dom[var] = False
            dom[var, vals[rng.integers(len(vals))]] = True
        ch[picks] = True
        doms.append(dom)
        chs.append(ch)
    doms[-2], chs[-2] = doms[-3].copy(), np.zeros(n, dtype=bool)
    doms[-1][rng.integers(n)] = False
    return np.stack(doms), np.stack(chs)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["hopper_packed", "hopper_dense"])
@pytest.mark.parametrize("family,knobs", SHAPES)
def test_single_network_fused_route_equals_host_loop(name, family, knobs):
    """``enforce`` and ``enforce_batch`` of a fused engine (one launch a call)
    bit for bit against a stepped engine (the host loop): dom, consistent
    and k, on the root (seed None), 1 child, 5 and 40 padded to 64; each
    call ticks its route's counter once."""
    csp = generate(family, seed=0, device=CPU, **knobs)
    fused = get_engine(name, fixpoint="fused", device=CPU)
    stepped = get_engine(name, fixpoint="stepped", device=CPU)
    pf, ps = fused.prepare(csp), stepped.prepare(csp)
    assert ops.single_fused(fused.kind, *pf.payload[1][:2])
    dom0 = csp.dom.numpy()

    before = _routes()
    root = fused.enforce(pf, dom0)
    assert _routes() == (before[0] + 1, before[1])
    _same(root, stepped.enforce(ps, dom0))
    assert _routes() == (before[0] + 1, before[1] + 1)
    assert bool(root.consistent) and int(root.n_recurrences) > 0

    doms, chs = _children(root.dom.numpy(), 40, np.random.default_rng(0))
    k_seen, verdicts = set(), set()
    before = _routes()
    _same(fused.enforce(pf, doms[0], chs[0]), stepped.enforce(ps, doms[0], chs[0]))
    for rows in ([0, 20, 21, 38, 39], list(range(40))):
        d, c = pad_round_rows((doms[rows], chs[rows]), 1 << (len(rows) - 1).bit_length())
        got = fused.enforce_batch(pf, d, c)
        _same(got, stepped.enforce_batch(ps, d, c))
        assert got.dom.shape[0] == len(d)
        k_seen |= set(got.n_recurrences.tolist())
        verdicts |= set(got.consistent.tolist())
    assert _routes() == (before[0] + 3, before[1] + 3)
    # the mix holds rows that wipe out, rows that freeze early and late ones
    assert verdicts == {True, False}
    assert 0 in k_seen and len(k_seen) >= 3


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("n_p,d_p,fused", [
    (104, 40, True),  # rb100-40: `mac_solve`'s cell takes one launch a round
    (1536, 40, False),  # the fused CTA's mask bits alone pass the limit
    (4096, 32, False),  # the production CSP: the wide block route
])
def test_single_fused_gate(kind, n_p, d_p, fused):
    """The route follows the padded shape alone, no network built: the
    fused kernel where its CTA fits and n_p is below `SINGLE_WIDE_N`."""
    w = -(-d_p // 32)
    smem = launch.fixpoint_smem(n_p, d_p, 4 * n_p * w if kind == "packed" else n_p * d_p)
    assert (smem <= launch.SMEM_OPT_IN_LIMIT and n_p < launch.SINGLE_WIDE_N) == fused
    assert ops.single_fused(kind, n_p, d_p) is fused

