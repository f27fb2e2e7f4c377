"""Kernels on the card: each CUDA kernel against its plain version at the
main path's full width, the fused and stepped engines against each other,
`mac_solve` on the Hopper engines against `einsum`, and the service's slot
tables at its bucket shapes against the same tables on the CPU.

Marked ``gpu``; without a CUDA device every test skips. On the card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import check_solution, mac_solve, solve_many
from repro_torch.core.csp import CSP
from repro_torch.core.engine import pad_changed, pad_dom
from repro_torch.engines import get_engine
from repro_torch.kernels import bitpack_support as bs, launch, ops, ref, rtac_support as rs
from repro_torch.problems import generate
from repro_torch.service import SolverService, bucket_for, pad_csp

pytestmark = pytest.mark.gpu

FULL_WIDTH = [
    ("model_rb", dict(n=100, alpha=0.8, r=0.7, hardness=0.9)),  # n_p=104, d_p=40, W=2
    ("random_binary", dict(n=160, d=10, density=1.0)),  # n_p=160, d_p=16, W=1
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dom_rows(dom_p, kind, w):
    """Padded bool domains (R, n_p, d_p) in a kernel's row layout."""
    r = dom_p.shape[0]
    if kind == "packed":
        return ref.pack_bits_ref(dom_p).reshape(r, -1).contiguous()
    return dom_p.to(torch.uint8).reshape(r, -1).contiguous()


def _rows(csps, n_rows, device, kind="packed"):
    """Main-path-shaped rows: one assignment applied (one-hot seed) for 7
    rows in 8, an all-changed root row for the rest, each routed to a random
    slot."""
    eng = get_engine(f"hopper_{kind}", device=device)
    tables = eng.prepare_many(csps).payload
    n, d = csps[0].dom.shape
    n_p, d_p = eng._dims(n, d)[:2]
    w = -(-d_p // 32)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, len(csps), n_rows), dtype=torch.int32, device=device)
    var = rng.integers(0, n, n_rows)
    var[rng.random(n_rows) < 0.125] = -1
    var = torch.as_tensor(var, device=device)
    val = torch.as_tensor(rng.integers(0, d, n_rows), device=device)
    doms = torch.stack([c.dom for c in csps])[idx.long()]
    dom_p = ops.assign_padded_rows(pad_dom(doms, n_p, d_p), var, val)
    seed = ops._padded_seed(var, n, n_p).to(torch.uint8).contiguous()
    return (tables[0], tables[1], idx, _dom_rows(dom_p, kind, w), seed), d_p, w


def _children(csp, b, device, kind):
    """One network and ``b`` children of its root, as `mac_solve` enforces
    them: variable 0 assigned each value in turn, one-hot seeds."""
    network, dims = get_engine(f"hopper_{kind}", device=device).prepare(csp).payload
    n_p, d_p = dims[:2]
    n, d = csp.dom.shape
    var = torch.zeros(b, dtype=torch.long, device=device)
    val = torch.arange(b, device=device) % d
    dom_p = ops.assign_padded_rows(pad_dom(csp.dom.expand(b, n, d), n_p, d_p), var, val)
    seed = ops._padded_seed(var, n, n_p).to(torch.uint8).contiguous()
    return (*network, _dom_rows(dom_p, kind, -(-d_p // 32)), seed), d_p


@pytest.mark.parametrize("family,knobs", FULL_WIDTH)
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


@pytest.mark.parametrize("family,knobs", FULL_WIDTH)
def test_dense_kernels_match_plain_at_full_width(cuda, family, knobs):
    csps = [generate(family, seed=i, device=cuda, **knobs) for i in range(8)]
    args, d_p, _ = _rows(csps, 256, cuda, "dense")
    rs.reset_launches()
    got = rs.dense_fixpoint_stacked(*args, d=d_p)
    want = rs.dense_fixpoint_stacked_plain(*args, d=d_p)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    torch.testing.assert_close(rs.dense_revise_stacked(*args, d=d_p),
                               rs.dense_revise_stacked_plain(*args, d=d_p), rtol=0, atol=0)
    assert rs.dense_fixpoint_stacked.launches == 1
    assert rs.dense_revise_stacked.launches == 1


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("family,knobs", FULL_WIDTH)
def test_single_network_kernels_match_plain_at_full_width(cuda, family, knobs, kind):
    csp = generate(family, seed=0, device=cuda, **knobs)
    args, d_p = _children(csp, 64, cuda, kind)
    if kind == "packed":
        bs.reset_launches()
        kw = dict(d=d_p, w=-(-d_p // 32))
        got, want = bs.packed_revise(*args, **kw), bs.packed_revise_plain(*args, **kw)
        launches = bs.packed_revise.launches
    else:
        rs.reset_launches()
        got, want = rs.dense_revise(*args, d=d_p), rs.dense_revise_plain(*args, d=d_p)
        launches = rs.dense_revise.launches
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert launches == 1


#: single-network shapes: the two full widths, W=3 (d_p=72), n=30 left
#: unpadded (n_p=30, not a multiple of 4 or 8: the kernels' narrow loads),
#: and n=264 (more variables than a CTA's 256 owner lanes)
SINGLE_SHAPES = {
    "main": FULL_WIDTH[0],
    "dense_mask": FULL_WIDTH[1],
    "w3_d72": ("random_binary", dict(n=40, d=72, density=0.5, tightness=0.3)),
    "n30_unpadded": ("model_rb", dict(n=30, hardness=0.9)),
    "n264": ("random_binary", dict(n=264, d=8, density=0.25)),
}
#: the rows `mac_solve` gives the single-network kernels (`_single_rows`);
#: 64 one-hot children at the two full widths are
#: `test_single_network_kernels_match_plain_at_full_width`'s
SINGLE_ROWS = ["root_b1", "multi_seed_b2", "multi_seed_b4", "one_hot_b64"]
#: wider batches (`enforce_batch` with many rows), where a CTA covers more
#: of a row: on 132 SMs B=128 gives it 24 of the main shape's 104 variables
#: (3 owner lanes a warp), and B=1024 the whole row, so its 104·13 mask
#: groups outnumber its threads and n=264 takes two passes of 256 variables
SINGLE_WIDE = [("main", "multi_seed_b128"), ("main", "multi_seed_b1024"),
               ("n264", "multi_seed_b1024")]
SINGLE_CASES = [(shape, rows) for shape in SINGLE_SHAPES for rows in SINGLE_ROWS
                if shape != "n264" and (rows != "one_hot_b64" or shape == "w3_d72")
                ] + SINGLE_WIDE


def _single_rows(csp, rows, device, kind, unpadded=False):
    """One network and a `SINGLE_ROWS` or `SINGLE_WIDE` case of its
    children: the root alone with every variable seeded; B = 2-1024 rows,
    the even ones with a few variables assigned and several seeds, each odd
    one a seedless duplicate of the row before it (a frozen row, or the
    padding up to a power of two); or 64 one-hot children. ``unpadded``: n
    not padded to a multiple of 8."""
    if rows == "one_hot_b64":
        return _children(csp, 64, device, kind)
    if unpadded:
        prepare = ops.prepare_packed if kind == "packed" else ops.prepare_dense
        network, _, dims = prepare(csp, 1, 1, device)
    else:
        network, dims = get_engine(f"hopper_{kind}", device=device).prepare(csp).payload
    n_p, d_p = dims[:2]
    n, d = csp.dom.shape
    b = int(rows.rsplit("_b", 1)[1])
    dom = csp.dom.expand(b, n, d).clone()
    changed = torch.ones((b, n), dtype=torch.bool, device=device)
    if rows != "root_b1":
        rng = np.random.default_rng(b)
        dom &= torch.as_tensor(rng.random((b, n, d)) < 0.8, device=device)
        assigned = torch.as_tensor(rng.random((b, n)) < 0.05, device=device)
        assigned[:, 0] = True
        dom[assigned] = False
        dom[assigned, 0] = True
        changed = assigned | torch.as_tensor(rng.random((b, n)) < 0.05, device=device)
        dom[1::2], changed[1::2] = dom[::2], False
    seed = pad_changed(changed, n, n_p, batch=(b,), device=device).to(torch.uint8)
    return (*network, _dom_rows(pad_dom(dom, n_p, d_p), kind, -(-d_p // 32)),
            seed.contiguous()), d_p


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("shape,rows", SINGLE_CASES)
def test_single_network_kernels_match_plain_on_mac_solve_rows(cuda, shape, rows, kind):
    """`packed_revise` and `dense_revise` bit for bit against their plain
    versions on the row mixes `mac_solve` launches them on."""
    family, knobs = SINGLE_SHAPES[shape]
    args, d_p = _single_rows(generate(family, seed=0, device=cuda, **knobs), rows, cuda, kind,
                             unpadded=shape == "n30_unpadded")
    mod, kw = (bs, dict(d=d_p, w=-(-d_p // 32))) if kind == "packed" else (rs, dict(d=d_p))
    kernel = getattr(mod, f"{kind}_revise")
    mod.reset_launches()
    got = kernel(*args, **kw)
    want = getattr(mod, f"{kind}_revise_plain")(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernel.launches == 1
    if rows.startswith("multi_seed"):
        assert not want[1::2].any() and want[::2].any()


#: x-block cases of the block kernels: the single-network shapes' row mixes,
#: each cut to nx = 8, n/2 and n variables
BLOCK_CASES = [(shape, rows) for shape, rows in SINGLE_CASES
               if rows in ("root_b1", "multi_seed_b4", "one_hot_b64", "multi_seed_b1024")]


def _x_block(args, d_p, kind, nx, x0):
    """A single-network case's operands cut to the rows of variables
    [x0, x0 + nx), the network rows in the pair-major block layout
    (nx, n, d_p, cols): (network rows, mask rows, domains, seeds)."""
    cons, mask, dom, seed = args
    n = mask.shape[0]
    net = cons.view(n, d_p, n, cons.shape[1] // n).permute(0, 2, 1, 3)
    return net[x0:x0 + nx].contiguous(), mask[x0:x0 + nx].contiguous(), dom, seed


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("cut", ["nx8", "half", "all"])
@pytest.mark.parametrize("shape,rows", BLOCK_CASES)
def test_block_kernels_match_plain_on_x_blocks(cuda, shape, rows, cut, kind):
    """`packed_revise_block` and `dense_revise_block` bit for bit against
    their plain versions on x-blocks of 8, n/2 and n variables, and equal to
    the same rows of the single-network kernel's output."""
    family, knobs = SINGLE_SHAPES[shape]
    args, d_p = _single_rows(generate(family, seed=0, device=cuda, **knobs), rows, cuda, kind,
                             unpadded=shape == "n30_unpadded")
    n = args[1].shape[0]
    nx = {"nx8": 8, "half": n // 2, "all": n}[cut]
    x0 = (n - nx) // 2  # a block inside the network, not at its start
    mod, kw = (bs, dict(d=d_p, w=-(-d_p // 32))) if kind == "packed" else (rs, dict(d=d_p))
    block = _x_block(args, d_p, kind, nx, x0)
    mod.reset_launches()
    got = getattr(mod, f"{kind}_revise_block")(*block, **kw)
    want = getattr(mod, f"{kind}_revise_block_plain")(*block, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    whole = getattr(mod, f"{kind}_revise")(*args, **kw)
    torch.testing.assert_close(got, whole[:, x0 * d_p:(x0 + nx) * d_p], rtol=0, atol=0)
    assert getattr(mod, f"{kind}_revise_block").launches == 1


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("shape,rows", SINGLE_CASES)
def test_block_kernels_square_call_equals_single_network_kernel(cuda, shape, rows, kind):
    """With nx = n the block form, on the network in the block layout, is
    the single-network kernel, bit for bit, on every shape and row mix that
    kernel is tested on."""
    family, knobs = SINGLE_SHAPES[shape]
    args, d_p = _single_rows(generate(family, seed=0, device=cuda, **knobs), rows, cuda, kind,
                             unpadded=shape == "n30_unpadded")
    mod, kw = (bs, dict(d=d_p, w=-(-d_p // 32))) if kind == "packed" else (rs, dict(d=d_p))
    block = _x_block(args, d_p, kind, args[1].shape[0], 0)
    torch.testing.assert_close(getattr(mod, f"{kind}_revise_block")(*block, **kw),
                               getattr(mod, f"{kind}_revise")(*args, **kw), rtol=0, atol=0)


def _production_block(nx, device, b=4, n=4096, d=32, kind="packed", seed=0):
    """Operands at the reference's production shape (n=4096, d=32) for an
    x-block of ``nx`` variables in the pair-major layout: packed (W words)
    or dense u8 (d a multiple of 8). Sparse entries (about a quarter of the
    bits set), 3 % of pairs constrained, domains with about a third of their
    values live. Rows, cycling: a root row, a row with 40 seeds, a seedless
    row, a one-hot row, a row whose seeds miss every neighbour of the
    block; and x-row 1 has an empty mask row."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((nx, n), device=device, generator=g) < 0.03).to(torch.uint8)
    mask[1] = 0
    unconstrained = torch.nonzero(mask.sum(dim=0) == 0).flatten()
    seed_rows = torch.zeros((b, n), dtype=torch.uint8, device=device)
    seed_rows[0::5] = 1
    for r in range(1, b, 5):
        seed_rows[r, torch.randperm(n, device=device, generator=g)[:40]] = 1
    seed_rows[3::5, 17] = 1
    seed_rows[4::5, unconstrained[:8]] = 1
    live = (torch.rand((b, n, d), device=device, generator=g) < 0.35)
    if kind == "packed":  # random words, a quarter of the bits set, the padding bits clear
        w = -(-d // 32)
        words = lambda: torch.randint(-2**31, 2**31, (nx, n, d, w), dtype=torch.int32,  # noqa: E731
                                      device=device, generator=g)
        cons = words() & words()
        if d % 32:
            cons[..., -1] &= (1 << d % 32) - 1
        dom = ref.pack_bits_ref(live).reshape(b, -1)
        kw = dict(d=d, w=w)
    else:
        cons = (torch.randint(0, 4, (nx, n, d, d), dtype=torch.uint8, device=device,
                              generator=g) == 0).to(torch.uint8)
        dom = live.to(torch.uint8).reshape(b, -1)
        kw = dict(d=d)
    return (cons.contiguous(), mask, dom.contiguous(), seed_rows), kw


@pytest.mark.parametrize("nx", [8, 256, 2048, 4096])
def test_packed_block_kernel_at_production_shape(cuda, nx):
    """n=4096, d=32 (the reference's production CSP; a 2 GiB packed network
    at nx = n), B=4, against the plain version."""
    args, kw = _production_block(nx, cuda)
    bs.reset_launches()
    got = bs.packed_revise_block(*args, **kw)
    want = bs.packed_revise_block_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bs.packed_revise_block.launches == 1
    assert want[0].any() and not want[2].any()


#: the single-network revises from n = 2^11, where they run the block
#: revise's row groups on the single-network layout: (kind, n, d, B) — the
#: production CSP's n=4096, d=32 (a 2 GiB packed, 16 GiB dense network; x6's
#: full batch B=512, one row, a last group of 1 row), packed W = 2 and dense
#: d/8 = 1, 2 (read at run time) at n=2048
WIDE_SINGLE_CASES = [("packed", 4096, 32, 5), ("packed", 4096, 32, 64), ("packed", 2048, 40, 33),
                     ("dense", 2048, 8, 5), ("dense", 2048, 16, 64),
                     ("packed", 4096, 32, 512), ("packed", 4096, 32, 1), ("dense", 4096, 32, 33)]


def _check_wide_single(device, kind, n, d, b):
    """`packed_revise` / `dense_revise` on their wide route (the network of
    `_production_block` at nx = n, in the single-network layout) bit for bit
    against their plain versions and against the block revise on the same
    network in the pair-major layout; the seedless rows, the rows whose
    seeds miss every neighbour and the variable with an empty mask row
    violate nothing; the launch ticks ``revise.wide``, never
    ``revise.narrow``."""
    args, kw = _production_block(n, device, b=b, n=n, d=d, kind=kind)
    single = (args[0].permute(0, 2, 1, 3).reshape(n * d, -1).contiguous(), *args[1:])
    mod = bs if kind == "packed" else rs
    mod.reset_launches()
    before = _revise_routes()
    got = getattr(mod, f"{kind}_revise")(*single, **kw)
    assert _revise_routes() == (before[0], before[1] + 1)
    want = getattr(mod, f"{kind}_revise_plain")(*single, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(getattr(mod, f"{kind}_revise_block")(*args, **kw), want,
                               rtol=0, atol=0)
    assert getattr(mod, f"{kind}_revise").launches == 1
    assert getattr(mod, f"{kind}_revise_block").launches == 1
    assert want[0].any()
    assert not want[2::5].any() and not want[4::5].any()
    assert not want.view(b, n, d)[:, 1].any()
    with pytest.raises(ValueError, match="no span"):  # the route picks its own grid
        getattr(mod, f"{kind}_revise")(*single, **kw, sched=8)


def _revise_routes():
    return obs.REGISTRY.counter("revise.narrow"), obs.REGISTRY.counter("revise.wide")


@pytest.mark.parametrize("kind,n,d,b", WIDE_SINGLE_CASES)
def test_single_network_kernels_from_n_2048(cuda, kind, n, d, b):
    """The wide route from n = 2048 (`_check_wide_single`)."""
    assert launch.single_wide(n, d)
    _check_wide_single(cuda, kind, n, d, b)


#: the single-network revises below n = 2^11 where a narrow CTA owning a row
#: would not fit in shared memory (`launch.single_wide`): (kind, n, d, B) —
#: the first such n at d = 40 past the fused CTA (1,224), QWH order 40's
#: (1,600, `mac_solve`'s one and two rows, a last group of one row) and the
#: last below 2^11 (2,040: n not a multiple of 16, so the mask read a byte at
#: a time; dense at d = 8, a 266 MB network)
WIDE_BELOW_CASES = [("packed", 1224, 40, 5), ("packed", 1600, 40, 1), ("packed", 1600, 40, 2),
                    ("packed", 1600, 40, 33), ("packed", 2040, 40, 5),
                    ("dense", 1224, 40, 5), ("dense", 1600, 40, 2), ("dense", 2040, 8, 33)]


@pytest.mark.parametrize("kind,n,d,b", WIDE_BELOW_CASES)
def test_single_network_kernels_on_the_wide_route_below_n_2048(cuda, kind, n, d, b):
    """The wide route where a narrow CTA would not fit (`_check_wide_single`),
    which the wrappers refused before it."""
    assert launch.single_wide(n, d) and n < 2048
    _check_wide_single(cuda, kind, n, d, b)


#: block-kernel edge cases at n=4096: (kind, nx, B, d) — row groups cut at
#: their edge (B = 33), one row, d = 40 (packed W = 2 as one 8-byte word,
#: dense d_p = 40 read at run time)
BLOCK_EDGE_CASES = [("packed", 256, 1, 32), ("packed", 256, 16, 32), ("packed", 256, 32, 32),
                    ("packed", 256, 33, 32), ("packed", 64, 33, 40), ("dense", 256, 33, 32),
                    ("dense", 64, 16, 40), ("dense", 8, 1, 32)]


@pytest.mark.parametrize("kind,nx,b,d", BLOCK_EDGE_CASES)
def test_block_kernels_edge_cases_at_production_width(cuda, kind, nx, b, d):
    """Both block kernels at n=4096 against their plain versions: a seedless
    row, an x-row with an empty mask row and a row whose seeds miss every
    neighbour violate nothing; B = 33 cuts a second row group to one row."""
    args, kw = _production_block(nx, cuda, b=b, d=d, kind=kind)
    mod = bs if kind == "packed" else rs
    mod.reset_launches()
    got = getattr(mod, f"{kind}_revise_block")(*args, **kw)
    want = getattr(mod, f"{kind}_revise_block_plain")(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert getattr(mod, f"{kind}_revise_block").launches == 1
    assert want[0].any()
    assert not want[2::5].any() and not want[4::5].any()
    assert not want.view(b, nx, d)[:, 1].any()


#: stacked-kernel edge cases: case -> (family, knobs); the case also picks
#: the rows' seeds and domains in `_edge_rows`
EDGE_CASES = {
    "mixed_main": FULL_WIDTH[0],
    "mixed_dense_mask": FULL_WIDTH[1],
    "all_root": FULL_WIDTH[0],
    "empty_seed": FULL_WIDTH[0],
    "every_16th_seeded": FULL_WIDTH[0],  # a late stepped sweep: most rows frozen
    "inconsistent_at_entry": FULL_WIDTH[0],
    "zero_mask": ("random_binary", dict(n=48, d=20, density=0.5)),
    "ones_mask_n160": FULL_WIDTH[1],  # every pair constrained: the densest lists
    "w3_d72": ("random_binary", dict(n=40, d=72, density=0.5, tightness=0.3)),
    "w5_d136": ("random_binary", dict(n=16, d=136, density=0.5, tightness=0.3)),
}


def _edge_rows(case, device, kind):
    """(stacked-kernel operands, d_p, W) of 128 rows for an `EDGE_CASES` case."""
    family, knobs = EDGE_CASES[case]
    csps = [generate(family, seed=i, device=device, **knobs) for i in range(4)]
    if case == "zero_mask":
        csps = [CSP(torch.zeros_like(c.cons), torch.zeros_like(c.mask), c.dom) for c in csps]
    elif case == "ones_mask_n160":  # unconstrained blocks allow all; x supports itself
        n, d = csps[0].dom.shape
        ar = torch.arange(n, device=device)
        for i, c in enumerate(csps):
            cons = torch.where(c.mask[:, :, None, None], c.cons, True)
            cons[ar, ar] = torch.eye(d, dtype=torch.bool, device=device)
            csps[i] = CSP(cons, torch.ones_like(c.mask), c.dom)
    (cons, mask, idx, dom, seed), d_p, w = _rows(csps, 128, device, kind)
    n_p = seed.shape[1]
    if case == "all_root":
        seed = ops._padded_seed(torch.full((128,), -1, device=device), csps[0].dom.shape[0],
                                n_p).to(torch.uint8)
    elif case == "empty_seed":
        seed = torch.zeros_like(seed)
    elif case == "every_16th_seeded":
        seed = seed.clone()
        seed[torch.arange(128, device=device) % 16 != 0] = 0
    elif case == "inconsistent_at_entry":
        dom = dom.clone()
        dom.view(128, n_p, -1)[::2, 3] = 0
    return (cons, mask, idx, dom.contiguous(), seed.contiguous()), d_p, w


#: `test_fused_kernels_match_plain_on_edge_cases`' cases: every case of
#: both kinds' fixpoints and revises, then the packed fixpoint with each row
#: split over a cluster of 4 CTAs (``split4``)
EDGE_PARAMS = [pytest.param(case, kind, fn, None, id=f"{case}-{kind}-{fn}")
               for fn in ("fixpoint", "revise") for kind in ("packed", "dense")
               for case in EDGE_CASES] + [
    pytest.param(case, "packed", "fixpoint", 4, id=f"{case}-packed-fixpoint-split4")
    for case in EDGE_CASES]


@pytest.mark.parametrize("case,kind,fn,split", EDGE_PARAMS)
def test_fused_kernels_match_plain_on_edge_cases(cuda, case, kind, fn, split):
    """Both fused fixpoints (domain, consistency, k) and both stacked
    revises (violations) bit for bit against their plain versions; the
    packed fixpoint also with each row split over a cluster of 4 CTAs."""
    args, d_p, w = _edge_rows(case, cuda, kind)
    mod, kw = (bs, dict(d=d_p, w=w)) if kind == "packed" else (rs, dict(d=d_p))
    kernel = getattr(mod, f"{kind}_{fn}_stacked")
    mod.reset_launches()
    got = kernel(*args, **kw) if split is None else kernel(*args, **kw, split=split)
    want = getattr(mod, f"{kind}_{fn}_stacked_plain")(*args, **kw)
    if fn == "revise":
        got, want = (got,), (want,)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    assert kernel.launches == 1
    if fn == "revise" and case in ("empty_seed", "zero_mask"):
        assert not want[0].any()
    elif fn == "fixpoint" and case == "empty_seed":
        assert not want[2].any()
    elif fn == "fixpoint" and case == "inconsistent_at_entry":
        assert not want[1][::2].any() and not want[2][::2].any()


def test_cuda_wrapper_raises_on_a_layout_it_cannot_hold(cuda):
    n, d, w = 4096, 8, 1  # the fused fixpoint's mask bits alone take 2 MB of shared memory
    cons = torch.zeros((1, n * d, n * w), dtype=torch.int32, device=cuda)
    args = (cons, torch.zeros((1, n, n), dtype=torch.uint8, device=cuda),
            torch.zeros((1,), dtype=torch.int32, device=cuda),
            torch.zeros((1, n * w), dtype=torch.int32, device=cuda),
            torch.zeros((1, n), dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        bs.packed_fixpoint_stacked(*args, d=d, w=w)


def _dense_operands(n, d, device):
    """(cons, mask, idx, dom, seed) of one dense row at (n, d); cons is left
    uninitialised (the wrappers refuse the layout before any launch)."""
    return (torch.empty((1, n * d, n * d), dtype=torch.uint8, device=device),
            torch.ones((1, n, n), dtype=torch.uint8, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
            torch.ones((1, n * d), dtype=torch.uint8, device=device),
            torch.ones((1, n), dtype=torch.uint8, device=device))


def test_dense_wrappers_raise_on_a_layout_they_cannot_hold(cuda):
    # n=1, d=24584: > 227 KB for the fixpoint's lists; both revises hold it
    # (49,272 B stacked, 24,720 B single-network); the stacked revise refuses
    # n=4096, d=8 (2,266,112 B: launch.revise_smem). The single-network one
    # at n=2040, d=8, where a narrow CTA owning a whole row would need
    # 1,635,328 B (single_revise_smem), takes the wide route instead
    # (launch.single_wide) and agrees with its plain version
    cons, mask, idx, dom, seed = _dense_operands(1, 24584, cuda)
    big = _dense_operands(4096, 8, cuda)
    rs.reset_launches()
    for call in (lambda: rs.dense_fixpoint_stacked(cons, mask, idx, dom, seed, d=24584),
                 lambda: rs.dense_revise_stacked(*big, d=8)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
    assert (rs.dense_fixpoint_stacked.launches, rs.dense_revise_stacked.launches,
            rs.dense_revise.launches) == (0, 0, 0)
    single, _ = _production_block(2040, cuda, b=1, n=2040, d=8, kind="dense")
    single = (single[0].permute(0, 2, 1, 3).reshape(2040 * 8, -1).contiguous(), *single[1:])
    got = rs.dense_revise(*single, d=8)
    torch.testing.assert_close(got, rs.dense_revise_plain(*single, d=8), rtol=0, atol=0)
    assert rs.dense_revise.launches == 1 and got.any()


@pytest.mark.parametrize("name", ["hopper_packed", "hopper_dense"])
def test_solve_many_fused_equals_stepped_on_card(cuda, name):
    csps = [generate("model_rb", seed=i, device=cuda, n=24, hardness=0.9) for i in range(8)]
    runs = []
    for fixpoint in ("fused", "stepped"):
        tel = {}
        sols, stats = solve_many(csps, engine=get_engine(name, fixpoint=fixpoint, device=cuda),
                                 max_assignments=500, telemetry=tel)
        runs.append((sols, [(s.n_assignments, s.n_backtracks, s.recurrences, s.rounds)
                            for s in stats], tel))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert runs[0][2]["launches"] == runs[0][2]["rounds"]
    for csp, sol in zip(csps, runs[0][0]):
        if sol is not None:
            assert check_solution(csp, sol)


def _mac_key(run):
    sol, st = run
    return (sol, st.n_assignments, st.n_backtracks, st.recurrences, st.rounds, st.rows,
            st.exhausted)


def test_mac_solve_on_hopper_engines_equals_einsum_on_card(cuda):
    """Both Hopper engines on both routes of the single-network path (the
    fused kernel, the stepped host loop over the single-network revise)
    equal `einsum`."""
    csps = [generate("model_rb", seed=i, device=cuda, n=30, hardness=0.9) for i in range(2)]
    engines = [get_engine("einsum", device=cuda)] + [
        get_engine(name, fixpoint=fixpoint, device=cuda)
        for name in ("hopper_packed", "hopper_dense") for fixpoint in ("fused", "stepped")]
    bs.reset_launches()
    rs.reset_launches()
    for csp in csps:
        runs = [mac_solve(csp, engine=eng, max_assignments=300) for eng in engines]
        assert all(_mac_key(run) == _mac_key(runs[0]) for run in runs[1:])
        if runs[0][0] is not None:
            assert check_solution(csp, runs[0][0])
    assert bs.packed_revise.launches > 0 and rs.dense_revise.launches > 0
    assert bs.packed_fixpoint_stacked.launches > 0 and rs.dense_fixpoint_stacked.launches > 0


def test_mac_solve_at_qwh_order_40_equals_the_plain_search_on_card(cuda):
    """`mac_solve` on a quasigroup with holes of order 40 (n = 1,600,
    d = 40, 672 holes; the benchmark's generator, fewer chain moves) on the
    fused `hopper_packed` engine: the fused CTA does not fit, so every round
    runs the word loop over kernel 3's wide launch (the epilogue kernel once
    a launch): the recurrences billed, and past a call's fixpoint at most
    the rest of its last chunk, and the solve equals the benchmark's plain
    MAC search exactly over 200 assignments."""
    from rtacbench.lib import qwh as lib_qwh
    from rtacbench.lib import searches
    from rtacbench.reference import mac, qwh

    dr = qwh.qwh_draws(5, 40, 672, moves=1600)
    csp = CSP(*lib_qwh.on_device(dr, cuda))
    names = ("fixpoint.one_launch", "fixpoint.host_loop", "fixpoint.word_loop",
             "revise.narrow", "revise.wide", "fixpoint.spec_recurrences")
    before = [obs.REGISTRY.counter(k) for k in names]
    bs.reset_launches()
    sol, st = mac_solve(csp, engine=get_engine("hopper_packed", device=cuda),
                        max_assignments=200)
    one, loop, word, narrow, wide, spec = (obs.REGISTRY.counter(k) - v
                                           for k, v in zip(names, before))
    assert (one, loop, narrow) == (0, 0, 0) and word == st.rounds
    assert wide - spec == st.launches
    assert 0 <= spec <= st.rounds * (ops.WORD_CHUNK - 1)
    assert bs.packed_revise.launches == bs.packed_word_epilogue.launches == wide
    assert bs.packed_fixpoint_stacked.launches == 0
    want = mac.solve(lib_qwh.network(dr), torch.as_tensor(qwh.root(dr)), 200)
    assert searches.record(sol, st) == want.key()
    assert st.exhausted


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_mac_solve_fused_launches_once_a_round_on_card(cuda, kind):
    """`mac_solve` at frb100-40 sizes (n_p=104, d_p=40) on the fused engine
    launches the fused fixpoint kernel (1 or 4) exactly once a round and the
    single-network revise (3 or 6) never; the stepped engine launches the
    revise once a billed recurrence and the fused kernel never; both equal
    `einsum`."""
    family, knobs = FULL_WIDTH[0]
    csp = generate(family, seed=1, device=cuda, **knobs)
    mod = bs if kind == "packed" else rs
    want = _mac_key(mac_solve(csp, engine=get_engine("einsum", device=cuda),
                              max_assignments=300))
    for fixpoint in ("fused", "stepped"):
        mod.reset_launches()
        run = mac_solve(csp, engine=get_engine(f"hopper_{kind}", fixpoint=fixpoint, device=cuda),
                        max_assignments=300)
        assert _mac_key(run) == want
        fused_n = getattr(mod, f"{kind}_fixpoint_stacked").launches
        revise_n = getattr(mod, f"{kind}_revise").launches
        if fixpoint == "fused":
            assert (fused_n, revise_n) == (run[1].rounds, 0)
        else:
            assert (fused_n, revise_n) == (0, run[1].launches)


#: the service's bucket shapes on the main path: frb100-40 → (128, 64),
#: sudoku → (128, 16), 64-queens → (64, 64)
BUCKET_CASES = [
    ("model_rb", dict(n=100, alpha=0.8, r=0.7, hardness=0.9)),
    ("sudoku", dict(givens=32)),
    ("nqueens", dict(n=64)),
]


def _pool_rows(csps, n_rows, seed=0):
    """Rows as a service round gives them, in bucket coordinates: a root
    domain with one assignment applied (one-hot seed) for 7 rows in 8, an
    all-changed root row for the rest, each routed to a random slot."""
    rng = np.random.default_rng(seed)
    n, d = csps[0].dom.shape
    idx = rng.integers(0, len(csps), n_rows)
    doms = np.stack([c.dom.cpu().numpy() for c in csps])[idx]
    changed = np.ones((n_rows, n), dtype=bool)
    for i in range(n_rows):
        if rng.random() >= 0.125:
            var = int(rng.integers(0, n))
            vals = np.nonzero(doms[i, var])[0]
            doms[i, var] = False
            doms[i, var, vals[int(rng.integers(0, len(vals)))]] = True
            changed[i] = False
            changed[i, var] = True
    return doms, changed, idx


@pytest.mark.parametrize("fixpoint", ["fused", "stepped"])
@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("family,knobs", BUCKET_CASES)
def test_slot_table_at_bucket_shapes_matches_plain(cuda, family, knobs, kind, fixpoint):
    """A slot pool on the card, at a bucket shape the kernels meet only in the
    service, equals the same pool on the CPU (the plain versions), and a
    round launches only its path's kernel."""
    csps = [generate(family, seed=i, device="cpu", **knobs) for i in range(3)]
    bucket = bucket_for(*csps[0].dom.shape)
    padded = [pad_csp(c, bucket) for c in csps]
    doms, changed, idx = _pool_rows(padded, 16)
    results = []
    for device in ("cpu", cuda):
        pool = get_engine(f"hopper_{kind}", fixpoint=fixpoint, device=device).open_slot_pool(
            bucket.n_p, bucket.d_p, 4)
        for slot, c in zip((0, 2, 3), padded):
            pool.install(slot, c)
        bs.reset_launches()
        rs.reset_launches()
        res = pool.enforce_rows(doms, changed, np.array((0, 2, 3))[idx])
        results.append(tuple(t.cpu() for t in res))
        if device is cuda:
            mod = bs if kind == "packed" else rs
            fused = getattr(mod, f"{kind}_fixpoint_stacked").launches
            stepped = getattr(mod, f"{kind}_revise_stacked").launches
            assert (fused, stepped > 0) == ((1, False) if fixpoint == "fused" else (0, True))
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["hopper_packed", "hopper_dense"])
def test_service_on_card_grows_its_table_between_rounds(cuda, name):
    """One slot to start, requests arriving mid-flight: the table grows
    between rounds and every request equals the same service on the CPU,
    with no host routing and the fused kernel on every round."""
    csps = [generate("model_rb", seed=i, device="cpu", n=24, hardness=0.9) for i in range(5)]
    out = []
    for device in ("cpu", cuda):
        svc = SolverService(engine=name, device=device, initial_slots=1)
        bs.reset_launches()
        rs.reset_launches()
        reqs = [svc.submit(csps[0])]
        svc.step()
        reqs += [svc.submit(c) for c in csps[1:3]]
        svc.step()
        reqs += [svc.submit(c) for c in csps[3:]]
        svc.run_until_idle()
        snap = svc.snapshot()
        (info,) = snap["buckets"].values()
        assert info["capacity"] >= 4 and info["device_frontier"]
        out.append([(r.solution, r.stats.n_assignments, r.stats.n_backtracks,
                     r.stats.recurrences, r.stats.exhausted) for r in reqs])
        if device is cuda:
            launched = (bs.packed_fixpoint_stacked.launches if name == "hopper_packed"
                        else rs.dense_fixpoint_stacked.launches)
            assert launched == snap["rounds"] > 0
    assert out[0] == out[1]
    for csp, (sol, *_rest) in zip(csps, out[1]):
        if sol is not None:
            assert check_solution(csp, sol)


def test_two_nccl_ranks_equal_one_rank(cuda, tmp_path):
    """`distributed_ac --network hashed` at n=256, d=32, B=8 on the (1,2)
    mesh: two NCCL ranks, one card each (a FileStore, ``--device cuda:R``),
    equal the one-rank run of the same command on every rank
    (``--against``), launch the block kernel, and stage nothing through
    host memory. Needs two cards: NCCL refuses two ranks on one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL refuses two ranks on one card)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.distributed_ac", "--network", "hashed",
           "--n-vars", "256", "--dom-size", "32", "--density", "0.16", "--tightness", "0.6",
           "--batch", "8", "--impl", "bitpacked", "--check", "plain"]
    one = subprocess.run([*cmd, "--device", "cuda", "--mesh", "1,1", "--check",
                          "hopper_packed", "--out", str(tmp_path / "one.npz")],
                         capture_output=True, text=True, env=env, timeout=600)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    procs = [subprocess.Popen(
        [*cmd, "--device", f"cuda:{r}", "--mesh", "1,2", "--against", str(tmp_path / "one.npz"),
         "--out", str(tmp_path / "two.npz"), "--store", str(tmp_path / "store"), "--rank",
         str(r), "--world", "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    assert "on 2 nccl ranks (cuda)" in logs[0]
    assert "staged through host memory: {'data': False, 'model': False}" in logs[0]
    assert logs[0].count("first block call bit-identical to plain") == 2
    got, want = np.load(tmp_path / "two.npz"), np.load(tmp_path / "one.npz")
    for name in ("dom", "consistent", "k"):
        np.testing.assert_array_equal(got[name], want[name])
    assert not got["staged"] and int(got["packed_revise_block"]) == int(got["k"].max())
    assert all(g == 2 for _b, g in got["gathers"][:int(got["k"].max())])
