"""The port's kernels (plain versions on the CPU) against the reference.

- `ops.prepare_packed` and `ops.prepare_dense` tables equal the reference's
  byte for byte (the port's int32 words viewed as uint32);
- the plain `packed_revise_stacked`, `dense_revise_stacked`, `packed_revise`
  and `dense_revise` equal the reference Pallas kernels in interpret mode,
  row by row (the single-network ones also on `mac_solve`'s rows: several
  seeds a row, seedless duplicates);
- the plain `packed_fixpoint_stacked` and `dense_fixpoint_stacked` equal the
  reference *stepped* chain (`rtac.enforce_rows_generic` over the
  reference's `ops._packed_rows_fn` / `_dense_rows_fn`; the port's own over
  `ops.revise_rows`) on domains, verdicts and per-row
  recurrence counts. The reference fused kernels are not the oracle: they
  fail under jax 0.9.0, and DESIGN.md §4 defines them as bit-identical to
  stepped.

All comparisons are exact: the arithmetic is boolean and integer.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import rtac as ref_rtac
from repro.core.csp import make_csp as ref_make_csp
from repro.core.engine import pad_changed as ref_pad_changed, pad_dom as ref_pad_dom
from repro.kernels import bitpack_support as ref_bs, ops as ref_ops, ref as ref_ref
from repro.kernels import rtac_support as ref_rs
from repro.problems import generate as ref_generate

from repro_torch.core.csp import csp_from_numpy
from repro_torch.core.engine import pad_changed, pad_dom
from repro_torch.kernels import bitpack_support as bs, launch, ops, ref, rtac_support as rs
from repro_torch.problems import generate

CPU = torch.device("cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


SHAPE_SWEEP = [
    # (n_vars, dom_size, block_rx, block_ry) — tests/test_kernels.py's sweep
    (4, 3, 4, 4),
    (8, 5, 8, 8),
    (10, 6, 8, 8),
    (16, 8, 8, 8),
    (16, 8, 4, 8),
    (16, 8, 8, 4),
    (24, 33, 8, 8),  # d > 32: multi-word bitpack
    (12, 64, 4, 4),
]


def _pair(n, d, seed):
    knobs = dict(n=n, d=d, density=0.6, tightness=0.4)
    return ref_generate("random_binary", seed=seed, **knobs), generate(
        "random_binary", seed=seed, device=CPU, **knobs)


@pytest.mark.parametrize("n,d,brx,bry", SHAPE_SWEEP)
def test_prepare_packed_tables_match_reference(n, d, brx, bry):
    ref_csp, csp = _pair(n, d, n * 100 + d)
    (rcons, rmask), rdom, rdims = ref_ops.prepare_packed(ref_csp, brx, bry)
    (cons, mask), dom, dims = ops.prepare_packed(csp, brx, bry)
    assert dims == rdims
    assert cons.dtype == torch.int32 and mask.dtype == torch.uint8
    assert _u32(cons).tobytes() == np.asarray(rcons).tobytes()
    assert mask.numpy().tobytes() == np.asarray(rmask).tobytes()
    np.testing.assert_array_equal(dom.numpy(), np.asarray(rdom))
    # memoized per CSP: a second prepare returns the same tensors
    assert ops.prepare_packed(csp, brx, bry)[0][0] is cons


@pytest.mark.parametrize("n,d,brx,bry", SHAPE_SWEEP)
def test_prepare_dense_tables_match_reference(n, d, brx, bry):
    ref_csp, csp = _pair(n, d, n * 100 + d)
    (rcons, rmask), rdom, rdims = ref_ops.prepare_dense(ref_csp, brx, bry)
    (cons, mask), dom, dims = ops.prepare_dense(csp, brx, bry)
    assert dims == rdims
    assert cons.dtype == torch.uint8 and mask.dtype == torch.uint8
    assert cons.numpy().tobytes() == np.asarray(rcons).tobytes()
    assert mask.numpy().tobytes() == np.asarray(rmask).tobytes()
    np.testing.assert_array_equal(dom.numpy(), np.asarray(rdom))
    assert ops.prepare_dense(csp, brx, bry)[0][0] is cons


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_network_prepared_in_chunks_equals_one_pass(kind, monkeypatch):
    """`ops.pack_network` and `ops.dense_network` move the padded network
    in chunks of x-rows (`ops._PACK_CHUNK` elements), so that the
    production CSP's 16 GiB network prepares on one card: chunks of 3
    x-rows, the last one short, give the network one pass gives."""
    _, csp = _pair(13, 8, 7)  # n_p = 16, padded variables included
    prepare = getattr(ops, f"prepare_{kind}")
    (whole, mask), _, dims = prepare(csp, memo=False)
    n_p, d_p = dims[:2]
    assert ops._PACK_CHUNK // (n_p * d_p * d_p) >= n_p  # one pass
    monkeypatch.setattr(ops, "_PACK_CHUNK", 3 * n_p * d_p * d_p)
    (chunked, chunked_mask), _, chunked_dims = prepare(csp, memo=False)
    assert chunked_dims == dims
    assert torch.equal(chunked, whole) and torch.equal(chunked_mask, mask)


@pytest.mark.parametrize("shape", [(5, 70), (3, 4, 32), (2, 31), (7, 1)])
def test_pack_bits_matches_reference(shape):
    bits = np.random.default_rng(sum(shape)).random(shape) < 0.5
    words = ref.pack_bits_ref(torch.as_tensor(bits))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(_u32(words), np.asarray(ref_ref.pack_bits_ref(jnp.asarray(bits))))
    np.testing.assert_array_equal(ref.unpack_bits_ref(words, shape[-1]).numpy(), bits)


def test_revise_oracles_match_reference():
    ref_csp, csp = _pair(9, 37, 11)
    ch = np.random.default_rng(0).random(9) < 0.6
    want = np.asarray(ref_ref.revise_ref(ref_csp.cons, ref_csp.mask, ref_csp.dom, jnp.asarray(ch)))
    got = ref.revise_ref(csp.cons, csp.mask, csp.dom, torch.as_tensor(ch))
    np.testing.assert_array_equal(got.numpy(), want)
    packed = ref.revise_packed_ref(ref.pack_bits_ref(csp.cons), csp.mask,
                                   ref.pack_bits_ref(csp.dom), torch.as_tensor(ch))
    np.testing.assert_array_equal(packed.numpy(), want)


STACK_SWEEP = [
    (8, 5, 8, 8),
    (16, 8, 8, 8),
    (16, 8, 4, 8),
    (24, 33, 8, 8),  # d > 32: multi-word bitpack
]


#: the fused fixpoints' edge cases: (n, d, brx, bry, case); ``case`` as in
#: `_stacked_fixture`. The ids of the mixed cases are those of STACK_SWEEP.
FIXPOINT_CASES = [pytest.param(*s, "mixed", id="-".join(map(str, s))) for s in STACK_SWEEP] + [
    pytest.param(16, 8, 8, 8, "root", id="all_root"),
    pytest.param(16, 8, 8, 8, "empty_seed", id="empty_seed"),
    pytest.param(16, 8, 8, 8, "wiped", id="inconsistent_at_entry"),
    pytest.param(16, 8, 8, 8, "zero_mask", id="zero_mask"),
    pytest.param(160, 10, 8, 8, "ones_mask", id="ones_mask_n160"),
    pytest.param(20, 72, 8, 8, "mixed", id="w3_d72"),
]


def _masked_pair(n, d, seed, case):
    """`_pair`'s CSPs, with the mask ``case`` names: "zero_mask" (no
    constraint), "ones_mask" (every pair constrained, the diagonal too: the
    unconstrained blocks allow every value pair and each variable supports
    itself value for value); any other case keeps the generated mask."""
    ref_csp, csp = _pair(n, d, seed)
    if case not in ("zero_mask", "ones_mask"):
        return ref_csp, csp
    cons, mask, dom = (np.asarray(a) for a in ref_csp)
    if case == "zero_mask":
        cons, mask = np.zeros_like(cons), np.zeros_like(mask)
    else:
        cons = np.where(mask[:, :, None, None], cons, True)
        cons[np.arange(n), np.arange(n)] = np.eye(d, dtype=bool)
        mask = np.ones_like(mask)
    return ref_make_csp(cons, mask, dom), csp_from_numpy(cons, mask, dom, CPU)


def _stacked_fixture(n, d, brx, bry, kind="packed", case="mixed"):
    """3 networks, 5 rows via idx [2,0,1,2,0], mixed seeds, one row near
    wipeout — the same inputs in both packages' kernel coordinates.
    ``kind`` picks the packed or the dense network layout. ``case`` other
    than "mixed": every row all-changed ("root"), no row seeded
    ("empty_seed"), rows 1 and 3 with an empty domain at entry ("wiped"), or
    the mask of `_masked_pair`."""
    pairs = [_masked_pair(n, d, 300 + i, case) for i in range(3)]
    ref_prepare = ref_ops.prepare_packed if kind == "packed" else ref_ops.prepare_dense
    prepare = ops.prepare_packed if kind == "packed" else ops.prepare_dense
    ref_nets = [ref_prepare(p[0], brx, bry)[0] for p in pairs]
    nets = [prepare(p[1], brx, bry) for p in pairs]
    n_p, d_p = nets[0][2][:2]
    w = -(-d_p // 32)
    ref_tables = (jnp.stack([t[0] for t in ref_nets]), jnp.stack([t[1] for t in ref_nets]))
    tables = (torch.stack([t[0][0] for t in nets]), torch.stack([t[0][1] for t in nets]))
    idx = np.array([2, 0, 1, 2, 0], np.int32)
    rng = np.random.default_rng(n * 7 + d)
    doms = np.stack([np.asarray(pairs[j][0].dom) for j in idx])
    doms &= rng.random(doms.shape) < 0.85
    doms[:, :, 0] = True
    doms[4, 1, 1:] = False  # a row that starts near wipeout
    changed = rng.random((len(idx), n)) < 0.5
    changed[0] = True  # one all-changed row (the root-propagation shape)
    if case == "root":
        changed[:] = True
    elif case == "empty_seed":
        changed[:] = False
    elif case == "wiped":
        doms[1::2, 2] = False
    ref_in = (ref_pad_dom(jnp.asarray(doms), n_p, d_p),
              ref_pad_changed(jnp.asarray(changed), n, n_p, batch=(len(idx),)))
    port_in = (pad_dom(torch.as_tensor(doms), n_p, d_p),
               pad_changed(changed, n, n_p, batch=(len(idx),)))
    return ref_tables, tables, idx, ref_in, port_in, (n_p, d_p, w)


@pytest.mark.parametrize("n,d,brx,bry", STACK_SWEEP)
def test_plain_revise_stacked_matches_reference_kernel(n, d, brx, bry):
    ref_tables, tables, idx, (rdom, rch), (dom, ch), (n_p, d_p, w) = _stacked_fixture(
        n, d, brx, bry)
    r = len(idx)
    want = ref_bs.packed_revise_stacked(
        ref_tables[0][idx], ref_ref.pack_bits_ref(rdom).reshape(r, 1, n_p * w),
        rch.astype(jnp.uint8).reshape(r, 1, n_p), ref_tables[1][idx],
        d=d_p, w=w, block_rx=brx, block_ry=bry, interpret=True,
    )
    got = bs.packed_revise_stacked(
        tables[0], tables[1], torch.as_tensor(idx), ref.pack_bits_ref(dom).reshape(r, n_p * w),
        ch.to(torch.uint8), d=d_p, w=w,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(r, n_p * d_p))


def _check_case(case, ok, k):
    """What an edge case fixes on its own, beside the reference's answer."""
    if case == "empty_seed":
        assert not k.any()
    elif case == "wiped":
        assert not ok[1::2].any() and not k[1::2].any()
    elif case == "zero_mask":  # every seeded row sweeps once and removes nothing
        assert (k == ok).all()


@pytest.mark.parametrize("n,d,brx,bry,case", FIXPOINT_CASES)
def test_plain_fixpoint_matches_reference_stepped_chain(n, d, brx, bry, case):
    ref_tables, tables, idx, (rdom, rch), (dom, ch), (n_p, d_p, w) = _stacked_fixture(
        n, d, brx, bry, case=case)
    want = ref_rtac.enforce_rows_generic(
        ref_tables, rdom, rch, jnp.asarray(idx),
        revise_rows_fn=ref_ops._packed_rows_fn(n_p, d_p, w, brx, bry, True),
    )
    r = len(idx)
    got_dom, got_ok, got_k = bs.packed_fixpoint_stacked(
        tables[0], tables[1], torch.as_tensor(idx), ref.pack_bits_ref(dom).reshape(r, n_p * w),
        ch.to(torch.uint8), d=d_p, w=w,
    )
    np.testing.assert_array_equal(got_ok.numpy().astype(bool), np.asarray(want.consistent))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want.n_recurrences))
    np.testing.assert_array_equal(got_dom.numpy().reshape(r, n_p, d_p).astype(bool),
                                  np.asarray(want.dom))
    _check_case(case, got_ok.numpy(), got_k.numpy())
    # the port's own stepped chain (revise rows fn under enforce_rows_generic)
    from repro_torch.core import rtac

    rows = functools.partial(ops.revise_rows, "packed", (n_p, d_p, w))
    stepped = rtac.enforce_rows_generic(tables, dom, ch, torch.as_tensor(idx),
                                        revise_rows_fn=rows)
    np.testing.assert_array_equal(stepped.n_recurrences.numpy(), got_k.numpy())
    np.testing.assert_array_equal(stepped.dom.numpy(), np.asarray(want.dom))


@pytest.mark.parametrize("n,d,brx,bry", STACK_SWEEP)
def test_plain_dense_revise_stacked_matches_reference_kernel(n, d, brx, bry):
    ref_tables, tables, idx, (rdom, rch), (dom, ch), (n_p, d_p, _) = _stacked_fixture(
        n, d, brx, bry, "dense")
    r = len(idx)
    want = ref_rs.dense_revise_stacked(
        ref_tables[0][idx], rdom.astype(jnp.uint8).reshape(r, 1, n_p * d_p),
        rch.astype(jnp.uint8).reshape(r, 1, n_p), ref_tables[1][idx],
        d=d_p, block_rx=brx, block_ry=bry, interpret=True,
    )
    got = rs.dense_revise_stacked(tables[0], tables[1], torch.as_tensor(idx),
                                  dom.to(torch.uint8).reshape(r, n_p * d_p), ch.to(torch.uint8),
                                  d=d_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(r, n_p * d_p))


@pytest.mark.parametrize("n,d,brx,bry,case", FIXPOINT_CASES)
def test_plain_dense_fixpoint_matches_reference_stepped_chain(n, d, brx, bry, case):
    ref_tables, tables, idx, (rdom, rch), (dom, ch), (n_p, d_p, _) = _stacked_fixture(
        n, d, brx, bry, "dense", case)
    want = ref_rtac.enforce_rows_generic(
        ref_tables, rdom, rch, jnp.asarray(idx),
        revise_rows_fn=ref_ops._dense_rows_fn(n_p, d_p, brx, bry, True),
    )
    r = len(idx)
    got_dom, got_ok, got_k = rs.dense_fixpoint_stacked(
        tables[0], tables[1], torch.as_tensor(idx), dom.to(torch.uint8).reshape(r, n_p * d_p),
        ch.to(torch.uint8), d=d_p,
    )
    np.testing.assert_array_equal(got_ok.numpy().astype(bool), np.asarray(want.consistent))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want.n_recurrences))
    np.testing.assert_array_equal(got_dom.numpy().reshape(r, n_p, d_p).astype(bool),
                                  np.asarray(want.dom))
    _check_case(case, got_ok.numpy(), got_k.numpy())
    from repro_torch.core import rtac

    rows = functools.partial(ops.revise_rows, "dense", (n_p, d_p))
    stepped = rtac.enforce_rows_generic(tables, dom, ch, torch.as_tensor(idx),
                                        revise_rows_fn=rows)
    np.testing.assert_array_equal(stepped.n_recurrences.numpy(), got_k.numpy())
    np.testing.assert_array_equal(stepped.dom.numpy(), np.asarray(want.dom))


@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("n,d,brx,bry", STACK_SWEEP)
def test_plain_single_network_revise_matches_reference_kernel(kind, n, d, brx, bry):
    """`packed_revise` / `dense_revise`: 5 domains against ONE network, each
    row equal to the reference single-network kernel on that row."""
    ref_tables, tables, idx, (rdom, rch), (dom, ch), (n_p, d_p, w) = _stacked_fixture(
        n, d, brx, bry, kind)
    r = len(idx)
    ref_net = (ref_tables[0][1], ref_tables[1][1])
    net = (tables[0][1], tables[1][1])
    ch_u8 = ch.to(torch.uint8)
    if kind == "packed":
        got = bs.packed_revise(*net, ref.pack_bits_ref(dom).reshape(r, n_p * w), ch_u8,
                               d=d_p, w=w)
        ref_doms = ref_ref.pack_bits_ref(rdom).reshape(r, 1, n_p * w)
        call = lambda i: ref_bs.packed_revise(  # noqa: E731
            ref_net[0], ref_doms[i], rch[i].astype(jnp.uint8).reshape(1, n_p), ref_net[1],
            d=d_p, w=w, block_rx=brx, block_ry=bry, interpret=True)
    else:
        got = rs.dense_revise(*net, dom.to(torch.uint8).reshape(r, n_p * d_p), ch_u8, d=d_p)
        call = lambda i: ref_rs.dense_revise(  # noqa: E731
            ref_net[0], rdom[i].astype(jnp.uint8).reshape(1, n_p * d_p),
            rch[i].astype(jnp.uint8).reshape(1, n_p), ref_net[1],
            d=d_p, block_rx=brx, block_ry=bry, interpret=True)
    want = np.concatenate([np.asarray(call(i)) for i in range(r)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("kind", ["packed", "dense"])
@pytest.mark.parametrize("n,d,brx,bry", STACK_SWEEP)
def test_plain_single_network_revise_on_mac_solve_rows(kind, n, d, brx, bry, b):
    """`packed_revise` / `dense_revise` on the rows `mac_solve` gives them:
    B = 2 or 4 children of one network, the even rows with a few variables
    assigned and several seeds, each odd row a seedless duplicate of the row
    before it (a frozen row, or the padding up to a power of two). Each row
    equals the reference single-network kernel on that row; the seedless
    rows violate nothing."""
    ref_csp, csp = _pair(n, d, n * 31 + d)
    ref_prepare = ref_ops.prepare_packed if kind == "packed" else ref_ops.prepare_dense
    prepare = ops.prepare_packed if kind == "packed" else ops.prepare_dense
    ref_net = ref_prepare(ref_csp, brx, bry)[0]
    net, _, dims = prepare(csp, brx, bry)
    n_p, d_p = dims[:2]
    w = -(-d_p // 32)
    rng = np.random.default_rng(n * 13 + d + b)
    doms = np.asarray(ref_csp.dom)[None] & (rng.random((b, n, d)) < 0.8)
    assigned = rng.random((b, n)) < 0.15
    assigned[:, 0] = True
    doms[assigned] = False
    doms[assigned, 0] = True
    changed = assigned | (rng.random((b, n)) < 0.2)
    doms[1::2], changed[1::2] = doms[::2], False
    rdom = ref_pad_dom(jnp.asarray(doms), n_p, d_p)
    rch = ref_pad_changed(jnp.asarray(changed), n, n_p, batch=(b,))
    dom = pad_dom(torch.as_tensor(doms), n_p, d_p)
    ch_u8 = pad_changed(changed, n, n_p, batch=(b,)).to(torch.uint8)
    if kind == "packed":
        got = bs.packed_revise_plain(*net, ref.pack_bits_ref(dom).reshape(b, n_p * w), ch_u8,
                                     d=d_p, w=w)
        ref_doms = ref_ref.pack_bits_ref(rdom).reshape(b, 1, n_p * w)
        call = lambda i: ref_bs.packed_revise(  # noqa: E731
            ref_net[0], ref_doms[i], rch[i].astype(jnp.uint8).reshape(1, n_p), ref_net[1],
            d=d_p, w=w, block_rx=brx, block_ry=bry, interpret=True)
    else:
        got = rs.dense_revise_plain(*net, dom.to(torch.uint8).reshape(b, n_p * d_p), ch_u8,
                                    d=d_p)
        call = lambda i: ref_rs.dense_revise(  # noqa: E731
            ref_net[0], rdom[i].astype(jnp.uint8).reshape(1, n_p * d_p),
            rch[i].astype(jnp.uint8).reshape(1, n_p), ref_net[1],
            d=d_p, block_rx=brx, block_ry=bry, interpret=True)
    want = np.concatenate([np.asarray(call(i)) for i in range(b)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[::2].any() and not want[1::2].any()
    assert changed[::2].sum(axis=1).min() >= 2


def _wrapper_args(kind):
    """(wrappers, args, kw) of every kernel wrapper of ``kind`` on one
    stacked fixture: stacked operands and the single-network ones."""
    _, tables, idx, _, (dom, ch), (n_p, d_p, w) = _stacked_fixture(8, 5, 8, 8, kind)
    r = len(idx)
    if kind == "packed":
        rows = ref.pack_bits_ref(dom).reshape(r, n_p * w)
        mod, kw = bs, dict(d=d_p, w=w)
    else:
        rows = dom.to(torch.uint8).reshape(r, n_p * d_p)
        mod, kw = rs, dict(d=d_p)
    stacked = (tables[0], tables[1], torch.as_tensor(idx), rows, ch.to(torch.uint8))
    single = (tables[0][0], tables[1][0], rows, ch.to(torch.uint8))
    wrappers = [(getattr(mod, f"{kind}_revise_stacked"), stacked),
                (getattr(mod, f"{kind}_fixpoint_stacked"), stacked),
                (getattr(mod, f"{kind}_revise"), single)]
    return mod, wrappers, kw


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_fixpoint_smem_fits_the_driven_shapes(kind):
    """The fused fixpoints' shared memory (`launch.fixpoint_smem`, the
    kernels' ``Smem``) fits the opt-in limit at both full-width shapes and at
    the W=3 edge shape, and not at the shapes the GPU tests expect the
    wrappers to refuse."""
    def smem(n, d):
        dom_bytes = 4 * n * -(-d // 32) if kind == "packed" else n * d
        return launch.fixpoint_smem(n, d, dom_bytes)

    for n, d in [(104, 40), (160, 16), (40, 72)]:
        assert smem(n, d) <= launch.SMEM_OPT_IN_LIMIT
    assert smem(4096, 8) > launch.SMEM_OPT_IN_LIMIT  # the mask bits alone take 2 MB
    assert smem(1, 24584) > launch.SMEM_OPT_IN_LIMIT
    # the main shape, counted by hand: two domain buffers (2 × 832 B packed,
    # 2 × 4,160 B dense), then 4,376 B of mask bits, seed and violation
    # words, wipe-out flags, neighbour and value lists and changed flags
    assert smem(104, 40) == (1664 if kind == "packed" else 8320) + 4376
    if kind == "packed":
        # a row of the colouring cell's shape (n 1,000, d 88, W 3) split over
        # c CTAs, counted by hand: two buffers of c spans' words (a span is
        # ceil(1000/c) rounded up to 16: 512, 256, 128; 1,024 variables, 2 ×
        # 12,288 B), the span's mask bits (span × 32 words), 1,128 B of seed
        # and violation words and wipe-out flags, 17,408 B of lists, aligned
        # to 16, then two buffers of 1,024 changed flags. c = 1 is the
        # figure every route decides on, the same with or without `split`
        assert smem(1000, 88) == launch.fixpoint_smem(1000, 88, 12000, split=1) == 172536
        for c, span in ((2, 512), (4, 256), (8, 128)):
            assert launch.split_span(1000, c) == span
            head = 2 * 12288 + 4 * 32 * span + 1128 + 17408
            want = -(-head // 16) * 16 + 2 * 1024
            assert launch.fixpoint_smem(1000, 88, 12000, split=c) == want
        assert [launch.fixpoint_smem(1000, 88, 12000, split=c) for c in (2, 4, 8)] == [
            110704, 77936, 61552]
        assert launch.split_span(104, 1) == 104 and launch.split_span(16, 4) == 16


#: `launch.fixpoint_split` cases: (rows, n, SMs) -> CTAs a row. The
#: colouring cell (32 rows of n 1,000 on an H100's 132 SMs) spreads its rows
#: over clusters of 8, two split CTAs an SM; rb100-40 (n 104) keeps one CTA
#: a row at any round width; 200 rows of n 1,000 and a 2-SM card leave no
#: SMs to spread over; 64 rows and 1 row of n 1,000 take 4 and 8
SPLIT_RULE = {
    (32, 1000, 132): 8,
    (1, 104, 132): 1, (2, 104, 132): 1, (32, 104, 132): 1, (1024, 104, 132): 1,
    (200, 1000, 132): 1,
    (32, 1000, 2): 1,
    (64, 1000, 132): 4, (1, 1000, 132): 8,
}


@pytest.mark.parametrize("rows,n,sms", list(SPLIT_RULE), ids=[
    "dsjc", "rb100-40_r1", "rb100-40_r2", "rb100-40_r32", "rb100-40_r1024", "r200_n1000",
    "two_sms", "r64_n1000", "r1_n1000"])
def test_fixpoint_split_rule(rows, n, sms):
    """`launch.fixpoint_split`: the largest power of two up to
    min(8, 2 · SMs // rows) from n = `SPLIT_MIN_N`, else 1."""
    c = launch.fixpoint_split(rows, n, sms)
    assert c == SPLIT_RULE[rows, n, sms]
    room = min(launch.SPLIT_MAX, launch.SPLIT_CTAS_PER_SM * sms // rows)
    assert c == 1 or (c & (c - 1) == 0 and c <= room < 2 * c)
    if rows == 32 and n == 1000 and sms == 132:
        assert c > 1
    assert 104 < launch.SPLIT_MIN_N <= 1000


def test_split_argument_is_checked_and_plain_on_the_cpu():
    """`packed_fixpoint_stacked`'s ``split`` is 1 to `launch.SPLIT_MAX`;
    on the CPU the wrapper computes its plain version whatever it is."""
    _, tables, idx, _, (dom, ch), (n_p, d_p, w) = _stacked_fixture(8, 5, 8, 8, "packed")
    r = len(idx)
    args = (tables[0], tables[1], torch.as_tensor(idx),
            ref.pack_bits_ref(dom).reshape(r, n_p * w), ch.to(torch.uint8))
    want = bs.packed_fixpoint_stacked_plain(*args, d=d_p, w=w)
    for c in (1, 4, launch.SPLIT_MAX):
        got = bs.packed_fixpoint_stacked(*args, d=d_p, w=w, split=c)
        assert all(torch.equal(g, e) for g, e in zip(got, want))
    for c in (0, launch.SPLIT_MAX + 1):
        with pytest.raises(ValueError, match="split"):
            bs.packed_fixpoint_stacked(*args, d=d_p, w=w, split=c)


#: `launch.revise_smem` at the driven shapes: (kind, n_p, d_p) -> bytes
REVISE_SMEM = {
    ("packed", 104, 40): 25088, ("packed", 160, 16): 55840, ("packed", 40, 72): 4544,
    ("dense", 104, 40): 28416, ("dense", 160, 16): 57760, ("dense", 40, 72): 6944,
}


@pytest.mark.parametrize("kind,n,d", list(REVISE_SMEM))
def test_revise_smem_pins_the_driven_shapes(kind, n, d):
    """The stacked revises' shared memory (`launch.revise_smem`, ``Smem`` in
    csrc/revise_common.cuh) at both full-width shapes and the W=3 edge
    shape, within the opt-in limit; the shapes the GPU tests expect the
    dense wrappers to refuse, or to route wide, still exceed their limits."""
    dom_bytes = 4 * n * -(-d // 32) if kind == "packed" else n * d
    assert launch.revise_smem(n, d, dom_bytes) == REVISE_SMEM[kind, n, d]
    assert REVISE_SMEM[kind, n, d] <= launch.SMEM_OPT_IN_LIMIT
    if (n, d) == (104, 40):
        # by hand: the domain (104 × 2 words × 4 B packed, 104 × 40 B dense);
        # per warp 4 seed words and, for each of its 13 owner lanes, 4
        # neighbour-bit words and 2 violation words (8 × 82 × 4 B); per warp
        # 13 × 104 (variable, neighbour) pairs of 2 B (8 × 2,704 B)
        assert REVISE_SMEM[kind, n, d] == (832 if kind == "packed" else 4160) + 2624 + 21632
    if kind == "dense":
        assert launch.revise_smem(4096, 8, 4096 * 8) > launch.SMEM_OPT_IN_LIMIT
        assert launch.single_revise_smem(2040, 8) > launch.SMEM_OPT_IN_LIMIT
        assert launch.fixpoint_smem(1, 24584, 24584) > launch.SMEM_OPT_IN_LIMIT


#: the single-network revises' shared memory at the driven shapes, as their
#: wrappers check it (`launch.single_revise_smem`: a CTA that owns every
#: variable of a row): (n_p, d_p) -> bytes, the same for both kinds
SINGLE_REVISE_SMEM = {(104, 40): 25920, (160, 16): 58400, (40, 72): 4384}


@pytest.mark.parametrize("n,d", list(SINGLE_REVISE_SMEM))
def test_single_revise_smem_pins_the_driven_shapes(n, d):
    """The single-network revises read the domain in place and keep their
    variables' mask rows as bits in its place, so their layout is the
    stacked one with the mask bits for the domain; it fits the opt-in limit
    at the driven shapes, and the shape at which the GPU test expects the
    wrappers to take the wide route below n = 2048 does not fit."""
    assert launch.single_revise_smem(n, d) == SINGLE_REVISE_SMEM[n, d]
    assert SINGLE_REVISE_SMEM[n, d] <= launch.SMEM_OPT_IN_LIMIT
    if (n, d) == (104, 40):
        # by hand: the mask bits (104 rows × 4 words × 4 B) in the domain's
        # place of the stacked layout: per warp 4 seed words and, for each of
        # its 13 owner lanes, 4 neighbour-bit words and 2 violation words
        # (8 × 82 × 4 B); per warp 13 × 104 (variable, neighbour) pairs of
        # 2 B (8 × 2,704 B)
        assert SINGLE_REVISE_SMEM[n, d] == 1664 + 2624 + 21632
        for kind, dom_bytes in (("packed", 832), ("dense", 4160)):
            assert launch.revise_smem(n, d, dom_bytes) - dom_bytes == 2624 + 21632
    # below n = 2^11 a tuned span may own a whole row: the pairs alone of 32
    # owner lanes a warp, 8 × 32 × 2,040 × 2 B
    assert launch.single_revise_smem(2040, 8) > 8 * 32 * 2040 * 2 > launch.SMEM_OPT_IN_LIMIT


def test_single_revise_from_n_2048_revises_one_variable_a_warp():
    """From n = 2^11 the single-network revises no longer revise a variable
    a warp: they run the block revise's kernel on the whole network in the
    single-network (value-major) layout, through their own launchers, with
    the block revise's scratch and shared memory, and autotune offers no
    span there, only the default (0: the route picks its own grid)."""
    from repro_torch.kernels import autotune

    assert launch.SINGLE_WIDE_N == 2048
    assert launch.SIGNATURES["packed_revise"]["packed_revise_wide_launch"] == (6, 4)
    assert launch.SIGNATURES["dense_revise"]["dense_revise_wide_launch"] == (6, 3)
    # the seed pass's scratch at n=4096, d=32, counted by hand: per group of
    # 32 rows 4,096 row masks and 128 union words (u32), 16-byte aligned,
    # then 4,096 × 32 rows' entries a group (4 B packed, W = 1; 32 B dense)
    for rows, groups in ((1, 1), (512, 16)):
        head = 4 * groups * (4096 + 128)
        assert head % 16 == 0
        assert launch.block_scratch_bytes(rows, 4096, 4) == head + groups * 4096 * 32 * 4
        assert launch.block_scratch_bytes(rows, 4096, 32) == head + groups * 4096 * 32 * 32
    assert launch.block_scratch_bytes(1, 4096, 4) == 541184
    assert launch.block_scratch_bytes(512, 4096, 32) == 67379200  # 64 MiB of domains
    # a CTA's shared memory: 128 union words, per warp 1,024 u16 neighbours
    # and 32 u32 row-mask slots, then 8 stages of 2,048 B
    assert launch.block_smem(4096) == 512 + 8 * 2048 + 8 * 128 + 8 * 2048 == 34304
    assert launch.block_smem(4096) <= launch.SMEM_OPT_IN_LIMIT
    assert launch.single_wide(4096, 32)
    for kind in ("packed_single", "dense_single"):
        for rows in (1, 32, 512):
            assert autotune.default_config(kind, 4096, 32, rows) == autotune.TuneConfig(span=0)
        assert autotune.candidate_configs(kind, 4096, 32, 512) == [autotune.TuneConfig(span=0)]
        # a cached span from the old route falls back to the default
        assert autotune._sanitize(kind, autotune.TuneConfig(span=8), 4096, 32, 512) == \
            autotune.TuneConfig(span=0)
    assert autotune.single_span(512, 2040, sms=132) == 1024  # the narrow route's rule


#: (kind, n, d) of the identity the single-network revises' route from
#: n = 2048 rests on: packed W = 1 and 2, dense
WIDE_IDENTITY = [("packed", 24, 32), ("packed", 24, 40), ("dense", 24, 16)]


@pytest.mark.parametrize("kind,n,d", WIDE_IDENTITY)
def test_single_network_plain_equals_the_block_plain_at_nx_n(kind, n, d, monkeypatch):
    """From n = 2048 `packed_revise` / `dense_revise` run the block
    revise's kernel on the single-network network: the network
    `ops.prepare_packed` / `ops.prepare_dense` make is the pair-major block
    (`core.sharded.block_layout`) permuted (x, y, a, K) -> (x, a, y, K), and
    the plain single-network revise on it equals the plain block revise on
    the block at nx = n, row by row, also in chunks of 5 x-rows."""
    from repro_torch.core.sharded import block_layout

    rng = np.random.default_rng([n, d])
    mask = np.triu(rng.random((n, n)) < 0.3, 1)
    mask |= mask.T
    cons = (rng.random((n, n, d, d)) < 0.3) & mask[:, :, None, None]
    dom = rng.random((6, n, d)) < 0.4
    changed = np.zeros((6, n), dtype=bool)
    changed[0] = True  # a root row
    changed[1, 5] = True  # one-hot
    changed[2] = rng.random(n) < 0.3  # row 3 has no seed
    changed[4] = rng.random(n) < 0.1
    changed[5, ::2] = True
    csp = csp_from_numpy(cons, mask, np.ones((n, d), dtype=bool), CPU)
    ch = torch.from_numpy(changed.astype(np.uint8))
    if kind == "packed":
        (net, m), _, (n_p, d_p, w) = ops.prepare_packed(csp, memo=False)
        block = block_layout(csp.cons, "bitpacked", torch.bfloat16)
        rows = ref.pack_bits_ref(torch.from_numpy(dom)).reshape(6, n * w)
        mod, kw, chunk = bs, dict(d=d, w=w), ("_NET_CHUNK_WORDS", d * n * w * 5)
    else:
        (net, m), _, (n_p, d_p) = ops.prepare_dense(csp, memo=False)
        block = block_layout(csp.cons, "einsum", torch.uint8)
        rows = torch.from_numpy(dom.astype(np.uint8)).reshape(6, n * d)
        mod, kw, chunk = rs, dict(d=d), ("_NET_CHUNK_BYTES", d * n * d * 5)
    assert (n_p, d_p) == (n, d)
    assert torch.equal(block.permute(0, 2, 1, 3).reshape(n * d, -1), net)
    want = getattr(mod, f"{kind}_revise_block_plain")(block, m, rows, ch, **kw)
    got = getattr(mod, f"{kind}_revise_plain")(net, m, rows, ch, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    monkeypatch.setattr(mod, *chunk)
    torch.testing.assert_close(getattr(mod, f"{kind}_revise_plain")(net, m, rows, ch, **kw),
                               want, rtol=0, atol=0)
    assert want[0].any() and want[1].any() and not want[3].any()


def test_cpu_wrappers_run_plain_and_count_no_launch():
    for kind in ("packed", "dense"):
        mod, wrappers, kw = _wrapper_args(kind)
        mod.reset_launches()
        for fn, args in wrappers:
            plain = getattr(mod, f"{fn.__name__}_plain")
            got, want = fn(*args, **kw), plain(*args, **kw)
            for g, e in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
                torch.testing.assert_close(g, e, rtol=0, atol=0)
            assert fn.launches == 0


def test_wrappers_reject_operands_the_kernels_do_not_take():
    for kind in ("packed", "dense"):
        _, wrappers, kw = _wrapper_args(kind)
        for fn, good in wrappers:
            cons, rows, ch = good[0], good[-2], good[-1]
            bad_cases = [
                (cons.to(torch.int64),) + good[1:],  # wrong network type
                good[:-2] + (rows[:, :-1], ch),  # wrong shape
                good[:-1] + (ch.t().contiguous().t(),),  # not contiguous
            ]
            if len(good) == 5:  # stacked: wrong idx type
                bad_cases.append(good[:2] + (good[2].to(torch.int64),) + good[3:])
            for args in bad_cases:
                with pytest.raises(ValueError):
                    fn(*args, **kw)
