"""The word loop: a fused packed engine's single-network fixpoint where the
fused kernel cannot take the shape (`ops.packed_word_fixpoint`).

The loop keeps the domains on the card as packed words, launches kernel 3
(`packed_revise`) and the epilogue kernel (`packed_word_epilogue`) a
recurrence, and reads the count of rows still active once a chunk of
`ops.WORD_CHUNK` recurrences. Its closures, verdicts and recurrence counts
must equal, bit for bit, the host loop's (`rtac._fixpoint_rows`, the stepped
engine's route) with the same revise and the benchmark's plain fixpoint
(`rtacbench/reference/fixpoint.py`), at any chunk length.

On the CPU the wrappers compute their plain versions. At QWH's shape
(n_p = 1,600, d_p = 40) and the production CSP's (n_p = 4,096, d_p = 32) a
dense packed network would take 0.8 and 2 GiB, so those cases swap
`packed_revise` for the plain fixpoint's sparse revise, on both routes.
The ``gpu`` tests hold the epilogue kernel against its plain version and
the route against the stepped engine's host loop on the card.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import rtac
from repro_torch.core.engine import pad_changed, pad_dom
from repro_torch.engines import get_engine
from repro_torch.kernels import bitpack_support as bs, ops, ref, rtac_support as rs
from repro_torch.problems import generate
from rtacbench.lib import qwh as lib_qwh
from rtacbench.reference import fixpoint as fx
from rtacbench.reference import qwh

CPU = torch.device("cpu")
CHUNKS = [1, 2, 5]
ROUTES = ("fixpoint.one_launch", "fixpoint.word_loop", "fixpoint.host_loop")


def _counters(names=ROUTES + ("sync.count", "fixpoint.spec_recurrences")):
    return {k: obs.REGISTRY.counter(k) for k in names}


def _delta(before):
    return {k: obs.REGISTRY.counter(k) - v for k, v in before.items()}


@pytest.fixture
def chunk(request, monkeypatch):
    monkeypatch.setattr(ops, "WORD_CHUNK", request.param)
    return request.param


def _rows(root, n_rows, rng):
    """``n_rows`` rows as `mac_solve` and `enforce_batch` meet them: the
    root itself with every variable seeded, children of it (one variable
    assigned, its one-hot seed; then five, most of which wipe out), a
    seedless copy of a child (frozen before its first recurrence) and a row
    with an empty domain (inconsistent from the start)."""
    n = root.shape[0]
    doms, chs = [root.copy()], [np.ones(n, dtype=bool)]
    for i in range(n_rows - 3):
        dom, ch = root.copy(), np.zeros(n, dtype=bool)
        picks = rng.choice(n, 1 if i % 2 == 0 else 5, replace=False)
        for var in picks:
            vals = np.nonzero(dom[var])[0]
            dom[var] = False
            dom[var, vals[rng.integers(len(vals))]] = True
        ch[picks] = True
        doms.append(dom)
        chs.append(ch)
    doms.append(doms[-1].copy())
    chs.append(np.zeros(n, dtype=bool))
    empty = root.copy()
    empty[rng.integers(n)] = False
    doms.append(empty)
    chs.append(np.ones(n, dtype=bool))
    return np.stack(doms), np.stack(chs)


def _padded(doms, chs, n_p, d_p):
    n = doms.shape[1]
    dom_p = pad_dom(torch.as_tensor(doms), n_p, d_p)
    return dom_p, pad_changed(torch.as_tensor(chs), n, n_p, batch=(len(doms),))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _same_as_plain(got, net, doms, chs):
    """The result against the benchmark's plain fixpoint on ``net`` from the
    unpadded rows (padded variables are never seeded and never lose their
    one value)."""
    n, d = doms.shape[1:]
    want = fx.fixpoint(net, fx.pack(torch.as_tensor(doms)), torch.as_tensor(chs))
    assert torch.equal(fx.pack(got.dom[:, :n, :d]), want.dom)
    assert torch.equal(got.consistent, want.consistent)
    assert torch.equal(got.n_recurrences, want.k)


# --- the epilogue's plain version ----------------------------------------------


def _epilogue_operands(b, n, d, seed=0):
    """Words with half the bits of the d values set, 2 % of the values
    violated, seeds on two rows in three (the third seedless), row 1 with
    an empty domain and seeds (an inconsistent row as given on entry)."""
    g = torch.Generator().manual_seed(seed)
    w = -(-d // 32)
    bits = torch.rand((b, n, w * 32), generator=g) < 0.5
    bits[..., d:] = False
    bits[..., 0] = True
    if b > 1:
        bits[1, 2] = False
    words = ref.pack_bits_ref(bits).reshape(b, n * w).contiguous()
    viol = (torch.rand((b, n * d), generator=g) < 0.02).to(torch.uint8)
    seeded = torch.arange(b) % 3 != 2
    seed_ = ((torch.rand((b, n), generator=g) < 0.3) & seeded[:, None]).to(torch.uint8)
    seed_[seeded, 0] = 1
    consistent = torch.full((b,), 7, dtype=torch.uint8)  # written for every row
    k = torch.randint(0, 4, (b,), generator=g, dtype=torch.int32)
    return [words, viol, seed_, consistent, k, torch.zeros(2, dtype=torch.int32)]


@pytest.mark.parametrize("b,n,d", [(6, 16, 8), (5, 40, 40), (4, 104, 64)])
def test_epilogue_plain_is_one_recurrence_of_the_host_loop(b, n, d):
    """One epilogue on the CPU, against the host loop's recurrence written
    out on bools: a row is active iff it has a seed and no empty domain;
    active rows lose their violated values, a row whose domain empties is
    inconsistent and inactive, a row that changed nothing goes inactive,
    other rows keep their domains and k and lose their seeds, and the
    counts are the rows revised and the rows left active."""
    w = -(-d // 32)
    args = _epilogue_operands(b, n, d)
    words, viol, seed, _, k, _ = (t.clone() for t in args)
    viol.view(b, n, d)[0, 3] = 1  # row 0 (active) wipes out variable 3
    viol.view(b, n, d)[3] = 0  # row 3 (active) changes nothing
    args[1] = viol
    dom = ref.unpack_bits_ref(words.view(b, n, w), d)
    act = seed.bool().any(dim=-1) & rtac._alive(dom)
    new = torch.where(act[:, None, None], dom & ~viol.view(b, n, d).bool(), dom)
    changed = (new != dom).any(dim=-1)
    alive = rtac._alive(new)
    nxt = act & alive & changed.any(dim=-1)
    bs.packed_word_epilogue(*args, d=d, w=w)
    assert torch.equal(ref.unpack_bits_ref(args[0].view(b, n, w), d), new)
    assert torch.equal(args[2], (changed & nxt[:, None]).to(torch.uint8))
    assert torch.equal(args[3], alive.to(torch.uint8))
    assert torch.equal(args[4], k + act.to(torch.int32))
    assert args[5].tolist() == [int(act.sum()), int(nxt.sum())]
    assert act.tolist()[:4] == [True, False, False, True] and not nxt[0] and not nxt[3]
    assert args[3].tolist()[:3] == [0, 0, 1]


@pytest.mark.parametrize("bad", ["d", "w", "dtype", "shape"])
def test_epilogue_refuses_operands_it_cannot_hold(bad):
    b, n, d = 2, 16, 8
    args = list(_epilogue_operands(b, n, d))
    kw = dict(d=d, w=1)
    if bad == "d":
        kw = dict(d=6, w=1)
    elif bad == "w":
        kw = dict(d=d, w=2)
    elif bad == "dtype":
        args[4] = args[4].long()
    else:
        args[5] = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="packed_word_epilogue"):
        bs.packed_word_epilogue(*args, **kw)


@pytest.mark.parametrize("d_p", [8, 16, 24, 32, 40, 64, 72, 128])
def test_byte_words_equal_pack_bits(d_p):
    """The one packer of the word format (a byte a run of 8 values) gives
    `pack_bits_ref`'s words, the padding bits clear; the one unpacker gives
    the domains back whatever the padding bits hold; a d_p that is not a
    multiple of 8 is refused by both."""
    dom = torch.rand((3, 24, d_p), generator=torch.Generator().manual_seed(d_p)) < 0.5
    got = ops.pack_words(dom)
    assert got.dtype == torch.int32 and torch.equal(got, ref.pack_bits_ref(dom))
    assert torch.equal(ops.unpack_words(got, d_p), dom)
    if d_p % 32:
        dirty = got | ref.pack_bits_ref(torch.arange(got.shape[-1] * 32) >= d_p)
        assert torch.equal(ops.unpack_words(dirty, d_p), dom)
    with pytest.raises(ValueError, match="pack_words"):
        ops.pack_words(dom[..., :d_p - 3])
    with pytest.raises(ValueError, match="unpack_words"):
        ops.unpack_words(got, d_p - 4)


# --- the loop at small shapes, with the plain packed revise -----------------------

#: padded shapes n_p=32, d_p=16 (W=1) and n_p=40, d_p=40 (W=2)
SMALL = [("model_rb", dict(n=30, hardness=0.9)),
         ("random_binary", dict(n=40, d=40, density=0.3, tightness=0.6))]


def _small(family, knobs):
    csp = generate(family, seed=0, device=CPU, **knobs)
    prepared = get_engine("hopper_packed", fixpoint="stepped", device=CPU).prepare(csp)
    network, dims = prepared.payload
    root = prepared.enforce(csp.dom).dom.numpy()
    return csp, network, dims, functools.partial(ops.revise_single, "packed", dims), root


@pytest.mark.parametrize("chunk", CHUNKS, indirect=True)
@pytest.mark.parametrize("family,knobs", SMALL)
def test_word_loop_equals_host_loop_and_plain_fixpoint(family, knobs, chunk):
    """The word loop called directly on 12 rows (the root, children that
    finish at different k, rows that wipe out, a seedless row, an empty
    domain): closures, verdicts and k equal the host loop with the same
    revise and the plain fixpoint, and it reads its predicate once a chunk
    of recurrences, ceil(max(k, 1) / chunk) times."""
    csp, network, dims, revise_fn, root = _small(family, knobs)
    doms, chs = _rows(root, 12, np.random.default_rng(1))
    doms[0], chs[0] = csp.dom.numpy(), True
    dom_p, ch_p = _padded(doms, chs, *dims[:2])
    before = _counters()
    got = ops.packed_word_fixpoint(network, dom_p, ch_p, dims)
    moved = _delta(before)
    _same(got, rtac.enforce_batch_generic(network, dom_p, ch_p, revise_fn=revise_fn))
    _same_as_plain(got, fx.dense_network(csp.cons, csp.mask), doms, chs)
    k = got.n_recurrences
    assert set(got.consistent.tolist()) == {True, False} and len(set(k.tolist())) >= 3
    k_max = int(k.max())
    reads = -(-max(k_max, 1) // chunk)
    assert moved["sync.count"] == reads
    assert moved["fixpoint.spec_recurrences"] == reads * chunk - k_max


@pytest.mark.parametrize("chunk", CHUNKS, indirect=True)
def test_word_loop_without_an_active_row(chunk):
    """A call whose rows are all seedless or inconsistent: no row revised,
    k = 0, the domains as given; one chunk, its launches all past the
    fixpoint, and one read."""
    csp, network, dims, revise_fn, root = _small(*SMALL[1])
    doms, chs = _rows(root, 6, np.random.default_rng(2))
    chs[:-1] = False
    dom_p, ch_p = _padded(doms, chs, *dims[:2])
    before = _counters()
    got = ops.packed_word_fixpoint(network, dom_p, ch_p, dims)
    moved = _delta(before)
    assert got.n_recurrences.tolist() == [0] * 6
    assert got.consistent.tolist() == [True] * 5 + [False]
    assert torch.equal(got.dom, dom_p)
    _same(got, rtac.enforce_batch_generic(network, dom_p, ch_p, revise_fn=revise_fn))
    assert (moved["sync.count"], moved["fixpoint.spec_recurrences"]) == (1, chunk)


# --- QWH's and the production CSP's shapes, through `_fixpoint` --------------------


def _sparse_revise(net, mask, dom_words, changed, *, d, w):
    """`packed_revise`'s result from the plain fixpoint's sparse revise of
    ``net`` (an `fx.Network`; ``mask`` unused): what both routes launch."""
    del mask
    b = changed.shape[0]
    words = dom_words.view(b, -1, w).long() & 0xFFFFFFFF
    bits = words[..., 0] if w == 1 else words[..., 0] | (words[..., 1] << 32)
    dead = fx.revise(net, bits, changed.bool())
    return fx.unpack(dead, d).reshape(b, -1).to(torch.uint8)


def _random_sparse(n, d, degree, tightness, seed):
    """A random binary network of n variables with about ``degree``
    neighbours each: both orientations of every scope, the second the
    first's relation transposed."""
    rng = np.random.default_rng(seed)
    m = n * degree // 2
    xs, ys = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = xs != ys
    pairs = np.unique(np.stack([np.minimum(xs, ys), np.maximum(xs, ys)])[:, keep], axis=1)
    rels = rng.random((pairs.shape[1], d, d)) >= tightness
    return fx.network(np.concatenate([pairs[0], pairs[1]]),
                      np.concatenate([pairs[1], pairs[0]]),
                      np.concatenate([rels, rels.transpose(0, 2, 1)]), n)


def _qwh_case():
    dr = qwh.qwh_draws(5, 40, 672, moves=1600)
    return lib_qwh.network(dr), qwh.root(dr)


def _prod_case():
    n, d = 4096, 32
    return _random_sparse(n, d, 4, 0.6, 0), np.ones((n, d), dtype=bool)


LARGE = {"qwh": _qwh_case, "prod4096": _prod_case}


@pytest.fixture(scope="module")
def large():
    return {name: make() for name, make in LARGE.items()}


def _payload(net, d_p):
    return (net, None), (net.n, d_p, -(-d_p // 32))


@pytest.mark.parametrize("chunk", CHUNKS, indirect=True)
@pytest.mark.parametrize("shape", list(LARGE))
def test_fused_engine_takes_the_word_loop_at_large_shapes(monkeypatch, large, shape, chunk):
    """`_HopperEngine._fixpoint` at n_p = 1,600, d_p = 40 (QWH order 40) and
    n_p = 4,096, d_p = 32 (the production CSP): the fused packed engine runs
    the word loop (``fixpoint.word_loop`` ticks, ``fixpoint.host_loop`` does
    not), the stepped engine the host loop, on the same revise; both equal
    the plain fixpoint on the root row, children finishing at different k,
    rows that wipe out, a seedless row and an empty domain."""
    net, root = large[shape]
    monkeypatch.setattr(bs, "packed_revise", _sparse_revise)
    payload = _payload(net, root.shape[1])
    assert not ops.single_fused("packed", *payload[1][:2])
    rng = np.random.default_rng(3)
    doms, chs = _rows(root, 5, rng)
    dom_p, ch_p = _padded(doms, chs, *payload[1][:2])
    fused = get_engine("hopper_packed", fixpoint="fused", device=CPU)
    stepped = get_engine("hopper_packed", fixpoint="stepped", device=CPU)
    before = _counters()
    got = fused._fixpoint(payload, dom_p, ch_p)
    moved = _delta(before)
    assert (moved["fixpoint.one_launch"], moved["fixpoint.word_loop"],
            moved["fixpoint.host_loop"]) == (0, 1, 0)
    k_max = int(got.n_recurrences.max())
    assert moved["sync.count"] == -(-max(k_max, 1) // chunk)
    before = _counters()
    want = stepped._fixpoint(payload, dom_p, ch_p)
    moved = _delta(before)
    assert (moved["fixpoint.word_loop"], moved["fixpoint.host_loop"]) == (0, 1)
    assert moved["sync.count"] == k_max + 1
    _same(got, want)
    _same_as_plain(got, net, doms, chs)
    assert len(set(got.n_recurrences.tolist())) >= 3


# --- which route a call takes, and its reads -------------------------------------


@pytest.mark.parametrize("case", ["104-fused", "1600-fused", "4096-fused", "1600-stepped",
                                  "4096-dense-fused"])
def test_route_counters(monkeypatch, large, case):
    """One tick of one route counter a call: ``fixpoint.one_launch`` at
    n_p = 104 (rb100-40; the fused CTA fits), ``fixpoint.word_loop`` for
    the fused packed engine at n_p = 1,600 and 4,096, ``fixpoint.host_loop``
    for the stepped engine, and for the dense kind, which has no words."""
    n_p, *rest = case.split("-")
    name = "hopper_dense" if "dense" in rest else "hopper_packed"
    engine = get_engine(name, fixpoint=rest[-1], device=CPU)
    want = {"104": "fixpoint.one_launch",
            "fused": "fixpoint.word_loop", "stepped": "fixpoint.host_loop",
            "dense": "fixpoint.host_loop"}
    route = want["104"] if n_p == "104" else want[rest[0]]
    before = _counters(ROUTES)
    if n_p == "104":
        csp = generate("model_rb", seed=0, device=CPU, n=100, alpha=0.8, r=0.7, hardness=0.9)
        prepared = engine.prepare(csp)
        assert prepared.payload[1][:2] == (104, 40)
        prepared.enforce(csp.dom)
    else:
        net, root = large["qwh" if n_p == "1600" else "prod4096"]
        monkeypatch.setattr(bs, "packed_revise", _sparse_revise)
        payload = _payload(net, root.shape[1])
        if name == "hopper_dense":
            network, (n_p, d_p, w) = payload

            def dense_revise(net, mask, dom, changed, *, d):
                words = ops.pack_words(dom.view(dom.shape[0], -1, d).bool())
                return _sparse_revise(net, mask, words.view(dom.shape[0], -1), changed, d=d, w=w)
            monkeypatch.setattr(rs, "dense_revise", dense_revise)
            payload = (network, (n_p, d_p))
        doms, chs = _rows(root, 4, np.random.default_rng(4))
        engine._fixpoint(payload, *_padded(doms, chs, net.n, root.shape[1]))
    moved = _delta(before)
    assert moved == {k: int(k == route) for k in ROUTES}


def test_a_call_of_k_at_most_two_reads_once(large, monkeypatch):
    """At the default chunk of two, a call whose rows all reach their
    fixpoint within two recurrences does one ``sync.wait``; the host loop
    does ``max(k) + 1``."""
    assert ops.WORD_CHUNK == 2
    net, root = large["qwh"]
    monkeypatch.setattr(bs, "packed_revise", _sparse_revise)
    payload = _payload(net, root.shape[1])
    doms, chs = _rows(root, 16, np.random.default_rng(5))
    dom_p, ch_p = _padded(doms, chs, net.n, root.shape[1])
    revise_fn = functools.partial(ops.revise_single, "packed", payload[1])
    k = rtac.enforce_batch_generic(payload[0], dom_p, ch_p, revise_fn=revise_fn).n_recurrences
    rows = (k <= 2).nonzero().flatten()
    assert int(k[rows].max()) == 2 and len(rows) >= 4
    fused = get_engine("hopper_packed", fixpoint="fused", device=CPU)
    tracer = obs.enable()
    try:
        before = _counters()
        got = fused._fixpoint(payload, dom_p[rows], ch_p[rows])
        moved = _delta(before)
        totals = tracer.snapshot_totals()
    finally:
        obs.disable()
    assert torch.equal(got.n_recurrences, k[rows])
    assert moved["sync.count"] == 1 and totals["sync.wait"][0] == 1
    assert totals["fixpoint.chunk"][0] == 1 and "fixpoint.recurrence" not in totals
    assert moved["fixpoint.spec_recurrences"] == 0


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(1, 1600, 40), (2, 1600, 40), (512, 4096, 32),
                                   (64, 104, 40), (3, 16, 8), (7, 200, 72)])
def test_epilogue_kernel_matches_plain_on_card(cuda, b, n, d):
    """The epilogue kernel against its plain version, every operand bit for
    bit after the call, on rows active and not, one wiping out."""
    w = -(-d // 32)
    host = list(_epilogue_operands(b, n, d, seed=b + n))
    host[1].view(b, n, d)[0, 1] = 1
    dev = [t.to(cuda) for t in host]
    bs.reset_launches()
    bs.packed_word_epilogue(*dev, d=d, w=w)
    bs.packed_word_epilogue_plain(*host, d=d, w=w)
    assert bs.packed_word_epilogue.launches == 1
    for got, want in zip(dev, host):
        assert torch.equal(got.cpu(), want)


_CARD_CASES = {}


def _card_case(shape, device):
    """(payload, root) of a shape on the card, built once a test run: QWH
    order 40 prepared by the fused engine, or a random packed network at the
    production CSP's shape (a symmetric mask of density 0.01, a random word,
    half the bits set, an entry; only masked entries are read)."""
    if shape not in _CARD_CASES:
        if shape == "qwh":
            from repro_torch.core.csp import CSP

            dr = qwh.qwh_draws(5, 40, 672, moves=1600)
            engine = get_engine("hopper_packed", fixpoint="fused", device=device)
            _CARD_CASES[shape] = (engine.prepare(CSP(*lib_qwh.on_device(dr, device))).payload,
                                  qwh.root(dr))
        else:
            n, d = 4096, 32
            g = torch.Generator(device=device).manual_seed(0)
            upper = (torch.rand((n, n), generator=g, device=device) < 0.005).triu(1)
            mask = (upper | upper.T).to(torch.uint8)
            cons = torch.randint(-2**31, 2**31, (n * d, n), generator=g, dtype=torch.int32,
                                 device=device)
            _CARD_CASES[shape] = (((cons, mask), (n, d, 1)), np.ones((n, d), dtype=bool))
    return _CARD_CASES[shape]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 512])
@pytest.mark.parametrize("shape", ["qwh", "prod4096"])
def test_word_loop_equals_host_loop_on_card(cuda, shape, b):
    """The fused engine's word loop (kernel 3 and the epilogue kernel) against
    the stepped engine's host loop (kernel 3) on the card, on the same
    prepared network: QWH order 40 and the production shape; B = 1 (the
    root, every variable seeded), 2 (two children) and 512 (`_rows`' mix).
    ``fixpoint.word_loop`` ticks, ``fixpoint.host_loop`` does not."""
    payload, root = _card_case(shape, cuda)
    doms, chs = _rows(root, max(b, 5), np.random.default_rng(b))
    if b < 3:
        doms, chs = (doms[:1], chs[:1]) if b == 1 else (doms[1:3], chs[1:3])
    n_p, d_p = payload[1][:2]
    dom_p, ch_p = (t.to(cuda) for t in _padded(doms, chs, n_p, d_p))
    fused = get_engine("hopper_packed", fixpoint="fused", device=cuda)
    stepped = get_engine("hopper_packed", fixpoint="stepped", device=cuda)
    bs.reset_launches()
    before = _counters()
    got = fused._fixpoint(payload, dom_p, ch_p)
    moved = _delta(before)
    assert (moved["fixpoint.word_loop"], moved["fixpoint.host_loop"]) == (1, 0)
    assert bs.packed_word_epilogue.launches == bs.packed_revise.launches > 0
    want = stepped._fixpoint(payload, dom_p, ch_p)
    _same(got, want)
    assert int(got.n_recurrences.max()) > 0
