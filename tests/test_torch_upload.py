"""The staged upload: a host domain of at least `STAGE_MIN_BYTES` bools
bound for a card goes through pinned chunks (`core.engine._staged_upload`),
each chunk's DMA overlapping the host's copy of the next.

`as_dom` is the one place where a host domain becomes a device tensor, so
every engine's `enforce` and `enforce_batch` goes through it. The staged
result must equal, bit for bit, the plain copy
(``torch.as_tensor(a).to("cuda")``), also when the caller overwrites its
array right after the call returns. On the CPU the routing decision, the
chunking and `as_dom` on a CPU device are held against the plain version;
``torch.empty`` stripped of ``pin_memory`` lets the chunk loop run there.
The ``gpu`` tests hold the staged path on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.csp import CSP
from repro_torch.core.engine import PreparedNetwork, as_dom, chunk_rows, stages
from repro_torch.engines import get_engine
from rtacbench.reference import generators as gen

MIB = 1 << 20


def _staged_count():
    return obs.REGISTRY.counter("upload.staged")


def _plain(dom, device):
    """`as_dom` as it was before the staged upload."""
    if isinstance(dom, torch.Tensor):
        return dom.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(dom, dtype=bool), device=device)


def _bools(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape, dtype=np.uint8).view(bool)


# --- on the CPU --------------------------------------------------------------------


@pytest.mark.parametrize("nbytes,device,want", [
    (engine.STAGE_MIN_BYTES - 1, "cuda", False),
    (engine.STAGE_MIN_BYTES, "cuda", True),
    (64 * MIB, "cuda", True),
    (64 * MIB, torch.device("cuda", 0), True),
    (0, "cuda", False),
    (64 * MIB, "cpu", False),
    (engine.STAGE_MIN_BYTES, torch.device("cpu"), False),
])
def test_stages_routes_by_bytes_and_device(nbytes, device, want):
    """Staged exactly where the target is a card and the upload holds at
    least `STAGE_MIN_BYTES` bools."""
    assert stages(nbytes, device) is want


@pytest.mark.parametrize("shape,want", [
    ((512, 4096, 32), engine.STAGE_CHUNK_BYTES // (4096 * 32)),
    ((3, engine.STAGE_CHUNK_BYTES * 2), 1),
    ((engine.STAGE_CHUNK_BYTES * 3,), engine.STAGE_CHUNK_BYTES),
    ((7, 0, 32), engine.STAGE_CHUNK_BYTES),
])
def test_chunk_rows_holds_about_a_chunk_and_at_least_a_row(shape, want):
    assert chunk_rows(shape) == want


def _cpu_case(case):
    if case == "bool_64mib":  # the batch512 cell's call
        return _bools((512, 4096, 32), 0)
    if case == "uint8":
        return _bools((64, 4096, 32), 1).astype(np.uint8)
    if case == "view":
        return _bools((64, 4096, 64), 2)[:, :, ::2]
    if case == "tensor":
        return torch.as_tensor(_bools((64, 4096, 32), 3))
    if case == "list":
        return _bools((3, 5), 4).tolist()
    return _bools((100, 40), 5)


@pytest.mark.parametrize("case", ["bool_64mib", "uint8", "view", "tensor", "list", "small"])
def test_as_dom_on_a_cpu_device_is_the_plain_copy(case, monkeypatch):
    """On a CPU device `as_dom` returns the plain version's values, stages
    nothing and allocates no pinned memory, whatever the size."""
    dom = _cpu_case(case)

    def refuse(*args, **kwargs):
        raise AssertionError("staged on a CPU device")

    monkeypatch.setattr(engine, "_staged_upload", refuse)
    before = _staged_count()
    got = as_dom(dom, "cpu")
    want = _plain(dom, "cpu")
    assert got.dtype == torch.bool and got.device.type == "cpu"
    assert torch.equal(got, want)
    assert not got.is_pinned()
    assert _staged_count() == before


@pytest.fixture
def unpinned(monkeypatch):
    """``torch.empty`` without page-locking, counting the pinned blocks the
    staged upload asks for, so its chunk loop runs on the CPU."""
    empty = torch.empty
    asked = []

    def fake(*args, pin_memory=False, **kwargs):
        out = empty(*args, **kwargs)
        if pin_memory:
            asked.append(out.numel())
        return out

    monkeypatch.setattr(torch, "empty", fake)
    return asked


@pytest.mark.parametrize("case", ["ragged", "view", "uint8", "tensor", "one_row"])
def test_staged_chunk_loop_copies_every_row_once(case, unpinned, monkeypatch):
    """The chunk loop on the CPU: every row lands once, in order, a pinned
    block a chunk of at most `STAGE_CHUNK_BYTES` (or one row), the counter
    ticks once a call. A chunk of 1 KiB makes the cuts visible at small
    sizes."""
    monkeypatch.setattr(engine, "STAGE_CHUNK_BYTES", 1024)
    src = {
        "ragged": _bools((37, 10, 32), 5),  # 3 rows a chunk, a last chunk of 1
        "view": _bools((20, 16, 64), 6)[:, ::2, 1::2],
        "uint8": _bools((9, 40, 40), 7).astype(np.uint8),
        "tensor": torch.as_tensor(_bools((11, 33, 8), 8)),
        "one_row": _bools((3, 2048), 9),  # a row larger than a chunk
    }[case]
    src_t = src if isinstance(src, torch.Tensor) else torch.from_numpy(src)
    before = _staged_count()
    got = engine._staged_upload(src_t, "cpu")
    rows = chunk_rows(src_t.shape)
    assert torch.equal(got, _plain(src, "cpu"))
    assert len(unpinned) == -(-src_t.shape[0] // rows)
    row = src_t[0].numel()
    assert all(n <= max(1024, row) for n in unpinned)
    assert sum(unpinned) == src_t.numel()
    assert _staged_count() == before + 1


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(case):
    """(host arrays, whether each stages) of a case."""
    if case == "below":
        return [_bools((engine.STAGE_MIN_BYTES - 1,), 10)], False
    if case == "at":
        return [_bools((engine.STAGE_MIN_BYTES // 32, 32), 11)], True
    if case == "64mib":
        return [_bools((512, 4096, 32), 12)], True
    if case == "ragged":
        return [_bools((3 * chunk_rows((1, 4096, 32)) + 5, 4096, 32), 13)], True
    if case == "view":
        return [_bools((64, 4096, 64), 14)[:, :, ::2]], True
    if case == "uint8":
        return [_bools((64, 4096, 32), 15).astype(np.uint8)], True
    if case == "tensor":
        return [torch.as_tensor(_bools((64, 4096, 32), 16))], True
    return [_bools((64, 4096, 32), 20 + i) for i in range(10)], True


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["below", "at", "64mib", "ragged", "view", "uint8",
                                  "tensor", "ten"])
def test_staged_upload_equals_the_plain_copy_on_card(cuda, case):
    """`as_dom` to the card equals ``torch.as_tensor(a).to("cuda")`` bit for
    bit: at `STAGE_MIN_BYTES` - 1 (plain), at it and at 64 MiB, a leading
    size the chunk does not divide, a strided numpy view, a uint8 0/1 array,
    a CPU tensor, and ten calls back to back on different arrays, each
    array overwritten as soon as its call returns. ``upload.staged`` ticks
    once a staged call and never below the threshold."""
    doms, staged = _card_case(case)
    wants = [_plain(d, "cpu").to(cuda) for d in doms]
    before = _staged_count()
    gots = []
    for dom in doms:
        gots.append(as_dom(dom, cuda))
        dom[...] = 0  # the caller reuses its array at once
    assert _staged_count() - before == (len(doms) if staged else 0)
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        assert got.dtype == torch.bool and got.device.type == "cuda"
        assert torch.equal(got, want)


def _production_net(device, n=4096, d=32):
    """A random packed network at the production CSP's shape (a symmetric
    mask of density 0.01, a random word, half the bits set), prepared as the
    fused packed engine's single-network payload."""
    g = torch.Generator(device=device).manual_seed(0)
    upper = (torch.rand((n, n), generator=g, device=device) < 0.005).triu(1)
    mask = (upper | upper.T).to(torch.uint8)
    cons = torch.randint(-2**31, 2**31, (n * d, n), generator=g, dtype=torch.int32,
                         device=device)
    eng = get_engine("hopper_packed", fixpoint="fused", device=device)
    root = torch.ones((n, d), dtype=torch.bool, device=device)
    return PreparedNetwork(eng, CSP(None, None, root), ((cons, mask), (n, d, 1)))


@pytest.mark.gpu
def test_enforce_batch_on_a_staged_batch_equals_the_plain_path_on_card(cuda):
    """`enforce_batch` of a fused packed engine at n=4096, d=32: 64 search
    nodes as a host array (8 MiB, staged) equal the same call on the batch
    already on the card (closure, verdicts, ``k``); a batch below the
    threshold is not staged and equals its own plain call."""
    prepared = _production_net(cuda)
    root = np.ones((4096, 32), dtype=bool)
    below = (engine.STAGE_MIN_BYTES - 1) // (4096 * 32)
    assert below >= 1
    for rows, staged in ((64, 1), (below, 0)):
        doms = gen.search_nodes(root, rows, seed=rows)
        before = _staged_count()
        got = prepared.enforce_batch(doms)
        assert _staged_count() - before == staged
        want = prepared.enforce_batch(torch.as_tensor(doms).to(cuda))
        assert _staged_count() - before == staged
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        assert int(got.n_recurrences.max()) > 0
