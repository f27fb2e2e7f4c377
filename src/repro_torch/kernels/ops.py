"""Wrappers binding the dense and bitpacked kernels into the RTAC fixpoint.

The counterpart of `repro.kernels.ops`. It handles the shape contract
between the algorithm (n vars × d values, any sizes) and the kernels
(padded, flattened, optionally bitpacked); the padding contract itself lives
in `repro_torch.core.engine`. Kernel coordinates (``kdims``) are (n_p, d_p)
for the dense u8 kernels and (n_p, d_p, W) for the packed ones.

This module owns two decisions; the engines (`engines.hopper`) only name
their kind and whether they are fused:

- which route a single network's fixpoint takes (`fixpoint_single`): one
  fused launch, the word loop (`packed_word_fixpoint`) or the host loop
  over the single-network revise; a revise's narrow or wide launch is
  `launch.single_wide`'s. The autotune hooks (`autotune.maybe_tune`) run
  here, before a dispatch, for both the single-network and the stacked
  kernels.
- the packed-word format: `pack_words` and `unpack_words` are its only
  encoder and decoder, for domains and networks alike.

Network preparation (pad + transpose [+ bitpack] of the O(n²d²) constraint
tensor, a chunk of x-rows at a time) is memoized per CSP identity and
device; `write_slot` does it into a slot of a stacked table in place,
memoizing nothing. The rows functions take the
slot tables and the row→slot map, never gathered networks: the kernels read
``tables[idx[r]]`` in place.
"""

from __future__ import annotations

import functools
import weakref

import torch

from repro_torch import faults, obs
from repro_torch.core import rtac
from repro_torch.core.csp import CSP
from repro_torch.core.engine import pad_dom, padded_shape
from . import autotune, bitpack_support, launch, rtac_support

Tensor = torch.Tensor


#: variable-axis multiple n is padded to (the reference's default tile)
N_MULT = 8
#: value-axis multiple d is padded to (the one place it is set)
D_MULT = 8

# (kind, n_mult, device, id(cons), id(mask)) -> (wref(cons), wref(mask), value)
_NETWORK_CACHE: dict = {}


def _cached(kind: str, csp: CSP, n_mult: int, device, build, memo: bool = True):
    if not memo:
        return build()
    key = (kind, n_mult, str(device), id(csp.cons), id(csp.mask))
    hit = _NETWORK_CACHE.get(key)
    if hit is not None and hit[0]() is csp.cons and hit[1]() is csp.mask:
        return hit[2]
    value = build()
    evict = lambda _ref: _NETWORK_CACHE.pop(key, None)
    _NETWORK_CACHE[key] = (weakref.ref(csp.cons, evict), weakref.ref(csp.mask, evict), value)
    return value


# ---------------------------------------------------------------------------
# The packed-word format
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _byte_weights(device: torch.device) -> Tensor:
    return torch.tensor([1 << q for q in range(8)], dtype=torch.uint8, device=device)


def _check_width(name: str, d_p: int, w: int) -> None:
    if d_p % 8 or not 0 < d_p <= 32 * w:
        raise ValueError(f"{name}: d_p={d_p} must be a positive multiple of 8 "
                         f"that W={w} words hold")


def pack_words(doms: Tensor) -> Tensor:
    """(..., d_p) bool -> (..., W) int32, W = ceil(d_p / 32): value j in bit
    j % 32 of word j // 32, the padding bits clear (`ref.pack_bits_ref`'s
    words). d_p must be a multiple of 8 (every padded shape's is, `D_MULT`):
    each run of 8 values is summed into one byte (the bits are distinct, so
    the sum is their OR), the bytes padded to 4·W and read as W
    little-endian words."""
    *lead, d_p = doms.shape
    w = -(-d_p // 32)
    _check_width("pack_words", d_p, w)
    runs = doms.contiguous().view(torch.uint8).view(*lead, d_p // 8, 8)
    by = (runs * _byte_weights(doms.device)).sum(dim=-1, dtype=torch.uint8)
    if d_p // 8 != 4 * w:
        by = torch.nn.functional.pad(by, (0, 4 * w - d_p // 8))
    return by.view(torch.int32)


def unpack_words(words: Tensor, d_p: int) -> Tensor:
    """The inverse of `pack_words`: (..., W) int32 -> (..., d_p) bool, d_p a
    multiple of 8 that the W words hold; bits past d_p are not read."""
    *lead, w = words.shape
    _check_width("unpack_words", d_p, w)
    runs = words.contiguous().view(torch.uint8)[..., :d_p // 8, None]
    return ((runs & _byte_weights(words.device)) != 0).view(*lead, d_p)


# ---------------------------------------------------------------------------
# Network preparation
# ---------------------------------------------------------------------------


def _mask_u8(csp: CSP, n_p: int, device) -> Tensor:
    """The (n, n) mask padded to (n_p, n_p) u8 on ``device``."""
    n = csp.mask.shape[0]
    mask = torch.zeros((n_p, n_p), dtype=torch.uint8, device=device)
    mask[:n, :n] = csp.mask
    return mask


def prepare_dense(csp: CSP, block_rx: int = N_MULT, block_ry: int = N_MULT, device=None,
                  memo: bool = True):
    """-> (network, dom_padded, (n_p, d_p)); network = (cons2 u8, mask u8) on
    ``device`` (default: the CSP's), memoized per CSP unless ``memo`` is
    False. ``cons2[x·d_p + a, y·d_p + b]`` is the padded (n_p, n_p, d_p,
    d_p) tensor transposed to (x, a, y, b). n pads as in `prepare_packed`."""
    faults.inject("kernel.launch", kernel="dense")
    device = csp.cons.device if device is None else torch.device(device)
    n_mult = max(block_rx, block_ry)
    n_p, d_p = padded_shape(*csp.dom.shape, n_mult, D_MULT)

    def build():
        out = torch.empty((n_p * d_p, n_p * d_p), dtype=torch.uint8, device=device)
        return dense_network(csp.cons, n_p, d_p, out), _mask_u8(csp, n_p, device)

    network = _cached("dense", csp, n_mult, device, build, memo)
    return network, pad_dom(csp.dom.to(device), n_p, d_p), (n_p, d_p)


#: network elements a chunk of `pack_network` or `dense_network` moves at
#: most, so its temporaries stay under 256 MiB at any n (one pass over the
#: production CSP's 16 GiB network would need 16 GiB more packed, and 32 GiB
#: more than its output dense)
_PACK_CHUNK = 1 << 25


def _network_chunks(cons: Tensor, n_p: int, d_p: int, device):
    """The (n, n, d, d) bool network padded to (n_p, n_p, d_p, d_p), as
    (x0, rows) chunks of x-rows on ``device``, each padded alone: padded
    pairs are unconstrained (zero blocks), so they never produce a
    violation, and no padded copy of the whole network is made."""
    n, d = cons.shape[0], cons.shape[-1]
    step = max(1, _PACK_CHUNK // (n_p * d_p * d_p))
    for x0 in range(0, n_p, step):
        part = cons[x0:x0 + step].to(device)
        if (n, d) != (n_p, d_p):
            rows = min(step, n_p - x0)
            padded = torch.zeros((rows, n_p, d_p, d_p), dtype=torch.bool, device=device)
            padded[:part.shape[0], :n, :d, :d] = part
            part = padded
        yield x0, part


def dense_network(cons: Tensor, n_p: int, d_p: int, out: Tensor) -> Tensor:
    """(n, n, d, d) bool -> ``out`` (n_p*d_p, n_p*d_p) u8: padded to (n_p,
    d_p) and transposed (x, y, a, b) -> (x, a, y, b) in chunks of x-rows."""
    rows = out.view(n_p, d_p, n_p, d_p)
    for x0, part in _network_chunks(cons, n_p, d_p, out.device):
        rows[x0:x0 + part.shape[0]] = part.permute(0, 2, 1, 3)
    return out


def pack_network(cons: Tensor, n_p: int, d_p: int, out: Tensor) -> Tensor:
    """(n, n, d, d) bool -> ``out`` (n_p*d_p, n_p*W) int32: padded to (n_p,
    d_p) and packed in chunks of x-rows."""
    rows = out.view(n_p, d_p, n_p, -(-d_p // 32))
    for x0, part in _network_chunks(cons, n_p, d_p, out.device):  # (x, y, a, W) -> (x, a, y, W)
        rows[x0:x0 + part.shape[0]] = pack_words(part).permute(0, 2, 1, 3)
    return out


def prepare_packed(csp: CSP, block_rx: int = N_MULT, block_ry: int = N_MULT, device=None,
                   memo: bool = True):
    """-> (network, dom_padded, (n_p, d_p, w)); network = (cons int32, mask u8)
    on ``device`` (default: the CSP's), memoized per CSP unless ``memo`` is
    False. n pads to a multiple
    of ``max(block_rx, block_ry)``, as the reference's ``prepare_packed`` does
    for its tiles; the engine always uses `N_MULT`."""
    faults.inject("kernel.launch", kernel="packed")
    device = csp.cons.device if device is None else torch.device(device)
    n_mult = max(block_rx, block_ry)
    n_p, d_p = padded_shape(*csp.dom.shape, n_mult, D_MULT)
    w = -(-d_p // 32)

    def build():
        out = torch.empty((n_p * d_p, n_p * w), dtype=torch.int32, device=device)
        return pack_network(csp.cons, n_p, d_p, out), _mask_u8(csp, n_p, device)

    network = _cached("packed", csp, n_mult, device, build, memo)
    return network, pad_dom(csp.dom.to(device), n_p, d_p), (n_p, d_p, w)


def write_slot(kind: str, csp: CSP, tables, slot: int) -> None:
    """``csp``'s padded network into slot ``slot`` of a Hopper engine's
    tables (``(C, n_p·d_p, n_p·d_p)`` u8 or ``(C, n_p·d_p, n_p·W)`` int32,
    and ``(C, n_p, n_p)`` u8 masks), packed or transposed there in place:
    no other copy of the network is made, or memoized. The slot's network
    equals `prepare_packed`'s or `prepare_dense`'s."""
    cons_t, mask_t = tables
    n_p = mask_t.shape[-1]
    d_p = cons_t.shape[1] // n_p
    if kind == "dense":
        dense_network(csp.cons, n_p, d_p, cons_t[slot])
    else:
        pack_network(csp.cons, n_p, d_p, cons_t[slot])
    mask_t[slot].copy_(_mask_u8(csp, n_p, mask_t.device))


# ---------------------------------------------------------------------------
# Assign + seed in kernel coordinates
# ---------------------------------------------------------------------------


def _padded_seed(var: Tensor, n: int, n_p: int) -> Tensor:
    """The Prop. 2 revision seed in padded coordinates: ``one_hot(var)`` for
    assigned rows, all real variables for root rows (``var < 0``); padded
    variables are never seeded."""
    ar = torch.arange(n_p, device=var.device)[None, :]
    is_root = (var < 0)[:, None]
    return torch.where(is_root, ar < n, ar == var.clamp(min=0)[:, None])


def assign_padded_rows(dom_p: Tensor, var: Tensor, val: Tensor) -> Tensor:
    """Batched Alg. 2 ``assign`` in kernel (padded) coordinates (the
    counterpart of `repro.kernels.rtac_support.assign_padded_rows`): row i's
    ``dom(var[i])`` collapses to ``{val[i]}``; ``var[i] < 0`` marks a root
    row, left untouched. ``var``/``val`` index caller coordinates."""
    r, _, d_p = dom_p.shape
    rows = torch.arange(r, device=dom_p.device)
    onehot = torch.arange(d_p, device=dom_p.device)[None, :] == val.long()[:, None]
    assigned = dom_p.clone()
    assigned[rows, var.clamp(min=0).long()] = onehot
    return torch.where((var < 0)[:, None, None], dom_p, assigned)


# ---------------------------------------------------------------------------
# One launch of a kernel on B padded rows
# ---------------------------------------------------------------------------


def _u8(t: Tensor) -> Tensor:
    return t.to(torch.uint8).contiguous()


def _idx32(idx: Tensor) -> Tensor:
    return idx.to(torch.int32).contiguous()


def _operands(kind: str, kdims: tuple, doms: Tensor):
    """(B, n_p, d_p) bool domains as ``kind``'s kernels read them, (B,
    n_p·d_p) u8 or (B, n_p·W) packed words, and the kernels' widths."""
    b = doms.shape[0]
    if kind == "dense":
        return _u8(doms).view(b, -1), dict(d=kdims[1])
    return pack_words(doms).view(b, -1), dict(d=kdims[1], w=kdims[2])


def revise_single(kind: str, kdims: tuple, network, dom: Tensor, changed: Tensor) -> Tensor:
    """B domains (B, n_p, d_p) against one network, one `dense_revise` /
    `packed_revise` launch; ``functools.partial(revise_single, kind,
    kdims)`` is an `rtac.ReviseFn`."""
    cons, mask = network
    rows, kw = _operands(kind, kdims, dom)
    revise = rtac_support.dense_revise if kind == "dense" else bitpack_support.packed_revise
    return revise(cons, mask, rows, _u8(changed), **kw).view(dom.shape).bool()


def revise_rows(kind: str, kdims: tuple, tables, idx: Tensor, doms: Tensor,
                changed: Tensor) -> Tensor:
    """R domains, row i against ``tables[idx[i]]``, one `*_revise_stacked`
    launch; ``functools.partial(revise_rows, kind, kdims)`` is an
    `rtac.ReviseRowsFn`."""
    cons_t, mask_t = tables
    rows, kw = _operands(kind, kdims, doms)
    revise = (rtac_support.dense_revise_stacked if kind == "dense"
              else bitpack_support.packed_revise_stacked)
    return revise(cons_t, mask_t, _idx32(idx), rows, _u8(changed), **kw).view(doms.shape).bool()


def fixpoint_rows(kind: str, kdims: tuple, tables, doms: Tensor, changed: Tensor,
                  idx: Tensor) -> rtac.EnforceResult:
    """R fixpoints, row i against ``tables[idx[i]]``, the whole recurrence in
    one `*_fixpoint_stacked` launch (the domains packed once on entry for
    the packed kind)."""
    cons_t, mask_t = tables
    rows, kw = _operands(kind, kdims, doms)
    fixpoint = (rtac_support.dense_fixpoint_stacked if kind == "dense"
                else bitpack_support.packed_fixpoint_stacked)
    dom, consistent, k = fixpoint(cons_t, mask_t, _idx32(idx), rows, _u8(changed), **kw)
    return rtac.EnforceResult(dom.view(doms.shape).bool(), consistent.bool(), k)


# ---------------------------------------------------------------------------
# The routes of a fixpoint
# ---------------------------------------------------------------------------


def dims(kind: str, n_p: int, d_p: int) -> tuple:
    """Kernel coordinates of a padded (n_p, d_p) shape: (n_p, d_p) for
    ``"dense"``, (n_p, d_p, W) for ``"packed"``."""
    return (n_p, d_p) if kind == "dense" else (n_p, d_p, -(-d_p // 32))


def single_fused(kind: str, n_p: int, d_p: int) -> bool:
    """Whether a fused engine's single-network path (``enforce`` /
    ``enforce_batch``) runs a call's fixpoint as one launch of the fused
    kernel on the padded (n_p, d_p) network, read as a one-slot table: where
    the kernel's CTA fits in shared memory and n_p is below
    `launch.SINGLE_WIDE_N`. From there the host loop's single-network revise
    takes the block route, which reads each constrained pair once for a
    group of rows; the fused kernel would read the network once a row. Where
    the fused CTA does not fit below it, the host loop's revise takes the
    block route too (`launch.single_wide`: the narrow CTA fits only to
    n_p = 384 at d_p = 40). The padded shape alone decides, on every device."""
    w = -(-d_p // 32)
    dom_bytes = 4 * n_p * w if kind == "packed" else n_p * d_p
    return (n_p < launch.SINGLE_WIDE_N
            and launch.fixpoint_smem(n_p, d_p, dom_bytes) <= launch.SMEM_OPT_IN_LIMIT)


#: recurrences the word loop enqueues between two reads of its predicate: a
#: `mac_solve` call at QWH's shape takes 1.57 on average, an
#: `enforce_batch` of 512 search nodes at the production CSP's 4.75
WORD_CHUNK = 2


def packed_word_fixpoint(network, dom_p: Tensor, ch_p: Tensor,
                         kdims: tuple) -> rtac.EnforceResult:
    """B padded rows' fixpoints against ONE packed network, the state kept
    on the card as packed words between recurrences: a fused engine's route
    where `single_fused` refuses the shape. The domains are packed once
    and unpacked once; each recurrence is one
    `packed_revise` launch (kernel 3, by the route `launch.single_wide`
    picks) and one `packed_word_epilogue` launch, which finds the active
    rows, applies their violations, writes the next seed and the verdicts
    and counts the rows still active, all on the card. Recurrences go in
    chunks of `WORD_CHUNK`, the count
    read once a chunk (one ``sync.wait``, in a ``fixpoint.chunk`` span). A
    recurrence past a row's fixpoint has a zero seed and changes nothing, so
    each row's closure, verdict and ``k`` equal the host loop's
    (`rtac._fixpoint_rows`) at any chunk length. The always-on counter
    ``fixpoint.spec_recurrences`` counts the recurrences launched past the
    call's ``max(k)``."""
    cons_p2, mask = network
    n_p, d_p, w = kdims
    b = dom_p.shape[0]
    words = pack_words(dom_p).view(b, n_p * w)
    # the seeds as given: the first epilogue ignores those of a row that
    # starts with an empty domain, and clears them
    seed = ch_p.to(torch.uint8, memory_format=torch.contiguous_format, copy=True)
    consistent = torch.empty(b, dtype=torch.uint8, device=dom_p.device)
    k = torch.zeros(b, dtype=torch.int32, device=dom_p.device)
    launched = needed = 0
    while True:
        with obs.span("fixpoint.chunk", cat="fixpoint", recurrences=WORD_CHUNK):
            counts = torch.zeros((WORD_CHUNK, 2), dtype=torch.int32, device=dom_p.device)
            for i in range(WORD_CHUNK):
                viol = bitpack_support.packed_revise(cons_p2, mask, words, seed, d=d_p, w=w)
                bitpack_support.packed_word_epilogue(words, viol, seed, consistent, k, counts[i],
                                                     d=d_p, w=w)
            with obs.sync_wait():
                got = counts.tolist()
        launched += WORD_CHUNK
        needed += sum(revised > 0 for revised, _ in got)
        if got[-1][1] == 0:
            break
    obs.counter_add("fixpoint.spec_recurrences", launched - needed)
    dom = unpack_words(words.view(b, n_p, w), d_p)
    return rtac.EnforceResult(dom, consistent.view(torch.bool), k)


def enforce_rows(kind: str, fused: bool, tables, dom_p: Tensor, ch_p: Tensor, idx: Tensor,
                 kdims: tuple) -> rtac.EnforceResult:
    """R fixpoints in kernel coordinates, row i against ``tables[idx[i]]``:
    one fused kernel launch, or the stepped host loop with one stacked revise
    launch per recurrence. Before it, `autotune.maybe_tune` (gated by
    ``REPRO_TORCH_AUTOTUNE=1``) tunes the bucket on first use."""
    autotune.maybe_tune(kind if fused else f"{kind}_revise", kdims[0], kdims[1],
                        autotune.entry_words(kind, kdims[1]), dom_p.shape[0],
                        device=dom_p.device)
    if fused:
        return fixpoint_rows(kind, kdims, tables, dom_p, ch_p, idx)
    return rtac.enforce_rows_generic(tables, dom_p, ch_p, idx,
                                     revise_rows_fn=functools.partial(revise_rows, kind, kdims))


def fixpoint_single(kind: str, fused: bool, network, dom_p: Tensor, ch_p: Tensor,
                    kdims: tuple) -> rtac.EnforceResult:
    """B padded rows (B, n_p, d_p) with their seeds (B, n_p) against ONE
    prepared network, by the route that ``kind``, ``fused`` and the padded
    shape pick: where `single_fused` holds on a fused engine, one launch of
    the fused kernel (`enforce_rows` on the network as a one-slot table,
    every row routed to slot 0); on another fused packed engine, the word
    loop (`packed_word_fixpoint`), one predicate read a chunk of
    recurrences; otherwise the host loop (`rtac.enforce_batch_generic`) over
    `revise_single`, one launch and one predicate read a recurrence. The
    always-on counters ``fixpoint.one_launch``, ``fixpoint.word_loop`` and
    ``fixpoint.host_loop`` tick once a call of each route. Before a revise's
    narrow launch, `autotune.maybe_tune` tunes its bucket (the wide launch
    has no schedule to tune)."""
    n_p, d_p = kdims[0], kdims[1]
    if fused and single_fused(kind, n_p, d_p):
        obs.counter_add("fixpoint.one_launch")
        cons, mask = network
        idx = torch.zeros(dom_p.shape[0], dtype=torch.int32, device=dom_p.device)
        return enforce_rows(kind, True, (cons[None], mask[None]), dom_p, ch_p, idx, kdims)
    if not launch.single_wide(n_p, d_p):
        autotune.maybe_tune(f"{kind}_single", n_p, d_p, autotune.entry_words(kind, d_p),
                            dom_p.shape[0], device=dom_p.device)
    if fused and kind == "packed":
        obs.counter_add("fixpoint.word_loop")
        return packed_word_fixpoint(network, dom_p, ch_p, kdims)
    obs.counter_add("fixpoint.host_loop")
    return rtac.enforce_batch_generic(network, dom_p, ch_p,
                                      revise_fn=functools.partial(revise_single, kind, kdims))


# ---------------------------------------------------------------------------
# Frontier entries (one round of the device frontier)
# ---------------------------------------------------------------------------


def _assign_enforce_rows(kind: str, fused: bool, tables, doms: Tensor, var: Tensor,
                         val: Tensor, idx: Tensor) -> rtac.EnforceResult:
    r, n, d = doms.shape
    n_p, d_p = padded_shape(n, d, N_MULT, D_MULT)
    dom_p = assign_padded_rows(pad_dom(doms, n_p, d_p), var, val)
    ch_p = _padded_seed(var, n, n_p)
    res = enforce_rows(kind, fused, tables, dom_p, ch_p, idx, dims(kind, n_p, d_p))
    return rtac.EnforceResult(res.dom[:, :n, :d], res.consistent, res.n_recurrences)


def frontier_fix(kind: str, fused: bool):
    """A Hopper engine's frontier round ``(tables, doms, var, val, idx)``:
    pad, the batched Alg. 2 assignment, the seed, then `enforce_rows`
    (one fused launch, or the stepped host loop of stacked revises)."""
    return functools.partial(_assign_enforce_rows, kind, fused)
