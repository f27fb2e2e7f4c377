"""Bitpacked RTAC kernels for Hopper, each beside its plain PyTorch version.

The counterpart of `repro.kernels.bitpack_support`. Networks are packed on
the value axis b into 32-bit words (held as ``int32`` with the reference's
uint32 bit patterns):

    cons[s, x·d + a, y·W + w]   int32,  W = ceil(d/32), one slot s per network
    has[x,a,y] = any_w(cons_word & dom_word) != 0  ∨  ¬mask[x,y]
    violated[x,a] = ∃y: seed[y] ∧ ¬has[x,a,y]

The stacked kernels take the slot TABLES and a row→slot map ``idx`` and read
each row's network in place — no per-round gathered copy of the networks:

- :func:`packed_revise_stacked` — one revise step for R rows, one CTA a row
  (``csrc/packed_revise.cu`` with ``csrc/revise_common.cuh``; the stepped
  fixpoint's revise);
- :func:`packed_fixpoint_stacked` — the whole incremental fixpoint of R rows
  in one launch (``csrc/packed_fixpoint.cu``; the fused default), a CTA a
  row, or a thread-block cluster a row where the rows leave most SMs idle
  (`launch.fixpoint_split`);
- :func:`packed_revise` — one revise step of B domains against ONE network
  (the single-network path of ``enforce``/``enforce_batch`` and so of
  ``mac_solve``): where a CTA owning a row fits, below n = 2048, a CTA
  per (row, span of variables) (``csrc/packed_revise.cu`` with
  ``csrc/revise_common.cuh``); elsewhere (`launch.single_wide`) the block
  revise's row groups on the network as it is (``csrc/block_revise.cuh``,
  value-major);
- :func:`packed_revise_block` — one revise step of B domains against an
  x-block of one network in the reference's pair-major layout
  ``(nx, n, d, W)``: this rank's rows of a sharded network against all n
  variables (the local revise of `repro_torch.core.sharded`), up to
  n = 65535 (``csrc/block_revise.cuh``, a CTA per (span of variables, group
  of 32 rows));
- :func:`packed_word_epilogue` — one recurrence's bookkeeping after a
  `packed_revise` launch in the word loop (`ops.packed_word_fixpoint`):
  the violations applied to the active rows' words in place, the next seed,
  the verdicts, ``k`` and a device count of the rows left to revise
  (``csrc/word_epilogue.cu``, a CTA a row).

Device rule: a wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches its kernel or raises — it never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import autotune
from .launch import (SPLIT_MAX, block_scratch_bytes, check_block, check_operands, check_smem,
                     check_wide, fixpoint_smem, fixpoint_split, launch, revise_smem,
                     single_wide, sm_count, split_clusters)
from .ref import pack_bits_ref, unpack_bits_ref

Tensor = torch.Tensor


def _check(cons: Tensor, mask: Tensor, idx: Optional[Tensor], dom_words: Tensor,
           changed: Tensor, d: int, w: int, block: bool = False):
    """Validate the packed kernels' operands (``idx`` None: one network;
    ``block``: an x-block of one); returns (rows, n), or (rows, nx, n)."""
    if w != -(-d // 32):
        raise ValueError(f"W={w} != ceil({d}/32)")
    return check_operands(cons, mask, idx, dom_words, changed, d=d, cols=w, word=torch.int32,
                          block=block)


#: words of network a chunk of the plain single-network and block revises
#: covers at most, so their temporaries stay near a gigabyte at any n
_NET_CHUNK_WORDS = 1 << 28


def _revise_chunk_rows(n: int, d: int, w: int, nx: Optional[int] = None) -> int:
    """Rows per chunk of the plain revise (bounds its gathered working set)."""
    return max(1, (1 << 28) // ((n if nx is None else nx) * d * n * w * 4))


def _revise_rows_plain(net: Tensor, mask: Tensor, dom_words: Tensor, changed: Tensor,
                       n: int, d: int, w: int) -> Tensor:
    """violated (rows, nx·d) u8 of ``rows`` domains against ``net`` (rows or
    1, nx·d, n·W) with ``mask`` (rows or 1, nx, n); nx = n for a whole
    network."""
    rows, nx = dom_words.shape[0], mask.shape[-2]
    net = net.view(-1, nx, d, n, w)  # (rows, x, a, y, w)
    has = ((net & dom_words.view(rows, 1, 1, n, w)) != 0).any(dim=-1)  # (rows, x, a, y)
    has |= mask.bool()[:, :, None, :].logical_not()
    seed = changed.bool()[:, None, None, :]
    return (seed & ~has).any(dim=-1).view(rows, nx * d).to(torch.uint8)


# ---------------------------------------------------------------------------
# One revise step (stepped fixpoint)
# ---------------------------------------------------------------------------


def packed_revise_stacked_plain(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                                changed: Tensor, *, d: int, w: int) -> Tensor:
    """Plain PyTorch version of `packed_revise_stacked` (same operands, same
    result), gathering row networks in chunks."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    step = _revise_chunk_rows(n, d, w)
    for s in range(0, r, step):
        ii = idx[s:s + step].long()
        out[s:s + step] = _revise_rows_plain(cons[ii], mask[ii], dom_words[s:s + step],
                                             changed[s:s + step], n, d, w)
    return out


def packed_revise_stacked(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                          changed: Tensor, *, d: int, w: int,
                          sched: Optional[int] = None) -> Tensor:
    """R packed revisions, row r against network ``cons[idx[r]]``.

    cons (C, n·d, n·W) int32, mask (C, n, n) u8, idx (R,) int32,
    dom_words (R, n·W) int32, changed (R, n) u8 -> violated (R, n·d) u8.
    ``sched`` (CUDA only) is a launch schedule: 0 the width compiled as a
    constant, 1 the run-time width; None takes the tuned one of the shape's
    bucket, or the default (`autotune.schedule`)."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    if cons.device.type == "cpu":
        return packed_revise_stacked_plain(cons, mask, idx, dom_words, changed, d=d, w=w)
    check_smem("packed_revise_stacked", revise_smem(n, d, 4 * n * w), f"n={n}, d={d}")
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    if r:
        if sched is None:
            sched = autotune.schedule("packed_revise", n, d, w, r)
        launch("packed_revise", "packed_revise_stacked_launch",
               [cons, mask, idx, dom_words, changed, out], r, n, d, w, sched=sched)
        packed_revise_stacked.launches += 1
    return out


packed_revise_stacked.launches = 0


# ---------------------------------------------------------------------------
# The fused fixpoint (one launch per round)
# ---------------------------------------------------------------------------


def packed_fixpoint_stacked_plain(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                                  changed: Tensor, *, d: int, w: int,
                                  seeds_out: Optional[list] = None):
    """Plain PyTorch version of `packed_fixpoint_stacked`: the same per-row
    recurrence as a host loop over `packed_revise_stacked_plain` sweeps.
    ``seeds_out``, if a list, receives each sweep's (R, n) seed — what a
    caller needs to count the work these inputs require."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    words = dom_words.view(r, n, w)
    consistent = (words != 0).any(dim=-1).all(dim=-1)
    ch = changed.bool() & consistent[:, None]
    k = torch.zeros(r, dtype=torch.int32, device=cons.device)
    while True:
        active = consistent & ch.any(dim=-1)
        if not bool(active.any()):
            break
        seed = ch & active[:, None]
        if seeds_out is not None:
            seeds_out.append(seed)
        viol = packed_revise_stacked_plain(
            cons, mask, idx, words.reshape(r, n * w).contiguous(),
            seed.to(torch.uint8), d=d, w=w,
        )
        new = words & ~pack_bits_ref(viol.view(r, n, d).bool())
        ch = (new != words).any(dim=-1)
        consistent = consistent & (new != 0).any(dim=-1).all(dim=-1)
        k += active.to(torch.int32)
        words = new
    dom = unpack_bits_ref(words, d).reshape(r, n * d).to(torch.uint8)
    return dom, consistent.to(torch.uint8), k


def _split(device: torch.device, r: int, n: int, d: int, w: int) -> int:
    """The CTAs a row of a launch of ``r`` rows takes on ``device``:
    `launch.fixpoint_split` on the card's SMs, or 1 where the card holds
    no cluster of that many (`launch.split_clusters`)."""
    c = fixpoint_split(r, n, sm_count(device))
    return c if c == 1 or split_clusters(device, n, d, w, c) > 0 else 1


def packed_fixpoint_stacked(cons: Tensor, mask: Tensor, idx: Tensor, dom_words: Tensor,
                            changed: Tensor, *, d: int, w: int,
                            sched: Optional[int] = None, split: Optional[int] = None):
    """R packed fixpoints in ONE launch, row r against ``cons[idx[r]]``.

    Operands as `packed_revise_stacked` (``changed`` is the Prop. 2 seed,
    assignment already applied to ``dom_words``). Returns (dom (R, n·d) u8
    unpacked, consistent (R,) u8, k (R,) int32) — per row bit-identical to
    the stepped fixpoint. ``sched`` as for `packed_revise_stacked`.

    ``split`` (CUDA only) is the CTAs a row takes, 1 to `launch.SPLIT_MAX`;
    None takes `launch.fixpoint_split`'s on this card (the engines always
    do). A row split over c > 1 CTAs runs the instantiation that reads W at
    run time whatever ``sched`` says, and ticks the always-on counter
    ``fixpoint.split_launches``."""
    r, n = _check(cons, mask, idx, dom_words, changed, d, w)
    if split is not None and not 1 <= split <= SPLIT_MAX:
        raise ValueError(f"packed_fixpoint_stacked: split={split} is not in 1..{SPLIT_MAX}")
    if cons.device.type == "cpu":
        return packed_fixpoint_stacked_plain(cons, mask, idx, dom_words, changed, d=d, w=w)
    check_smem("packed_fixpoint_stacked", fixpoint_smem(n, d, 4 * n * w), f"n={n}, d={d}")
    dom = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    consistent = torch.empty((r,), dtype=torch.uint8, device=cons.device)
    k = torch.empty((r,), dtype=torch.int32, device=cons.device)
    if r:
        tensors = [cons, mask, idx, dom_words, changed, dom, consistent, k]
        c = _split(cons.device, r, n, d, w) if split is None else split
        if c > 1:
            check_smem("packed_fixpoint_stacked", fixpoint_smem(n, d, 4 * n * w, split=c),
                       f"n={n}, d={d}, split={c}")
            launch("packed_fixpoint", "packed_fixpoint_split_launch", tensors, r, n, d, w, c)
            obs.counter_add("fixpoint.split_launches")
        else:
            if sched is None:
                sched = autotune.schedule("packed", n, d, w, r)
            launch("packed_fixpoint", "packed_fixpoint_stacked_launch", tensors, r, n, d, w,
                   sched=sched)
        packed_fixpoint_stacked.launches += 1
    return dom, consistent, k


packed_fixpoint_stacked.launches = 0


# ---------------------------------------------------------------------------
# One revise step against one network (the single-network path)
# ---------------------------------------------------------------------------


def packed_revise_plain(cons: Tensor, mask: Tensor, dom_words: Tensor, changed: Tensor, *,
                        d: int, w: int) -> Tensor:
    """Plain PyTorch version of `packed_revise`, in chunks of x-rows and of
    domains."""
    b, n = _check(cons, mask, None, dom_words, changed, d, w)
    out = torch.empty((b, n, d), dtype=torch.uint8, device=cons.device)
    xs = max(1, _NET_CHUNK_WORDS // (d * n * w))
    for x0 in range(0, n, xs):
        net, m = cons[x0 * d:(x0 + xs) * d][None], mask[x0:x0 + xs][None]
        step = _revise_chunk_rows(n, d, w, m.shape[1])
        for s in range(0, b, step):
            out[s:s + step, x0:x0 + xs] = _revise_rows_plain(
                net, m, dom_words[s:s + step], changed[s:s + step], n, d, w).view(-1, m.shape[1], d)
    return out.view(b, n * d)


def packed_revise(cons: Tensor, mask: Tensor, dom_words: Tensor, changed: Tensor, *,
                  d: int, w: int,
                  sched: Optional[int] = None) -> Tensor:
    """B packed revisions against ONE network (the reference vmaps its
    single-network kernel over B).

    cons (n·d, n·W) int32, mask (n, n) u8, dom_words (B, n·W) int32,
    changed (B, n) u8 -> violated (B, n·d) u8. ``sched`` (CUDA only) is the
    variables a CTA revises, a multiple of 8 (0: the default rule); None
    takes the tuned one of the shape's bucket, or the default. Where
    `launch.single_wide` says so (from n = 2048, or where a narrow CTA owning
    a row would not fit in shared memory) the call is the block revise's on
    the whole network in this layout (a seed pass into a scratch tensor,
    then the revise), which takes no span: ``sched`` must be None or 0. The
    always-on counters ``revise.narrow`` and ``revise.wide`` tick once a
    launch of each route."""
    b, n = _check(cons, mask, None, dom_words, changed, d, w)
    if cons.device.type == "cpu":
        return packed_revise_plain(cons, mask, dom_words, changed, d=d, w=w)
    out = torch.empty((b, n * d), dtype=torch.uint8, device=cons.device)
    if single_wide(n, d):
        check_wide("packed_revise", b, n, sched)
        if b:
            scratch = torch.empty(block_scratch_bytes(b, n, 4 * w), dtype=torch.uint8,
                                  device=cons.device)
            launch("packed_revise", "packed_revise_wide_launch",
                   [cons, mask, dom_words, changed, scratch, out], b, n, d, w)
            packed_revise.launches += 1
            obs.counter_add("revise.wide")
        return out
    if b:
        if sched is None:
            sched = autotune.schedule("packed_single", n, d, w, b)
        launch("packed_revise", "packed_revise_launch", [cons, mask, dom_words, changed, out],
               b, n, d, w, sched=sched)
        packed_revise.launches += 1
        obs.counter_add("revise.narrow")
    return out


packed_revise.launches = 0


# ---------------------------------------------------------------------------
# The word loop's epilogue (after each `packed_revise` of the loop)
# ---------------------------------------------------------------------------


def packed_word_epilogue_plain(words: Tensor, viol: Tensor, seed: Tensor, consistent: Tensor,
                               k: Tensor, counts: Tensor, *, d: int, w: int) -> None:
    """Plain PyTorch version of `packed_word_epilogue`, in place on the same
    operands."""
    b, n = seed.shape
    old = words.view(b, n, w)
    alive0 = (old != 0).any(dim=-1).all(dim=-1)
    act = seed.bool().any(dim=-1) & alive0
    new = torch.where(act[:, None, None], old & ~pack_bits_ref(viol.view(b, n, d).bool()), old)
    changed = (new != old).any(dim=-1)
    alive = (new != 0).any(dim=-1).all(dim=-1)
    nxt = act & alive & changed.any(dim=-1)
    k += act.to(torch.int32)
    consistent.copy_(alive)
    counts += torch.stack([act.sum(), nxt.sum()]).to(torch.int32)
    seed.copy_(changed & nxt[:, None])
    words.copy_(new.view(b, n * w))


def packed_word_epilogue(words: Tensor, viol: Tensor, seed: Tensor, consistent: Tensor,
                         k: Tensor, counts: Tensor, *, d: int, w: int) -> None:
    """One recurrence's bookkeeping after a `packed_revise` launch of the
    word loop, in place. A row is active iff it has a seed and no empty
    domain. An active row's words lose the values ``viol`` marks, ``seed``
    becomes the variables whose domains changed (zero once the row is no
    longer active: wiped out, or nothing changed), ``k`` counts the
    recurrence; any other row keeps its words and ``k`` and gets a zero
    seed. ``consistent`` becomes whether no domain of the row is empty, and
    ``counts`` gains (rows revised, rows still active). Row for row the host
    loop's recurrence (`rtac._fixpoint_rows`), its first seeds those given.

    words (B, n·W) int32, viol (B, n·d) u8, seed (B, n) u8, consistent (B,)
    u8, k (B,) int32, counts (2,) int32; d a multiple of 8.
    """
    b, n = seed.shape
    expect = ((words, torch.int32, (b, n * w)), (viol, torch.uint8, (b, n * d)),
              (consistent, torch.uint8, (b,)), (k, torch.int32, (b,)),
              (counts, torch.int32, (2,)))
    if seed.dtype != torch.uint8 or d % 8 or w != -(-d // 32) or any(
            t.dtype != dtype or t.shape != shape or t.device != seed.device
            or not t.is_contiguous() for t, dtype, shape in expect):
        raise ValueError(f"packed_word_epilogue: operands do not fit B={b}, n={n}, d={d}, W={w}")
    if seed.device.type == "cpu":
        return packed_word_epilogue_plain(words, viol, seed, consistent, k, counts, d=d, w=w)
    if b:
        launch("word_epilogue", "packed_word_epilogue_launch",
               [words, viol, seed, consistent, k, counts], b, n, d, w)
        packed_word_epilogue.launches += 1
    return None


packed_word_epilogue.launches = 0


# ---------------------------------------------------------------------------
# One revise step against an x-block of one network (the sharded path)
# ---------------------------------------------------------------------------

def packed_revise_block_plain(cons: Tensor, mask: Tensor, dom_words: Tensor, changed: Tensor,
                              *, d: int, w: int) -> Tensor:
    """Plain PyTorch version of `packed_revise_block`, in chunks of x-rows
    and of domains."""
    b, nx, n = _check(cons, mask, None, dom_words, changed, d, w, block=True)
    out = torch.empty((b, nx, d), dtype=torch.uint8, device=cons.device)
    xs = max(1, _NET_CHUNK_WORDS // (d * n * w))
    dom = dom_words.view(b, 1, n, 1, w)
    seed = changed.bool().view(b, 1, n, 1)
    for x0 in range(0, nx, xs):
        net, m = cons[x0:x0 + xs], mask[x0:x0 + xs].bool()[None, :, :, None]
        step = _revise_chunk_rows(n, d, w, net.shape[0])
        for s in range(0, b, step):
            has = ((net & dom[s:s + step]) != 0).any(dim=-1) | ~m  # (rows, x, y, a)
            out[s:s + step, x0:x0 + xs] = (seed[s:s + step] & ~has).any(dim=2)
    return out.view(b, nx * d)


def packed_revise_block(cons: Tensor, mask: Tensor, dom_words: Tensor, changed: Tensor, *,
                        d: int, w: int) -> Tensor:
    """B packed revisions against an x-block of ONE network: the rows of
    nx variables against all n (one rank's share of a network sharded over
    its variables), in the reference's pair-major layout.

    cons (nx, n, d, W) int32, mask (nx, n) u8, dom_words (B, n·W) int32,
    changed (B, n) u8 -> violated (B, nx·d) u8. Two launches: a seed pass
    into a scratch tensor of ``block_scratch_bytes``, then the revise."""
    b, nx, n = _check(cons, mask, None, dom_words, changed, d, w, block=True)
    if cons.device.type == "cpu":
        return packed_revise_block_plain(cons, mask, dom_words, changed, d=d, w=w)
    check_block("packed_revise_block", b, n)
    out = torch.empty((b, nx * d), dtype=torch.uint8, device=cons.device)
    if b and nx:
        scratch = torch.empty(block_scratch_bytes(b, n, 4 * w), dtype=torch.uint8,
                              device=cons.device)
        launch("packed_revise", "packed_block_revise_launch",
               [cons, mask, dom_words, changed, scratch, out], b, nx, n, d, w)
        packed_revise_block.launches += 1
    return out


packed_revise_block.launches = 0


def reset_launches() -> None:
    """Zero every wrapper's launch count."""
    packed_revise_stacked.launches = 0
    packed_fixpoint_stacked.launches = 0
    packed_revise.launches = 0
    packed_revise_block.launches = 0
    packed_word_epilogue.launches = 0

