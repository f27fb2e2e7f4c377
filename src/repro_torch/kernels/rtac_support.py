"""Dense u8 RTAC kernels for Hopper, each beside its plain PyTorch version.

The counterpart of `repro.kernels.rtac_support`. A network is the padded
(n, n, d, d) constraint tensor viewed as one byte per constraint bit,

    cons2[s, x·d + a, y·d + b]   u8 0/1, one slot s per network
    has[x,a,y] = any_b(cons2[x·d+a, y·d+b] & dom[y·d+b]) != 0  ∨  ¬mask[x,y]
    violated[x,a] = ∃y: seed[y] ∧ ¬has[x,a,y]

(the reference sums the ANDed bytes and tests the count > 0; the test is the
same). The stacked kernels take the slot TABLES and a row→slot map ``idx``
and read each row's network in place — no per-round gathered copy:

- :func:`dense_revise_stacked` — one revise step for R rows, one CTA a row
  (``csrc/dense_revise.cu`` with ``csrc/revise_common.cuh``; the stepped
  fixpoint's revise);
- :func:`dense_fixpoint_stacked` — the whole incremental fixpoint of R rows
  in one launch (``csrc/dense_fixpoint.cu``; the fused default);
- :func:`dense_revise` — one revise step of B domains against ONE network
  (the single-network path of ``enforce``/``enforce_batch`` and so of
  ``mac_solve``): where a CTA owning a row fits, below n = 2048, a CTA
  per (row, span of variables) (``csrc/dense_revise.cu`` with
  ``csrc/revise_common.cuh``); elsewhere (`launch.single_wide`) the block
  revise's row groups on the network as it is (``csrc/block_revise.cuh``,
  value-major);
- :func:`dense_revise_block` — one revise step of B domains against an
  x-block of one network in the reference's pair-major layout
  ``(nx, n, d, d)``: this rank's rows of a sharded network against all n
  variables (the u8 local revise of `repro_torch.core.sharded`;
  ``csrc/block_revise.cuh``).

The kernels read each (x·a, y) slice as d/8 eight-byte words, so d must be a
multiple of 8 (`ops.D_MULT`) and cons/dom 8-byte aligned.

Device rule: a wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches its kernel or raises — it never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import autotune
from .launch import (block_scratch_bytes, check_block, check_operands, check_smem, check_wide,
                     fixpoint_smem, launch, revise_smem, single_wide)

Tensor = torch.Tensor

#: value-axis words the kernels read: d must be a multiple of this
_WORD_BYTES = 8


def _check(cons: Tensor, mask: Tensor, idx: Optional[Tensor], dom: Tensor, changed: Tensor,
           d: int, block: bool = False):
    """Validate the dense kernels' operands (``idx`` None: one network;
    ``block``: an x-block of one); returns (rows, n), or (rows, nx, n)."""
    if d % _WORD_BYTES:
        raise ValueError(f"d={d} is not a multiple of {_WORD_BYTES}")
    dims = check_operands(cons, mask, idx, dom, changed, d=d, cols=d, word=torch.uint8,
                          block=block)
    for name, t in (("cons", cons), ("dom", dom)):
        if t.data_ptr() % _WORD_BYTES:
            raise ValueError(f"{name} must be {_WORD_BYTES}-byte aligned")
    return dims


#: network bytes a chunk of the plain single-network and block revises
#: covers at most
_NET_CHUNK_BYTES = 1 << 28


def _revise_chunk_rows(n: int, d: int, nx: Optional[int] = None) -> int:
    """Rows per chunk of the plain revise (bounds its gathered working set:
    one (n·d, n·d) u8 network is 17.3 MB at n=104, d=40)."""
    return max(1, (1 << 28) // ((n if nx is None else nx) * d * n * d))


def _revise_rows_plain(net: Tensor, mask: Tensor, dom: Tensor, changed: Tensor,
                       n: int, d: int) -> Tensor:
    """violated (rows, nx·d) u8 of ``rows`` domains against ``net`` (rows or
    1, nx·d, n·d) with ``mask`` (rows or 1, nx, n); nx = n for a whole
    network."""
    rows, nx = dom.shape[0], mask.shape[-2]
    # an entry's d bytes as d/8 eight-byte words, as the kernels read them:
    # some byte of the AND is nonzero iff some word is
    net = net.view(-1, nx, d, n, d).view(torch.int64)  # (rows, x, a, y, d/8)
    dom = dom.view(rows, 1, 1, n, d).view(torch.int64)
    has = ((net & dom) != 0).any(dim=-1)  # (rows, x, a, y)
    has |= mask.bool()[:, :, None, :].logical_not()
    seed = changed.bool()[:, None, None, :]
    return (seed & ~has).any(dim=-1).view(rows, nx * d).to(torch.uint8)


# ---------------------------------------------------------------------------
# One revise step (stepped fixpoint)
# ---------------------------------------------------------------------------


def dense_revise_stacked_plain(cons: Tensor, mask: Tensor, idx: Tensor, dom: Tensor,
                               changed: Tensor, *, d: int) -> Tensor:
    """Plain PyTorch version of `dense_revise_stacked` (same operands, same
    result), gathering row networks in chunks."""
    r, n = _check(cons, mask, idx, dom, changed, d)
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    step = _revise_chunk_rows(n, d)
    for s in range(0, r, step):
        ii = idx[s:s + step].long()
        out[s:s + step] = _revise_rows_plain(cons[ii], mask[ii], dom[s:s + step],
                                             changed[s:s + step], n, d)
    return out


def dense_revise_stacked(cons: Tensor, mask: Tensor, idx: Tensor, dom: Tensor,
                         changed: Tensor, *, d: int,
                         sched: Optional[int] = None) -> Tensor:
    """R dense revisions, row r against network ``cons[idx[r]]``.

    cons (C, n·d, n·d) u8, mask (C, n, n) u8, idx (R,) int32,
    dom (R, n·d) u8, changed (R, n) u8 -> violated (R, n·d) u8. ``sched``
    (CUDA only) is a launch schedule: 0 the width compiled as a constant, 1
    the run-time width; None takes the tuned one of the shape's bucket, or
    the default (`autotune.schedule`)."""
    r, n = _check(cons, mask, idx, dom, changed, d)
    if cons.device.type == "cpu":
        return dense_revise_stacked_plain(cons, mask, idx, dom, changed, d=d)
    check_smem("dense_revise_stacked", revise_smem(n, d, n * d), f"n={n}, d={d}")
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    if r:
        if sched is None:
            sched = autotune.schedule("dense_revise", n, d, 0, r)
        launch("dense_revise", "dense_revise_stacked_launch",
               [cons, mask, idx, dom, changed, out], r, n, d, sched=sched)
        dense_revise_stacked.launches += 1
    return out


dense_revise_stacked.launches = 0


# ---------------------------------------------------------------------------
# The fused fixpoint (one launch per round)
# ---------------------------------------------------------------------------


def dense_fixpoint_stacked_plain(cons: Tensor, mask: Tensor, idx: Tensor, dom: Tensor,
                                 changed: Tensor, *, d: int,
                                 seeds_out: Optional[list] = None):
    """Plain PyTorch version of `dense_fixpoint_stacked`: the same per-row
    recurrence as a host loop over `dense_revise_stacked_plain` sweeps.
    ``seeds_out``, if a list, receives each sweep's (R, n) seed — what a
    caller needs to count the work these inputs require."""
    r, n = _check(cons, mask, idx, dom, changed, d)
    cur = dom.view(r, n, d)
    consistent = (cur != 0).any(dim=-1).all(dim=-1)
    ch = changed.bool() & consistent[:, None]
    k = torch.zeros(r, dtype=torch.int32, device=cons.device)
    while True:
        active = consistent & ch.any(dim=-1)
        if not bool(active.any()):
            break
        seed = ch & active[:, None]
        if seeds_out is not None:
            seeds_out.append(seed)
        viol = dense_revise_stacked_plain(cons, mask, idx, cur.reshape(r, n * d).contiguous(),
                                          seed.to(torch.uint8), d=d)
        new = cur & ~viol.view(r, n, d)
        ch = (new != cur).any(dim=-1)
        consistent = consistent & (new != 0).any(dim=-1).all(dim=-1)
        k += active.to(torch.int32)
        cur = new
    return cur.reshape(r, n * d).contiguous(), consistent.to(torch.uint8), k


def dense_fixpoint_stacked(cons: Tensor, mask: Tensor, idx: Tensor, dom: Tensor,
                           changed: Tensor, *, d: int,
                           sched: Optional[int] = None):
    """R dense fixpoints in ONE launch, row r against ``cons[idx[r]]``.

    Operands as `dense_revise_stacked` (``changed`` is the Prop. 2 seed,
    assignment already applied to ``dom``). Returns (dom (R, n·d) u8,
    consistent (R,) u8, k (R,) int32) — per row bit-identical to the stepped
    fixpoint. ``sched`` as for `dense_revise_stacked`."""
    r, n = _check(cons, mask, idx, dom, changed, d)
    if cons.device.type == "cpu":
        return dense_fixpoint_stacked_plain(cons, mask, idx, dom, changed, d=d)
    check_smem("dense_fixpoint_stacked", fixpoint_smem(n, d, n * d), f"n={n}, d={d}")
    out = torch.empty((r, n * d), dtype=torch.uint8, device=cons.device)
    consistent = torch.empty((r,), dtype=torch.uint8, device=cons.device)
    k = torch.empty((r,), dtype=torch.int32, device=cons.device)
    if r:
        if sched is None:
            sched = autotune.schedule("dense", n, d, 0, r)
        launch("dense_fixpoint", "dense_fixpoint_stacked_launch",
               [cons, mask, idx, dom, changed, out, consistent, k], r, n, d, sched=sched)
        dense_fixpoint_stacked.launches += 1
    return out, consistent, k


dense_fixpoint_stacked.launches = 0


# ---------------------------------------------------------------------------
# One revise step against one network (the single-network path)
# ---------------------------------------------------------------------------


def dense_revise_plain(cons: Tensor, mask: Tensor, dom: Tensor, changed: Tensor, *,
                       d: int) -> Tensor:
    """Plain PyTorch version of `dense_revise`, in chunks of x-rows and of
    domains."""
    b, n = _check(cons, mask, None, dom, changed, d)
    out = torch.empty((b, n, d), dtype=torch.uint8, device=cons.device)
    xs = max(1, _NET_CHUNK_BYTES // (d * n * d))
    for x0 in range(0, n, xs):
        net, m = cons[x0 * d:(x0 + xs) * d][None], mask[x0:x0 + xs][None]
        step = _revise_chunk_rows(n, d, m.shape[1])
        for s in range(0, b, step):
            out[s:s + step, x0:x0 + xs] = _revise_rows_plain(
                net, m, dom[s:s + step], changed[s:s + step], n, d).view(-1, m.shape[1], d)
    return out.view(b, n * d)


def dense_revise(cons: Tensor, mask: Tensor, dom: Tensor, changed: Tensor, *,
                 d: int,
                 sched: Optional[int] = None) -> Tensor:
    """B dense revisions against ONE network (the reference vmaps its
    single-network kernel over B).

    cons (n·d, n·d) u8, mask (n, n) u8, dom (B, n·d) u8, changed (B, n) u8
    -> violated (B, n·d) u8. ``sched`` (CUDA only) is the variables a CTA
    revises, a multiple of 8 (0: the default rule); None takes the tuned one
    of the shape's bucket, or the default. Where `launch.single_wide` says
    so (from n = 2048, or where a narrow CTA owning a row would not fit in
    shared memory) the call is the block revise's on the whole network in
    this layout (a seed pass into a scratch tensor, then the revise), which
    takes no span: ``sched`` must be None or 0. The always-on counters
    ``revise.narrow`` and ``revise.wide`` tick once a launch of each
    route."""
    b, n = _check(cons, mask, None, dom, changed, d)
    if cons.device.type == "cpu":
        return dense_revise_plain(cons, mask, dom, changed, d=d)
    out = torch.empty((b, n * d), dtype=torch.uint8, device=cons.device)
    if single_wide(n, d):
        check_wide("dense_revise", b, n, sched)
        if b:
            scratch = torch.empty(block_scratch_bytes(b, n, d), dtype=torch.uint8,
                                  device=cons.device)
            launch("dense_revise", "dense_revise_wide_launch",
                   [cons, mask, dom, changed, scratch, out], b, n, d)
            dense_revise.launches += 1
            obs.counter_add("revise.wide")
        return out
    if b:
        if sched is None:
            sched = autotune.schedule("dense_single", n, d, 0, b)
        launch("dense_revise", "dense_revise_launch", [cons, mask, dom, changed, out], b, n, d,
               sched=sched)
        dense_revise.launches += 1
        obs.counter_add("revise.narrow")
    return out


dense_revise.launches = 0


# ---------------------------------------------------------------------------
# One revise step against an x-block of one network (the sharded path)
# ---------------------------------------------------------------------------

def dense_revise_block_plain(cons: Tensor, mask: Tensor, dom: Tensor, changed: Tensor, *,
                             d: int) -> Tensor:
    """Plain PyTorch version of `dense_revise_block`, in chunks of x-rows
    and of domains."""
    b, nx, n = _check(cons, mask, None, dom, changed, d, block=True)
    out = torch.empty((b, nx, d), dtype=torch.uint8, device=cons.device)
    xs = max(1, _NET_CHUNK_BYTES // (d * n * d))
    dom = dom.view(b, 1, n, 1, d)
    seed = changed.bool().view(b, 1, n, 1)
    for x0 in range(0, nx, xs):
        net, m = cons[x0:x0 + xs], mask[x0:x0 + xs].bool()[None, :, :, None]
        step = _revise_chunk_rows(n, d, net.shape[0])
        for s in range(0, b, step):
            has = ((net & dom[s:s + step]) != 0).any(dim=-1) | ~m  # (rows, x, y, a)
            out[s:s + step, x0:x0 + xs] = (seed[s:s + step] & ~has).any(dim=2)
    return out.view(b, nx * d)


def dense_revise_block(cons: Tensor, mask: Tensor, dom: Tensor, changed: Tensor, *,
                       d: int) -> Tensor:
    """B dense revisions against an x-block of ONE network: the rows of nx
    variables against all n (one rank's share of a network sharded over its
    variables), in the reference's pair-major layout.

    cons (nx, n, d, d) u8, mask (nx, n) u8, dom (B, n·d) u8, changed (B, n)
    u8 -> violated (B, nx·d) u8. Two launches: a seed pass into a scratch
    tensor of ``block_scratch_bytes``, then the revise."""
    b, nx, n = _check(cons, mask, None, dom, changed, d, block=True)
    if cons.device.type == "cpu":
        return dense_revise_block_plain(cons, mask, dom, changed, d=d)
    check_block("dense_revise_block", b, n)
    out = torch.empty((b, nx * d), dtype=torch.uint8, device=cons.device)
    if b and nx:
        scratch = torch.empty(block_scratch_bytes(b, n, d), dtype=torch.uint8, device=cons.device)
        launch("dense_revise", "dense_block_revise_launch",
               [cons, mask, dom, changed, scratch, out], b, nx, n, d)
        dense_revise_block.launches += 1
    return out


dense_revise_block.launches = 0


def reset_launches() -> None:
    """Zero every wrapper's launch count."""
    dense_revise_stacked.launches = 0
    dense_fixpoint_stacked.launches = 0
    dense_revise.launches = 0
    dense_revise_block.launches = 0
