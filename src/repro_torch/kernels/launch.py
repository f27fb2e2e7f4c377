"""Operand checks and ctypes launches shared by the port's kernel modules.

Every kernel library (``csrc/<library>.cu``, built by `build`) exports plain
C launchers ``int <launcher>(void* tensors..., int sizes..., void* stream)``
that return the ``cudaError`` of the launch. `SIGNATURES` lists, per
library, each launcher's count of pointer and int arguments, so ctypes
passes pointers as 64-bit values and never cuts them to 32 bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build

Tensor = torch.Tensor

#: the most dynamic shared memory a block may use; the launchers opt in to
#: more than 48 KB where a layout needs it
SMEM_OPT_IN_LIMIT = 227 * 1024

#: library -> {C launcher: (pointer arguments, int arguments)} of the
#: launchers that take a launch schedule (`autotune`): stacked launchers take
#: (rows, n, d[, w]) after their tensors, single-network launchers the same
#: without the row→slot map. Each has a ``<launcher>_sched`` variant that
#: takes one more int, the schedule, after them; the plain launcher is that
#: variant with the default schedule.
SCHEDULED = {
    "packed_fixpoint": {"packed_fixpoint_stacked_launch": (8, 4)},
    "packed_revise": {"packed_revise_stacked_launch": (6, 4), "packed_revise_launch": (5, 4)},
    "dense_fixpoint": {"dense_fixpoint_stacked_launch": (8, 3)},
    "dense_revise": {"dense_revise_stacked_launch": (6, 3), "dense_revise_launch": (5, 3)},
}

#: library -> {block launcher: (pointer arguments, int arguments)}, the
#: launchers of csrc/block_revise.cuh's kernel, each picking its own span:
#: ``*_block_revise_launch`` on an x-block of one network in the pair-major
#: layout, its tensors (network, mask, domains, seeds, the seed pass's
#: scratch, out), then (rows, nx, n, d[, w]); ``*_revise_wide_launch`` on a
#: whole network in the single-network (value-major) layout, the
#: single-network revises' wide route (`single_wide`), the same tensors,
#: then (rows, n, d[, w])
BLOCK = {
    "packed_revise": {"packed_block_revise_launch": (6, 5), "packed_revise_wide_launch": (6, 4)},
    "dense_revise": {"dense_block_revise_launch": (6, 4), "dense_revise_wide_launch": (6, 3)},
}

#: library -> {C function: (pointer arguments, int arguments)} of kernel 1
#: with each row split over a thread-block cluster (`fixpoint_split`):
#: ``packed_fixpoint_split_launch`` takes the tensors of
#: ``packed_fixpoint_stacked_launch``, then (rows, n, d, w, c);
#: ``packed_fixpoint_split_clusters`` (`split_clusters`) an int pointer, then
#: (n, d, w, c), and writes how many such clusters the card holds at once
SPLIT = {"packed_fixpoint": {"packed_fixpoint_split_launch": (8, 5),
                             "packed_fixpoint_split_clusters": (1, 4)}}

#: library -> {C launcher: (pointer arguments, int arguments)} of the
#: launchers that take no schedule: the word loop's epilogue
#: (csrc/word_epilogue.cu), its tensors (words, violations, seeds,
#: consistent, k, counts), then (rows, n, d, w)
UNSCHEDULED = {"word_epilogue": {"packed_word_epilogue_launch": (6, 4)}}

#: library -> {C launcher: (pointer arguments, int arguments)}; the stream
#: follows
SIGNATURES = {
    **{library: {**launchers,
                 **{f"{name}_sched": (ptrs, ints + 1)
                    for name, (ptrs, ints) in launchers.items()},
                 **BLOCK.get(library, {}), **SPLIT.get(library, {})}
       for library, launchers in SCHEDULED.items()},
    **UNSCHEDULED,
}

def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


#: warps of one fused-fixpoint or stacked-revise CTA (``kWarps`` in
#: csrc/fixpoint_common.cuh)
CTA_WARPS = 8


def split_span(n: int, c: int) -> int:
    """Variables a CTA of a row split over ``c`` CTAs owns, at most
    (``split_span`` in csrc/fixpoint_common.cuh): ceil(n/c) rounded up to a
    multiple of 16, so that a span's domain words and changed flags are whole
    16-byte pieces; n for an unsplit row."""
    return n if c == 1 else 16 * -(-(-(-n // c)) // 16)


def fixpoint_smem(n: int, d: int, dom_bytes: int, split: int = 1) -> int:
    """Shared memory of one fused-fixpoint CTA (``Smem`` in
    csrc/fixpoint_common.cuh): two domain buffers of ``dom_bytes``, the mask
    bits, per-warp seed bits and violation words, two wipe-out flags,
    per-warp neighbour and value lists (u16), two changed-flag buffers.

    A CTA of a packed row split over ``split`` > 1 CTAs (`fixpoint_split`)
    holds the mask bits of its own span (`split_span`) alone, and domain
    buffers and changed flags for ``split`` whole spans, the flags 16-byte
    aligned. ``split`` = 1 is the figure every route decides on."""
    nwn, w = -(-n // 32), -(-d // 32)
    span = split_span(n, split)
    held = n if split == 1 else split * span
    head = (2 * (dom_bytes if split == 1 else dom_bytes // n * held)
            + 4 * (span * nwn + CTA_WARPS * (nwn + w) + 2) + 2 * CTA_WARPS * (n + d))
    return (head if split == 1 else _align16(head)) + 2 * held


#: the least n at which `fixpoint_split` splits kernel 1's rows: on an H100
#: a split saved 0.009-0.022 ms a launch at n_p = 104 (rb100-40, 1-32 rows;
#: 0.017-0.045 ms launches) against 0.08-0.28 ms at n_p = 256 (PERF.md)
SPLIT_MIN_N = 256

#: the most CTAs of a split row (``kMaxSplit``, the portable cluster size)
SPLIT_MAX = 8

#: split CTAs an SM runs at once: the split kernel's 128 registers a thread
#: over 256 threads take half an SM's 65,536
SPLIT_CTAS_PER_SM = 2


def fixpoint_split(rows: int, n: int, sms: int) -> int:
    """CTAs a row of kernel 1 takes for a launch of ``rows`` rows at n on a
    card of ``sms`` SMs: the largest power of two up to ``min(SPLIT_MAX,
    SPLIT_CTAS_PER_SM · sms // rows)`` where ``n >= SPLIT_MIN_N``, else 1.
    So a launch whose rows leave most SMs idle spreads each row over
    several, and one whose rows fill the card keeps one CTA a row."""
    room = min(SPLIT_MAX, SPLIT_CTAS_PER_SM * sms // max(rows, 1))
    if n < SPLIT_MIN_N or room < 2:
        return 1
    return 1 << (room.bit_length() - 1)


def revise_smem(n: int, d: int, dom_bytes: int, lanes: Optional[int] = None) -> int:
    """Shared memory of one stacked-revise CTA (``Smem`` in
    csrc/revise_common.cuh): the row's domain of ``dom_bytes``, then per
    warp its seed bits, and for each of its owner lanes (one a variable,
    by default ``min(32, ceil(n/8))``) the variable's seeded-neighbour bits
    and violation words (u32) and n (variable, neighbour) pairs (u16)."""
    nwn, w = -(-n // 32), -(-d // 32)
    lanes = min(32, -(-n // CTA_WARPS)) if lanes is None else lanes
    return dom_bytes + 4 * CTA_WARPS * (nwn + lanes * (nwn + w)) + 2 * CTA_WARPS * lanes * n


#: the n from which the single-network revises run the block revise's
#: kernel on the whole network in its single-network layout
#: (``*_revise_wide_launch``; ``1 << kPairY`` in csrc/revise_common.cuh:
#: below it a pair's neighbour fits beside its lane)
SINGLE_WIDE_N = 1 << 11


def single_revise_smem(n: int, d: int) -> int:
    """The most shared memory one single-network revise CTA uses below
    `SINGLE_WIDE_N`: that of a CTA owning a whole row (a tuned span may be
    any), the stacked layout with, in the domain's place (the domain is
    read in place), its variables' mask rows as bits, ``ceil(n/32)`` u32
    words a row (``mbits_bytes`` in csrc/revise_common.cuh)."""
    return revise_smem(n, d, 4 * -(-n // 32) * CTA_WARPS * -(-n // CTA_WARPS))


def single_wide(n: int, d: int) -> bool:
    """Whether a single-network revise of the padded (n, d) shape takes the
    wide launch (``*_revise_wide_launch``: the block revise's kernel on the
    whole network, any n up to `BLOCK_MAX_N`) rather than the narrow CTA
    a (row, span of variables): from `SINGLE_WIDE_N`, or where a narrow CTA
    owning a whole row (`single_revise_smem`) would not fit in shared
    memory (from n = 392 at d = 40). The padded shape alone decides."""
    return n >= SINGLE_WIDE_N or single_revise_smem(n, d) > SMEM_OPT_IN_LIMIT


#: rows a block-revise CTA revises together, the neighbours a warp lists
#: at once, and the largest n (``kGroup``, ``kWindow``, ``kMaxN`` in
#: csrc/block_revise.cuh)
BLOCK_GROUP, BLOCK_WINDOW, BLOCK_MAX_N = 32, 1024, 65535


#: bytes of a block-revise warp's stage (``kStageBytes``)
BLOCK_STAGE = 2048


def block_smem(n: int) -> int:
    """Shared memory of one block-revise CTA (``Smem`` in
    csrc/block_revise.cuh): the row group's union bits (``ceil(n/32)``
    u32), per warp a list of `BLOCK_WINDOW` u16 neighbours, a row-mask
    slot of 32 u32 and (16-byte aligned) a stage of `BLOCK_STAGE` bytes."""
    slots = 4 * -(-n // 32) + 2 * CTA_WARPS * BLOCK_WINDOW
    return _align16(slots + 4 * CTA_WARPS * 32) + CTA_WARPS * BLOCK_STAGE


def block_scratch_bytes(rows: int, n: int, entry: int) -> int:
    """Bytes of the block revise's seed pass output (``Scratch`` in
    csrc/block_revise.cuh) for ``rows`` domains of ``entry`` bytes a
    variable: per group of `BLOCK_GROUP` rows, n row masks (u32), the
    groups' ``ceil(n/32)`` union words, then (16-byte aligned) the
    transposed domains, `BLOCK_GROUP` rows' entries a variable."""
    groups = -(-rows // BLOCK_GROUP)
    return (_align16(4 * groups * (n + -(-n // 32)))
            + groups * n * BLOCK_GROUP * entry)


def check_operands(cons: Tensor, mask: Tensor, idx: Optional[Tensor], dom: Tensor,
                   changed: Tensor, *, d: int, cols: int, word: torch.dtype,
                   block: bool = False) -> Tuple[int, ...]:
    """Validate a kernel's operands; returns (rows, n), with ``block``
    (rows, nx, n).

    ``cons`` holds ``cols`` columns of dtype ``word`` per variable: a slot
    table (C, n·d, n·cols) read through ``idx`` (R,) int32, or, with ``idx``
    None, one network (n·d, n·cols), or with ``block`` an x-block of one in
    the reference's pair-major layout: the rows of nx variables against all
    n, (nx, n, d, cols). ``dom`` is (R, n·cols) ``word``, ``changed`` (R, n)
    u8, ``mask`` (C, n, n), (n, n) or (nx, n) u8."""
    lead = tuple(cons.shape[:1]) if idx is not None else ()
    if block:
        if idx is not None or mask.dim() != 2:
            raise ValueError("a block takes one network: no idx, mask (nx, n)")
        nx, n = mask.shape
        cons_shape = (nx, n, d, cols)
    else:
        if cons.dim() != len(lead) + 2:
            raise ValueError(f"cons: want {len(lead) + 2} dims, got shape {tuple(cons.shape)}")
        nx = n = cons.shape[-2] // d
        cons_shape = (*lead, n * d, n * cols)
    r = (idx if idx is not None else dom).shape[0]
    expect = {
        "cons": (cons, word, cons_shape),
        "mask": (mask, torch.uint8, (*lead, nx, n)),
        "dom": (dom, word, (r, n * cols)),
        "changed": (changed, torch.uint8, (r, n)),
    }
    if idx is not None:
        expect["idx"] = (idx, torch.int32, (r,))
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != cons.device:
            raise ValueError(f"{name} is on {t.device}, cons on {cons.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cons.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cons.device}")
    return (r, nx, n) if block else (r, n)


def check_block(kernel: str, rows: int, n: int) -> None:
    """Raise where a block revise's launcher would refuse its shape: n above
    `BLOCK_MAX_N`, more than 65535 groups of `BLOCK_GROUP` rows, or a CTA's
    shared memory (`block_smem`) over the limit."""
    if n > BLOCK_MAX_N:
        raise ValueError(f"{kernel}: n={n} is above {BLOCK_MAX_N}")
    if -(-rows // BLOCK_GROUP) > 65535:
        raise ValueError(f"{kernel}: {rows} rows make more than 65535 groups of {BLOCK_GROUP}")
    check_smem(kernel, block_smem(n), f"n={n}")


def check_wide(kernel: str, rows: int, n: int, sched: Optional[int]) -> None:
    """Raise where a single-network revise's wide route (`single_wide`: the
    block revise on the whole network) would refuse: a span it cannot take
    (``sched`` other than None or 0), or `check_block`'s limits."""
    if sched not in (None, 0):
        raise ValueError(f"{kernel}: at n={n} the block route takes no span, got {sched}")
    check_block(kernel, rows, n)


def check_smem(kernel: str, nbytes: int, layout: str) -> None:
    """Raise if a block of ``kernel`` needs more shared memory than a block
    may have (`SMEM_OPT_IN_LIMIT`)."""
    if nbytes > SMEM_OPT_IN_LIMIT:
        raise ValueError(f"{kernel}: {layout} needs {nbytes} B of shared memory, more than "
                         f"a block's {SMEM_OPT_IN_LIMIT} B")


def _function(library: str, launcher: str):
    fn = getattr(build.load(library), launcher)
    if fn.argtypes is None:
        n_ptrs, n_ints = SIGNATURES[library][launcher]
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_clusters(device: torch.device, n: int, d: int, w: int, c: int) -> int:
    """How many clusters of kernel 1 split over ``c`` CTAs at (n, d, w) a
    CUDA ``device`` holds at once (``cudaOccupancyMaxActiveClusters`` at the
    split CTA's shared memory); 0 where not even one fits."""
    fn = _function("packed_fixpoint", "packed_fixpoint_split_clusters")
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(ctypes.addressof(out), n, d, w, c, None)
    if rc != 0:
        raise RuntimeError(f"packed_fixpoint_split_clusters failed: cudaError {rc}")
    return out.value


def launch(library: str, launcher: str, tensors: Sequence[Tensor], *sizes: int,
           sched: Optional[int] = None) -> None:
    """Launch ``launcher`` of ``library`` on the current stream of the
    tensors' device; raise if the launch is refused. A ``sched`` (a tuned
    launch schedule) goes to the ``<launcher>_sched`` variant; without one
    the plain launcher runs its default."""
    if sched is not None:
        launcher, sizes = f"{launcher}_sched", (*sizes, sched)
    n_ptrs, n_ints = SIGNATURES[library][launcher]
    if len(tensors) != n_ptrs or len(sizes) != n_ints:
        raise ValueError(f"{launcher} takes {n_ptrs} tensors and {n_ints} sizes, "
                         f"got {len(tensors)} and {len(sizes)}")
    fn = _function(library, launcher)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{launcher} failed: cudaError {rc}")
