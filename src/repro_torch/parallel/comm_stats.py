"""Collective-byte accounting for the sharded path, from the collectives it
really issues.

The counterpart of `repro.parallel.hlo_stats`. The reference parses the
SPMD-partitioned HLO for each collective's result shape and group size;
PyTorch compiles no HLO, so every collective of the port's sharded path goes
through `all_gather` here, which records its kind, the result tensor's bytes
and the group size. `collective_stats` turns records into the reference's
dict, ``{kind: {count, result_bytes, wire_bytes}}``, with the same ring
factors for per-device wire bytes:

    all-reduce:          2·(g-1)/g · bytes
    all-gather:            (g-1)/g · bytes       (result bytes)
    reduce-scatter:        (g-1)/g · bytes·g     (operand = result·g)
    all-to-all:            (g-1)/g · bytes
    collective-permute:              bytes

and a group of one sends nothing. The reference's HLO-text parsing
(``_shape_bytes``, ``_group_size``, ``count_ops``) has no input here and has
no counterpart. `launch.dryrun_rtac` feeds the same formulas records it
computes from the port's layouts.

    with comm_stats.recording() as log:
        ...                                 # run the sharded fixpoint
    stats = comm_stats.collective_stats(log)

A gloo group given CUDA tensors gathers through host memory (gloo's
all-gather takes host tensors); the helper chooses that by the group's
backend, before the call, and the record says so (``staged``). Inside
``timing()`` each all-gather of CUDA tensors is bracketed by two CUDA
events on the current stream, which waits for the collective's own stream:
``elapsed_time`` of a pair is the gather as this rank saw it, the wait for
the slowest peer included.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist


class Collective(NamedTuple):
    """One collective as issued: its kind (HLO spelling), the bytes of its
    result on this rank, its group's size, and whether it went through host
    memory."""

    kind: str
    result_bytes: int
    group_size: int
    staged: bool = False


_RECORDERS: List[List[Collective]] = []
_TIMERS: List[list] = []


@contextlib.contextmanager
def recording():
    """Collect every collective issued inside the block (nested blocks each
    see all of theirs)."""
    log: List[Collective] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


@contextlib.contextmanager
def timing():
    """Collect a (start, end) pair of CUDA events for every all-gather of
    CUDA tensors issued inside the block; read them after a synchronize."""
    pairs: list = []
    _TIMERS.append(pairs)
    try:
        yield pairs
    finally:
        _TIMERS.remove(pairs)


def _record(kind: str, result_bytes: int, group_size: int, staged: bool) -> None:
    for log in _RECORDERS:
        log.append(Collective(kind, int(result_bytes), int(group_size), staged))


def wire_factor(kind: str, group_size: int) -> float:
    """Per-device ring wire bytes per result byte (`hlo_stats`' factors)."""
    g = group_size
    if kind == "collective-permute":
        return 1.0
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    return (g - 1) / g  # all-gather, all-to-all


def collective_stats(records: Iterable[Collective]) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind: count, raw result bytes, ring wire bytes."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
    )
    for c in records:
        s = stats[c.kind]
        s["count"] += 1
        s["result_bytes"] += c.result_bytes
        s["wire_bytes"] += c.result_bytes * wire_factor(c.kind, c.group_size)
    return dict(stats)


def total_wire_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(s["wire_bytes"] for s in stats.values())


def staged(group: Optional[dist.ProcessGroup], t: torch.Tensor) -> bool:
    """Whether `all_gather` stages ``t`` through host memory: a CUDA tensor
    on a gloo group."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _gather_into(out: torch.Tensor, src: torch.Tensor, group) -> None:
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in group
    rank order — the reference's ``lax.all_gather(..., tiled=True)``. Bool
    tensors travel as their bytes. Recorded as one all-gather whose result
    is the gathered tensor."""
    g = dist.get_world_size(group)
    src = t.contiguous()
    src = src.view(torch.uint8) if src.dtype == torch.bool else src
    # the ranks' tensors one after another along dim 0, as every backend takes it
    out = torch.empty((g * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    via_host = staged(group, src)
    _record("all-gather", out.numel() * out.element_size(), g, via_host)
    events = None
    if _TIMERS and src.device.type == "cuda":
        events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        events[0].record()
    if via_host:
        host = torch.empty(out.shape, dtype=src.dtype)
        _gather_into(host, src.cpu(), group)
        out.copy_(host)
    else:
        _gather_into(out, src, group)
    if events is not None:
        events[1].record()
        for pairs in _TIMERS:
            pairs.append(events)
    out = out.view(torch.bool) if t.dtype == torch.bool else out
    shape = t.shape
    return out.view(g, *shape).movedim(0, dim).reshape(*shape[:dim], g * shape[dim],
                                                       *shape[dim + 1:])
