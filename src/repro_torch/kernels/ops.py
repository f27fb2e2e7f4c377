"""Wrappers binding the bitpacked kernels into the RTAC fixpoint.

The counterpart of `repro.kernels.ops` (packed half; the dense u8 kernels
come in a later slice). It handles the shape contract between the algorithm
(n vars × d values, any sizes) and the kernels (padded, flattened,
bitpacked); the padding contract itself lives in `repro_torch.core.engine`.

- Network preparation (pad + transpose + bitpack of the O(n²d²) constraint
  tensor) is memoized per CSP identity and device.
- The rows functions take the slot tables and the row→slot map, never
  gathered networks: the kernels read ``tables[idx[r]]`` in place.
- Factories are ``lru_cache``-d on shapes so each closure is built once.
"""

from __future__ import annotations

import functools
import weakref
from typing import Tuple

import torch

from repro_torch import faults, obs
from repro_torch.core import rtac
from repro_torch.core.csp import CSP
from repro_torch.core.engine import pad_dom, pad_network, padded_shape
from . import bitpack_support, ref

Tensor = torch.Tensor


def _count_build(name: str) -> None:
    """Registry tick for one kernel-closure construction."""
    obs.counter_add("kernels.fn_builds")
    obs.counter_add(f"kernels.fn_builds.{name}")


#: variable-axis multiple n is padded to (the reference's default tile)
N_MULT = 8
#: value-axis multiple d is padded to (the one place it is set)
D_MULT = 8

# (kind, n_mult, device, id(cons), id(mask)) -> (wref(cons), wref(mask), value)
_NETWORK_CACHE: dict = {}


def _cached(kind: str, csp: CSP, n_mult: int, device, build):
    key = (kind, n_mult, str(device), id(csp.cons), id(csp.mask))
    hit = _NETWORK_CACHE.get(key)
    if hit is not None and hit[0]() is csp.cons and hit[1]() is csp.mask:
        return hit[2]
    value = build()
    evict = lambda _ref: _NETWORK_CACHE.pop(key, None)
    _NETWORK_CACHE[key] = (weakref.ref(csp.cons, evict), weakref.ref(csp.mask, evict), value)
    return value


def pack_network(cons: Tensor, n_p: int, d_p: int) -> Tuple[Tensor, int]:
    """(n_p,n_p,d_p,d_p) bool -> ((n_p*d_p, n_p*W) int32, W)."""
    packed = ref.pack_bits_ref(cons)  # (n_p, n_p, d_p, W)
    w = packed.shape[-1]
    return packed.permute(0, 2, 1, 3).reshape(n_p * d_p, n_p * w).contiguous(), w


def prepare_packed(csp: CSP, block_rx: int = N_MULT, block_ry: int = N_MULT, device=None):
    """-> (network, dom_padded, (n_p, d_p, w)); network = (cons int32, mask u8)
    on ``device`` (default: the CSP's), memoized per CSP. n pads to a multiple
    of ``max(block_rx, block_ry)``, as the reference's ``prepare_packed`` does
    for its tiles; the engine always uses `N_MULT`."""
    faults.inject("kernel.launch", kernel="packed")
    device = csp.cons.device if device is None else torch.device(device)
    n_mult = max(block_rx, block_ry)

    def build():
        cons, mask, n_p, d_p = pad_network(csp, n_mult, D_MULT)
        cons_p2, w = pack_network(cons.to(device), n_p, d_p)
        return (cons_p2, mask.to(device=device, dtype=torch.uint8)), (n_p, d_p, w)

    network, (n_p, d_p, w) = _cached("packed", csp, n_mult, device, build)
    return network, pad_dom(csp.dom.to(device), n_p, d_p), (n_p, d_p, w)


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
# Stacked revise (stepped) and fused fixpoint rows functions
# ---------------------------------------------------------------------------


def _kernel_args(doms: Tensor, changed: Tensor, idx: Tensor, n_p: int, w: int):
    r = doms.shape[0]
    words = ref.pack_bits_ref(doms).reshape(r, n_p * w)
    return idx.to(torch.int32).contiguous(), words, changed.to(torch.uint8).contiguous()


@functools.lru_cache(maxsize=None)
def _packed_rows_fn(n_p: int, d_p: int, w: int):
    """Stacked revise-rows closure (rtac.ReviseRowsFn): row domains are packed
    fresh each recurrence; one `packed_revise_stacked` launch per call."""
    _count_build("packed_rows")

    def revise_rows(tables, idx, doms, changed):
        cons_t, mask_t = tables
        idx32, words, ch = _kernel_args(doms, changed, idx, n_p, w)
        viol = bitpack_support.packed_revise_stacked(cons_t, mask_t, idx32, words, ch,
                                                     d=d_p, w=w)
        return viol.view(-1, n_p, d_p).bool()

    return revise_rows


@functools.lru_cache(maxsize=None)
def _packed_fixpoint_rows_fn(n_p: int, d_p: int, w: int):
    """Stacked one-launch fixpoint: row domains are packed ONCE on entry; the
    whole recurrence runs inside one `packed_fixpoint_stacked` launch, reading
    each row's network in place. The closure takes the arguments of
    `rtac.enforce_rows_generic` minus the revise closure, so callers route
    between the two with a flag."""
    _count_build("packed_fixpoint_rows")

    def fixpoint_rows(tables, doms, changed, idx):
        cons_t, mask_t = tables
        idx32, words, ch = _kernel_args(doms, changed, idx, n_p, w)
        dom, consistent, k = bitpack_support.packed_fixpoint_stacked(
            cons_t, mask_t, idx32, words, ch, d=d_p, w=w
        )
        return rtac.EnforceResult(dom.view(-1, n_p, d_p).bool(), consistent.bool(), k)

    return fixpoint_rows


# ---------------------------------------------------------------------------
# Frontier entries (one round of the device frontier)
# ---------------------------------------------------------------------------


def _frontier_entry(fused: bool):
    def assign_enforce_rows(tables, doms, var, val, idx):
        r, n, d = doms.shape
        n_p, d_p = padded_shape(n, d, N_MULT, D_MULT)
        w = -(-d_p // 32)
        dom_p = assign_padded_rows(pad_dom(doms, n_p, d_p), var, val)
        ch_p = _padded_seed(var, n, n_p)
        if fused:
            res = _packed_fixpoint_rows_fn(n_p, d_p, w)(tables, dom_p, ch_p, idx)
        else:
            rows_fn = _packed_rows_fn(n_p, d_p, w)
            res = rtac.enforce_rows_generic(tables, dom_p, ch_p, idx, revise_rows_fn=rows_fn)
        return rtac.EnforceResult(res.dom[:, :n, :d], res.consistent, res.n_recurrences)

    return assign_enforce_rows


@functools.lru_cache(maxsize=None)
def _packed_frontier_fn():
    """Stepped frontier round: pad, batched Alg. 2 assignment, seed, then the
    host-loop fixpoint with one revise launch per recurrence."""
    _count_build("packed_frontier")
    return _frontier_entry(fused=False)


@functools.lru_cache(maxsize=None)
def _packed_frontier_fused_fn():
    """One-launch-per-round frontier entry: pad, assign, seed, then a single
    fused fixpoint launch."""
    _count_build("packed_frontier_fused")
    return _frontier_entry(fused=True)
