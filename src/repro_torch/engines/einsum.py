"""Einsum engines — the plain PyTorch contraction backends (no padding).

``einsum`` is the incremental fixpoint of Prop. 2 (the default engine);
``full`` is the paper-faithful bare recurrence of Eq. 1. The JAX package left
this contraction to XLA, so the port keeps it as plain ``torch.einsum``.
"""

from __future__ import annotations

import functools
import torch

from repro_torch.core import rtac
from repro_torch.core.csp import CSP
from repro_torch.core.engine import (
    Engine,
    PreparedMany,
    PreparedNetwork,
    as_changed,
    as_dom,
    resolve_instance_idx,
)
from repro_torch.core.rtac import EnforceResult, SupportFn, einsum_support
from . import register


@functools.lru_cache(maxsize=None)
def _einsum_frontier_fix(revise_fn):
    """Frontier core: batched assign + seed + the gathered incremental
    fixpoint."""

    def fix(networks, doms, var, val, net_idx):
        return rtac.assign_enforce_many(networks, doms, var, val, net_idx,
                                        revise_fn=revise_fn)

    return fix


@functools.lru_cache(maxsize=None)
def _full_frontier_fix(support_fn):
    def fix(networks, doms, var, val, net_idx):
        cons, mask = networks
        return rtac.assign_enforce_full_many(cons, mask, doms, var, val, net_idx,
                                             support_fn=support_fn)

    return fix


class _ContractionEngine(Engine):
    """Shared plumbing: the network is the CSP's own (cons, mask) on the
    engine's device; the stacked form of `prepare_many` and a slot pool's
    tables are (C, n, n, d, d) / (C, n, n) bool, each instance copied into
    its slot."""

    stacked_many = True
    slot_table = True
    device_frontier = True
    speculative_rows_hint = 64

    def __init__(self, support_fn: SupportFn = einsum_support, device="cuda"):
        super().__init__(device)
        self.support_fn = support_fn

    def _prepare_payload(self, csp: CSP):
        return (csp.cons.to(self.device), csp.mask.to(self.device))

    def _rows_dispatch(self, networks, doms, changed0, idx) -> EnforceResult:
        """R rows, row i against ``networks[idx[i]]`` (a stacked workload or a
        slot pool's tables)."""
        return self._stacked_rows(networks, as_dom(doms, self.device),
                                  as_changed(changed0, self.device),
                                  torch.as_tensor(idx, device=self.device))

    def enforce_many(self, prepared: PreparedMany, doms, changed0=None,
                     instance_idx=None) -> EnforceResult:
        idx = resolve_instance_idx(instance_idx, prepared.n_instances, len(doms))
        return self._rows_dispatch(prepared.payload, doms, changed0, idx)

    def frontier_networks(self, prepared: PreparedMany):
        return prepared.payload

    def _slot_tables(self, n_vars, dom_size, capacity):
        n, d = n_vars, dom_size
        return (torch.zeros((capacity, n, n, d, d), dtype=torch.bool, device=self.device),
                torch.zeros((capacity, n, n), dtype=torch.bool, device=self.device))

    def _write_slot(self, tables, slot, csp: CSP) -> None:
        tables[0][slot].copy_(csp.cons)
        tables[1][slot].copy_(csp.mask)


@register
class EinsumEngine(_ContractionEngine):
    """Incremental RTAC (Prop. 2) with the einsum support contraction."""

    name = "einsum"

    def __init__(self, support_fn: SupportFn = einsum_support, device="cuda"):
        super().__init__(support_fn, device)
        self._revise_fn = rtac._revise_for(support_fn)

    def enforce(self, prepared: PreparedNetwork, dom, changed0=None) -> EnforceResult:
        return rtac.enforce_generic(
            prepared.payload, as_dom(dom, self.device), as_changed(changed0, self.device),
            revise_fn=self._revise_fn,
        )

    def enforce_batch(self, prepared: PreparedNetwork, doms, changed0=None) -> EnforceResult:
        return rtac.enforce_batch_generic(
            prepared.payload, as_dom(doms, self.device), as_changed(changed0, self.device),
            revise_fn=self._revise_fn,
        )

    def _stacked_rows(self, networks, doms, changed0, idx) -> EnforceResult:
        return rtac.enforce_many_generic(networks, doms, changed0, idx,
                                         revise_fn=self._revise_fn)

    def frontier_fix(self):
        return _einsum_frontier_fix(self._revise_fn)


@register
class FullEngine(_ContractionEngine):
    """Paper-faithful dense recurrence (Eq. 1). Ignores ``changed0`` — every
    step re-tests all (x, a) pairs, exactly as published."""

    name = "full"

    def enforce(self, prepared: PreparedNetwork, dom, changed0=None) -> EnforceResult:
        cons, mask = prepared.payload
        return rtac.enforce_full(cons, mask, as_dom(dom, self.device), support_fn=self.support_fn)

    def enforce_batch(self, prepared: PreparedNetwork, doms, changed0=None) -> EnforceResult:
        cons, mask = prepared.payload
        return rtac.enforce_full_batch(cons, mask, as_dom(doms, self.device),
                                       support_fn=self.support_fn)

    def _stacked_rows(self, networks, doms, changed0, idx) -> EnforceResult:
        del changed0  # the paper-faithful recurrence re-tests everything
        cons, mask = networks
        return rtac.enforce_full_many(cons, mask, doms, idx, support_fn=self.support_fn)

    def frontier_fix(self):
        return _full_frontier_fix(self.support_fn)
