"""Hopper kernel engines — incremental RTAC on dense u8 and bitpacked networks.

The counterparts of `repro.engines.pallas.PallasDenseEngine` and
`PallasPackedEngine`. ``prepare`` pays the O(n²d²) padding / transpose
[/ bitpack] of the constraint tensor once per CSP; the hot path pads only
the O(n·d) domains into kernel coordinates and un-pads the result.

An engine decides only its kind (``"dense"`` | ``"packed"``) and whether it
is fused; `kernels.ops` decides the rest from those and the padded shape:

- ``enforce``/``enforce_batch`` (and so ``mac_solve``) hand each call to
  `ops.fixpoint_single`, which picks one of three routes (one fused launch,
  the word loop, or the host loop over the single-network revise) and
  counts it.
- ``prepare_many`` allocates slot tables once —
  ``(B, n_p·d_p, n_p·d_p)`` u8 dense, ``(B, n_p·d_p, n_p·W)`` int32 packed —
  and writes each instance's padded network into its slot in place, one
  instance at a time (`ops.write_slot`); each frontier round (`ops.frontier_fix`) or ``enforce_many`` call runs
  the stacked kernels through `ops.enforce_rows`, which read every row's
  network in place from those tables: ``fixpoint="fused"`` (default) one
  `*_fixpoint_stacked` launch per round runs the whole recurrence;
  ``fixpoint="stepped"`` is a host loop with one `*_revise_stacked` launch
  per recurrence — the fallback rung and the parity oracle.
- ``open_slot_pool`` preallocates the same tables for the service, with
  zeros, and installs each admitted network into its slot the same way;
  every service round reads the networks through their slot ids, as above.

The env default of ``fixpoint`` reads ``REPRO_TORCH_FIXPOINT``.
"""

from __future__ import annotations

import os

import torch

from repro_torch import obs
from repro_torch.core.csp import CSP
from repro_torch.core.engine import (
    Engine,
    PreparedMany,
    PreparedNetwork,
    as_changed,
    as_dom,
    pad_changed,
    pad_dom,
    padded_shape,
    resolve_instance_idx,
)
from repro_torch.core.rtac import EnforceResult
from repro_torch.kernels import ops
from . import register

FIXPOINT_ENV = "REPRO_TORCH_FIXPOINT"


class _HopperEngine(Engine):
    """Shared prepare/enforce plumbing; subclasses pick the kernel family.

    Subclass hooks: ``kind`` (``"dense"`` | ``"packed"``, what `kernels.ops`
    dispatches on), ``_prepare_net(csp)`` (the padded network on the
    engine's device, memoized per CSP) and ``_slot_tables(n_vars, dom_size,
    capacity)`` (zeroed slot tables: a stacked workload's or a slot
    pool's, which are its whole payload)."""

    kind: str
    stacked_many = True
    slot_table = True
    device_frontier = True
    speculative_rows_hint = 64

    def __init__(self, fixpoint: str | None = None, device="cuda"):
        super().__init__(device)
        if fixpoint is None:
            fixpoint = os.environ.get(FIXPOINT_ENV, "fused")
        if fixpoint not in ("fused", "stepped"):
            raise ValueError(f"fixpoint must be 'fused' or 'stepped', got {fixpoint!r}")
        self.fixpoint = fixpoint
        self.fused_fixpoint = fixpoint == "fused"

    def _dims(self, n: int, d: int) -> tuple:
        return ops.dims(self.kind, *padded_shape(n, d, ops.N_MULT, ops.D_MULT))

    # --- single-network path (one search, many domains) ---------------------

    def _prepare_payload(self, csp: CSP):
        return self._prepare_net(csp), self._dims(*csp.dom.shape)

    def _fixpoint(self, payload, dom_p, ch_p) -> EnforceResult:
        """B padded rows (B, n_p, d_p) with their seeds (B, n_p) against the
        prepared network, by the route `ops.fixpoint_single` picks."""
        network, dims = payload
        return ops.fixpoint_single(self.kind, self.fused_fixpoint, network, dom_p, ch_p, dims)

    def enforce(self, prepared: PreparedNetwork, dom, changed0=None) -> EnforceResult:
        n_p, d_p = prepared.payload[1][:2]
        n, d = prepared.n_vars, prepared.dom_size
        with obs.span("enforce.upload", cat="fixpoint", rows=1):
            dom_p = pad_dom(as_dom(dom, self.device), n_p, d_p)
            ch_p = pad_changed(changed0, n, n_p, device=self.device)
        res = self._fixpoint(prepared.payload, dom_p[None], ch_p[None])
        return EnforceResult(res.dom[0, :n, :d], res.consistent[0], res.n_recurrences[0])

    def enforce_batch(self, prepared: PreparedNetwork, doms, changed0=None) -> EnforceResult:
        n_p, d_p = prepared.payload[1][:2]
        n, d = prepared.n_vars, prepared.dom_size
        with obs.span("enforce.upload", cat="fixpoint", rows=len(doms)):
            doms = as_dom(doms, self.device)
            dom_p = pad_dom(doms, n_p, d_p)
            ch_p = pad_changed(changed0, n, n_p, batch=doms.shape[:-2], device=self.device)
        res = self._fixpoint(prepared.payload, dom_p, ch_p)
        return EnforceResult(res.dom[:, :n, :d], res.consistent, res.n_recurrences)

    # --- stacked workload path (R rows, each against its OWN network) -------

    def _write_slot(self, tables, slot, csp: CSP) -> None:
        ops.write_slot(self.kind, csp, tables, slot)

    def _rows_dispatch(self, tables, doms, changed0, idx) -> EnforceResult:
        """R rows in caller coordinates, row i against ``tables[idx[i]]`` (a
        stacked workload or a slot pool's tables): pad into kernel
        coordinates, `ops.enforce_rows` (the kernels read each row's network
        in place through its slot id), un-pad."""
        doms = as_dom(doms, self.device)
        n, d = doms.shape[-2:]
        dims = self._dims(n, d)
        n_p, d_p = dims[0], dims[1]
        idx = torch.as_tensor(idx, device=self.device)
        dom_p = pad_dom(doms, n_p, d_p)
        ch_p = pad_changed(as_changed(changed0, self.device), n, n_p,
                           batch=doms.shape[:-2], device=self.device)
        res = ops.enforce_rows(self.kind, self.fused_fixpoint, tables, dom_p, ch_p, idx, dims)
        return EnforceResult(res.dom[:, :n, :d], res.consistent, res.n_recurrences)

    def enforce_many(self, prepared: PreparedMany, doms, changed0=None,
                     instance_idx=None) -> EnforceResult:
        idx = resolve_instance_idx(instance_idx, prepared.n_instances, len(doms))
        return self._rows_dispatch(prepared.payload, doms, changed0, idx)

    # --- device-resident frontiers ------------------------------------------

    def frontier_fix(self):
        return ops.frontier_fix(self.kind, self.fused_fixpoint)

    def frontier_networks(self, prepared: PreparedMany):
        return prepared.payload


@register
class HopperDenseEngine(_HopperEngine):
    """Incremental RTAC with the dense u8 CUDA kernels (fused or stepped)."""

    name = "hopper_dense"
    kind = "dense"

    def _prepare_net(self, csp: CSP):
        return ops.prepare_dense(csp, device=self.device)[0]

    def _slot_tables(self, n_vars, dom_size, capacity):
        n_p, d_p = self._dims(n_vars, dom_size)
        return (torch.zeros((capacity, n_p * d_p, n_p * d_p), dtype=torch.uint8,
                            device=self.device),
                torch.zeros((capacity, n_p, n_p), dtype=torch.uint8, device=self.device))

    def network_nbytes(self, n_vars: int, dom_size: int) -> int:
        n_p, d_p = self._dims(n_vars, dom_size)
        return n_p * d_p * n_p * d_p + n_p * n_p  # u8 cons2 + u8 mask


@register
class HopperPackedEngine(_HopperEngine):
    """Incremental RTAC with the bitpacked CUDA kernels (fused or stepped)."""

    name = "hopper_packed"
    kind = "packed"

    def _prepare_net(self, csp: CSP):
        return ops.prepare_packed(csp, device=self.device)[0]

    def _slot_tables(self, n_vars, dom_size, capacity):
        n_p, d_p, w = self._dims(n_vars, dom_size)
        return (torch.zeros((capacity, n_p * d_p, n_p * w), dtype=torch.int32,
                            device=self.device),
                torch.zeros((capacity, n_p, n_p), dtype=torch.uint8, device=self.device))

    def network_nbytes(self, n_vars: int, dom_size: int) -> int:
        n_p, d_p, w = self._dims(n_vars, dom_size)
        return n_p * d_p * n_p * w * 4 + n_p * n_p  # packed words + u8 mask
