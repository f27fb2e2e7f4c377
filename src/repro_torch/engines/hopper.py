"""Hopper kernel engine — incremental RTAC on bitpacked networks.

The counterpart of `repro.engines.pallas.PallasPackedEngine`. ``prepare_many``
stacks the per-instance packed networks into ``(B, n_p·d_p, n_p·W)`` int32
slot tables; each frontier round or ``enforce_many`` call runs the fixpoint
with the hand-written CUDA kernels of `repro_torch.kernels.bitpack_support`,
which read every row's network in place from those tables:

- ``fixpoint="fused"`` (default): one `packed_fixpoint_stacked` launch per
  round runs the whole recurrence;
- ``fixpoint="stepped"``: a host loop with one `packed_revise_stacked`
  launch per recurrence — the fallback rung and the parity oracle.

The env default reads ``REPRO_TORCH_FIXPOINT``. ``enforce``/``enforce_batch``
need the single-network kernel (`repro.kernels.bitpack_support.packed_revise`),
which a later slice ports (ROADMAP.md, Queue 1 item 2); until then they
raise, and so does ``mac_solve`` on this engine.
"""

from __future__ import annotations

import os

import torch

from repro_torch.core import rtac
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


@register
class HopperPackedEngine(Engine):
    """Incremental RTAC with the bitpacked CUDA kernels (fused or stepped)."""

    name = "hopper_packed"
    stacked_many = True
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

    def _dims(self, n: int, d: int):
        n_p, d_p = padded_shape(n, d, ops.N_MULT, ops.D_MULT)
        return n_p, d_p, -(-d_p // 32)

    def network_nbytes(self, n_vars: int, dom_size: int) -> int:
        n_p, d_p, w = self._dims(n_vars, dom_size)
        return n_p * d_p * n_p * w * 4 + n_p * n_p  # packed words + u8 mask

    # --- single-network path: waits for the packed_revise kernel -------------

    def _prepare_payload(self, csp: CSP):
        network, _, dims = ops.prepare_packed(csp, device=self.device)
        return network, dims

    def enforce(self, prepared: PreparedNetwork, dom, changed0=None) -> EnforceResult:
        raise NotImplementedError(
            "hopper_packed.enforce needs the single-network packed_revise kernel, "
            "which is not ported yet (ROADMAP.md, Queue 1 item 2); use enforce_many or "
            "the einsum engine"
        )

    def enforce_batch(self, prepared: PreparedNetwork, doms, changed0=None) -> EnforceResult:
        return self.enforce(prepared, doms, changed0)

    # --- stacked workload path ----------------------------------------------

    def _prepare_many_payload(self, csps):
        nets = [self._prepare_payload(c)[0] for c in csps]
        tables = (torch.stack([t[0] for t in nets]), torch.stack([t[1] for t in nets]))
        n, d = csps[0].dom.shape
        return tables, self._dims(n, d)

    def enforce_many(self, prepared: PreparedMany, doms, changed0=None,
                     instance_idx=None) -> EnforceResult:
        tables, (n_p, d_p, w) = prepared.payload
        n, d = prepared.n_vars, prepared.dom_size
        doms = as_dom(doms, self.device)
        idx = resolve_instance_idx(instance_idx, prepared.n_instances, doms.shape[0])
        idx = torch.as_tensor(idx, device=self.device)
        dom_p = pad_dom(doms, n_p, d_p)
        ch_p = pad_changed(as_changed(changed0, self.device), n, n_p,
                           batch=doms.shape[:-2], device=self.device)
        if self.fused_fixpoint:
            res = ops._packed_fixpoint_rows_fn(n_p, d_p, w)(tables, dom_p, ch_p, idx)
        else:
            rows_fn = ops._packed_rows_fn(n_p, d_p, w)
            res = rtac.enforce_rows_generic(tables, dom_p, ch_p, idx, revise_rows_fn=rows_fn)
        return EnforceResult(res.dom[:, :n, :d], res.consistent, res.n_recurrences)

    # --- device-resident frontiers ------------------------------------------

    def frontier_fix(self):
        fn = ops._packed_frontier_fused_fn if self.fused_fixpoint else ops._packed_frontier_fn
        return fn()

    def frontier_networks(self, prepared: PreparedMany):
        return prepared.payload[0]
