"""Sharded engine — the torch.distributed fixpoint of `core/sharded.py`
behind the Engine protocol; the counterpart of `repro.engines.sharded`.

Every rank of the mesh builds the engine and calls it with the same
arguments (SPMD). ``prepare`` places this rank's x-block of the network
once, pair-major as the reference's — (nx, n, d, W) packed for
``impl="bitpacked"``, (nx, n, d_p, d_p) u8 for the u8 einsum, (nx, n, d, d)
``dtype`` for the float einsum — in chunks of rows, so a network far larger
than its packed block never needs a second full-size copy. The hot path
splits only the O(B·n·d) domain batch: ``enforce_batch`` pads B up to a
multiple of the batch-axis extent (repeating the last domain — enforcement
is idempotent per element), runs this rank's shard, and all-gathers the
results over the batch axes, so every rank returns the whole batch, as the
reference's global array holds it. ``enforce`` is a batch of one.

The default mesh is (data=1, model=world) over the default process group;
with none, the engine makes a one-rank world (`launch.mesh.init_world`).
The all-gathers are issued on a world of one too. Search runs through
`HostFrontierStore` (no slot table, no device frontier), as in the
reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.csp import CSP
from repro_torch.core.engine import Engine, PreparedNetwork, as_changed, as_dom
from repro_torch.core.rtac import EnforceResult
from repro_torch.core.sharded import (block_layout, make_sharded_enforcer, mask_layout,
                                      x_rows)
from repro_torch.launch.mesh import axis_group, init_world, make_mesh
from repro_torch.parallel.comm_stats import all_gather
from . import register


@register
class ShardedEngine(Engine):
    name = "sharded"
    # no frontier fabric (host-side store): duplication pays per row
    speculative_rows_hint = 16

    def __init__(
        self,
        mesh=None,
        model_axis: str = "model",
        batch_axes: Sequence[str] = ("data",),
        dtype: torch.dtype = torch.bfloat16,
        impl: str = "einsum",  # "einsum" | "bitpacked"
        device="cuda",
    ):
        super().__init__(device)
        if mesh is None:
            if not dist.is_initialized():
                init_world(self.device)
            mesh = make_mesh((1, dist.get_world_size()), ("data", "model"), self.device)
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the engine on {self.device}")
        self.mesh = mesh
        self.model_axis = model_axis
        self.batch_axes = tuple(batch_axes)
        self.dtype = dtype
        self.impl = impl
        self._enforce = make_sharded_enforcer(mesh, model_axis, self.batch_axes, dtype, impl)
        self._batch_group, self._batch_extent, self._batch_index = axis_group(
            mesh, self.batch_axes)

    def _prepare_payload(self, csp: CSP):
        x0, x1 = x_rows(self.mesh, self.model_axis, csp.n_vars)
        cons = block_layout(csp.cons[x0:x1].to(self.device), self.impl, self.dtype)
        mask = mask_layout(csp.mask[x0:x1].to(self.device), self.impl, self.dtype)
        return cons, mask

    def _run(self, prepared: PreparedNetwork, doms, changed0) -> EnforceResult:
        cons, mask = prepared.payload
        doms = as_dom(doms, self.device)
        b, n = doms.shape[0], doms.shape[1]
        changed0 = as_changed(changed0, self.device)
        if changed0 is None:
            changed0 = torch.ones((b, n), dtype=torch.bool, device=self.device)
        changed0 = changed0.to(self.device)
        # pad B to the batch-axis extent (every shard the same size)
        b_p = -(-b // self._batch_extent) * self._batch_extent
        if b_p != b:
            doms = torch.cat([doms, doms[-1:].expand(b_p - b, *doms.shape[1:])])
            changed0 = torch.cat([changed0, changed0[-1:].expand(b_p - b, n)])
        b_l = b_p // self._batch_extent
        rows = slice(self._batch_index * b_l, (self._batch_index + 1) * b_l)
        res = self._enforce(cons, mask, doms[rows], changed0[rows])
        if self._batch_group is not None:
            res = EnforceResult(*(all_gather(t, self._batch_group) for t in res))
        if b_p != b:
            res = EnforceResult(res.dom[:b], res.consistent[:b], res.n_recurrences[:b])
        return res

    def enforce(self, prepared: PreparedNetwork, dom, changed0=None) -> EnforceResult:
        dom = as_dom(dom, self.device)
        if changed0 is not None:
            changed0 = as_changed(changed0, self.device)[None]
        res = self._run(prepared, dom[None], changed0)
        return EnforceResult(res.dom[0], res.consistent[0], res.n_recurrences[0])

    def enforce_batch(self, prepared: PreparedNetwork, doms, changed0=None) -> EnforceResult:
        return self._run(prepared, doms, changed0)

    # prepare_many / enforce_many: generic per-instance fallback. The sharded
    # fixpoint spreads ONE network's x-rows over the 'model' axis; stacking B
    # networks would multiply the dominant O(n²d²) residency by B per shard,
    # which is exactly what this engine exists to avoid.
