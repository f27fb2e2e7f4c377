"""Logical-axis sharding rules → concrete partition specs, with divisibility
fallback.

The counterpart of `repro.parallel.sharding`. Model code names dimensions
logically ('batch', 'embed', 'heads', 'mlp', 'vocab', ...); a rule table
per run maps logical names to mesh axes. A requested mapping is *demoted*
— drop mesh axes right-to-left, then replicate — whenever the dimension is
not divisible or the mesh axis is already taken by another dimension of the
same tensor. Demotions are deterministic and logged, with the reference's
lines.

PyTorch has no ``jax.sharding.PartitionSpec``: `PartitionSpec` here is a
tuple with one entry per tensor dimension (None, a mesh axis, or a tuple of
mesh axes), equal to the reference's spec as a tuple, and `placements_for`
turns it into DTensor placements on a `DeviceMesh`. `shard_act`
redistributes a `DTensor` to its spec; any other tensor is returned
unchanged, as the reference's constraint is a no-op outside a context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# logical axis -> preferred mesh axes (tried left-to-right as a unit, then demoted)
ParamRules = Dict[str, Tuple[str, ...]]

# Parameters: TP axes on 'model', FSDP on 'data' (+'pod' for the very largest).
DEFAULT_PARAM_RULES: ParamRules = {
    "layers": (),
    "embed": ("data",),  # FSDP: contracting dims sharded over data
    "embed_table": (),  # embedding feature dim: never FSDP (gather reshard cost)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "qkv": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_mlp": (),
    "state": (),
    "conv": (),
    "frames": (),
}

# Activations: batch data-parallel; TP dims on 'model'; seq for sequence-parallel.
DEFAULT_ACT_RULES: ParamRules = {
    "batch": ("pod", "data"),
    "seq": (),
    "seq_resid": (),  # residual-stream seq axis: 'model' only when checkpoints overflow
    "cache_seq": ("model", "data"),  # decode KV cache seq: model, plus data when batch=1 frees it
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "seq_q": ("model",),  # attention q-dim: takes 'model' exactly when the head dims could not
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_cap": (),
    "state": (),
    "layers": (),
    "frames": (),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis, or a
    tuple of mesh axes (sharded over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_for(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: ParamRules,
    mesh_shape: Dict[str, int],
    log: Optional[list] = None,
) -> PartitionSpec:
    """Build a PartitionSpec honoring divisibility + one-use-per-mesh-axis."""
    used: set = set()
    parts = []
    for dim, (name, size) in enumerate(zip(axes, shape)):
        if name is None:
            parts.append(None)
            continue
        want = tuple(a for a in rules.get(name, ()) if a in mesh_shape)
        # demote: drop axes right-to-left until divisible & unused
        choice: Tuple[str, ...] = ()
        cand = list(want)
        while cand:
            prod = 1
            ok = True
            for a in cand:
                if a in used:
                    ok = False
                    break
                prod *= mesh_shape[a]
            if ok and size % prod == 0:
                choice = tuple(cand)
                break
            cand.pop()  # drop rightmost
        if log is not None and choice != want and want:
            log.append(f"demote dim{dim}({name},{size}): {want} -> {choice}")
        used.update(choice)
        parts.append(choice if len(choice) > 1 else (choice[0] if choice else None))
    return PartitionSpec(*parts)


def placements_for(spec: PartitionSpec, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh axis,
    ``Shard(dim)`` of the tensor dimension that names it, else
    ``Replicate()``. A dimension on several axes must list them in the
    mesh's order (a DTensor shards nested dimensions mesh-major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in entry]
        if order != sorted(order):
            raise ValueError(f"dim {dim}: axes {entry} are not in the mesh's order {names}")
        for i in order:
            placements[i] = Shard(dim)
    return placements


# ---------------------------------------------------------------------------
# Context: mesh + rules available to model code for activation constraints.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardingCtx:
    mesh: object  # a torch.distributed.device_mesh.DeviceMesh
    param_rules: ParamRules
    act_rules: ParamRules
    log: list = dataclasses.field(default_factory=list)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))


_tls = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def sharding_ctx(ctx: Optional[ShardingCtx]):
    prev = current_ctx()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def make_ctx(mesh, param_rules=None, act_rules=None) -> ShardingCtx:
    return ShardingCtx(
        mesh=mesh,
        param_rules=dict(param_rules or DEFAULT_PARAM_RULES),
        act_rules=dict(act_rules or DEFAULT_ACT_RULES),
    )


def shard_act(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute a `DTensor` activation to its logical axes' spec (the
    ctx's log gets the demotions, as in the reference); no-op outside a ctx,
    and any other tensor is returned unchanged."""
    from torch.distributed.tensor import DTensor

    ctx = current_ctx()
    if ctx is None:
        return x
    spec = spec_for(axes, x.shape, ctx.act_rules, ctx.mesh_shape, ctx.log)
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, placements_for(spec, ctx.mesh))
