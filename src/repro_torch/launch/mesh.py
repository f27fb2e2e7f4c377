"""Meshes and the process world of the sharded path.

The counterpart of `repro.launch.mesh`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, laid out row-major over its axes (the last axis fastest), as
`jax.make_mesh` lays out devices. ``make_production_mesh`` and
``host_device_mesh`` are FUNCTIONS: importing this module touches no process
group. Single pod: (data=16, model=16) = 256 ranks; multi-pod adds the
leading ``pod`` axis (2 × 256 = 512 ranks) carrying only data parallelism.
Building either needs a world of that many ranks.

    init_world("cpu")                      # torchrun's world, or one rank
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")

`init_world` reads the ``torchrun`` environment, or takes a given store
(a `FileStore` needs no port), or makes a one-rank world over an in-process
store. It uses nccl for cuda and gloo for cpu; a caller may name gloo for
cuda (several ranks on one card: NCCL refuses two ranks on one GPU). It
never changes the device type or the backend on its own.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import Device, resolve_device

#: (world group, device type, shape, axes) -> DeviceMesh; a mesh's groups are
#: made once per world
_MESHES: Dict[tuple, object] = {}
#: (world group, mesh id, axes) -> (group, this rank's index in it)
_GROUPS: Dict[tuple, tuple] = {}


def init_world(device: Device = "cuda", store: Optional[dist.Store] = None, *,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               backend: Optional[str] = None) -> str:
    """Initialise the default process group once and return its backend.

    With ``store``, ``rank`` and ``world_size`` say who this process is;
    without, the ``torchrun`` environment (``WORLD_SIZE``) does, or the
    world is this one rank. ``backend`` defaults to nccl for cuda and gloo
    for cpu. A world that is already initialised is kept; naming another
    backend for it raises. Under ``torchrun`` on cuda the current device is
    set to ``LOCAL_RANK``."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU world runs on gloo, not {backend}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
        return backend
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        torch.cuda.set_device(index)
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("a store needs rank and world_size")
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return backend


def _world_key():
    # the group object itself: a cache entry keeps it alive, so a later
    # world can never share its key
    return dist.group.WORLD


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: Device = "cuda"):
    """A `DeviceMesh` of ``shape`` over ``axes`` on ``device``'s type, over
    the default process group, whatever its backend (`init_world` makes a
    one-rank world, or torchrun's, if none exists). The world must hold
    ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        init_world(dev)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the world has "
                         f"{dist.get_world_size()}")
    key = (_world_key(), dev.type, shape, axes)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device: Device = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def host_device_mesh(n_data: int = 1, n_model: int = 1, device: Device = "cuda"):
    """Small (data, model) mesh — smoke/integration runs."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def axis_group(mesh, axes: Sequence[str]) -> Tuple[Optional[dist.ProcessGroup], int, int]:
    """(group, size, index) of this rank over ``axes`` of ``mesh`` — the
    ranks that differ from this one only along those axes, in the mesh's
    row-major order (``("pod", "data")``: pod major), and this rank's index
    among them. No axes: (None, 1, 0). Several axes make their groups once
    per mesh, every rank taking part, as `torch.distributed.new_group`
    requires."""
    axes = tuple(axes)
    names = list(mesh.mesh_dim_names)
    if not axes:
        return None, 1, 0
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} must be in the mesh's order {tuple(names)}")
    if len(axes) == 1:
        return mesh.get_group(axes[0]), mesh.size(dims[0]), mesh.get_local_rank(axes[0])
    key = (_world_key(), id(mesh), axes)
    if key not in _GROUPS:
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(mesh.mesh.shape[i]
                                                                      for i in dims))
        me = dist.get_rank()
        found = None
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                found = (group, len(row), row.index(me))
        _GROUPS[key] = found
    return _GROUPS[key]
