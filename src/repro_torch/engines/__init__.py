"""Engine registry — every enforcement backend behind one protocol.

    from repro_torch.engines import get_engine
    eng = get_engine("hopper_packed", device="cuda")
    many = eng.prepare_many(csps)          # pad + bitpack + place, ONCE
    res = many.enforce_many(doms, ch, idx) # one stacked fixpoint
    res = eng.prepare(csp).enforce_batch(doms)  # B domains, one network

Registered backends:

    einsum         incremental RTAC (Prop. 2), torch.einsum contraction
    full           paper-faithful dense recurrence (Eq. 1, no incrementality)
    hopper_dense   incremental RTAC on dense u8 networks, hand-written CUDA
                   kernels (fused fixpoint / stepped revise; single-network
                   revise for enforce, enforce_batch and mac_solve)
    hopper_packed  the same on bitpacked networks
    sharded        incremental RTAC over torch.distributed: network x-rows
                   on the mesh's 'model' axis, domains on its batch axes
                   (kernels 3 and 6 on x-blocks, or torch.einsum)
    ac3            queue-based host baseline (paper §5.1); counts revisions

``device`` defaults to ``"cuda"``; without a card, ``get_engine`` raises
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.core.engine import Engine, PreparedNetwork

_REGISTRY: Dict[str, Type[Engine]] = {}


def register(cls: Type[Engine]) -> Type[Engine]:
    """Class decorator: register an Engine subclass under ``cls.name``."""
    _REGISTRY[cls.name] = cls
    return cls


def available_engines() -> List[str]:
    return sorted(_REGISTRY)


def get_engine(name: str, device="cuda", **opts) -> Engine:
    """Instantiate a registered engine by name on ``device`` (``opts`` go to
    its __init__)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown engine {name!r}; available: {available_engines()}")
    return _REGISTRY[name](device=device, **opts)


# Import for side effect: each module registers its engines.
from . import einsum as _einsum  # noqa: E402
from . import hopper as _hopper  # noqa: E402
from . import sharded as _sharded  # noqa: E402
from . import ac3 as _ac3  # noqa: E402

EinsumEngine = _einsum.EinsumEngine
FullEngine = _einsum.FullEngine
HopperDenseEngine = _hopper.HopperDenseEngine
HopperPackedEngine = _hopper.HopperPackedEngine
ShardedEngine = _sharded.ShardedEngine
AC3Engine = _ac3.AC3Engine

__all__ = [
    "Engine",
    "PreparedNetwork",
    "register",
    "get_engine",
    "available_engines",
    "EinsumEngine",
    "FullEngine",
    "HopperDenseEngine",
    "HopperPackedEngine",
    "ShardedEngine",
    "AC3Engine",
]
