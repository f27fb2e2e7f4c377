"""RTAC in PyTorch — the CUDA port of `repro` (JAX + Pallas).

Module for module this package mirrors `src/repro`: `core` (CSP tensors,
the RTAC fixpoint, the Engine protocol with its frontier table, MAC search),
`problems` (seeded generators), `engines` (`einsum`, `full`,
`hopper_packed`), `kernels` (the hand-written CUDA kernels, each beside its
plain PyTorch version) and the `obs`/`faults` support layers. It imports
neither JAX nor `repro`.

Device rule: every entry point takes ``device=`` and defaults to
``"cuda"``; without a card it raises unless the caller passed
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
