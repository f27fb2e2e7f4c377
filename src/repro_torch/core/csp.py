"""CSP tensor representation and the seeded model-A generator.

The PyTorch counterpart of `repro.core.csp` (paper §4 / Alg. 2 `init`):

    Cons ∈ {0,1}^{n×n×d×d}   Cons[x,y,a,b] = 1  iff (x=a, y=b) jointly allowed
    Vars ∈ {0,1}^{n×d}       Vars[x,a]     = 1  iff value a currently in dom(x)

with an explicit ``mask ∈ {0,1}^{n×n}`` of constrained pairs and zero blocks
for unconstrained ones (``has_support = (count > 0) | ~mask``). Generators
draw from ``numpy.random.default_rng`` exactly as the reference does, so the
same seed gives byte-identical arrays; the tensors then land on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device


class CSP(NamedTuple):
    """Dense tensor CSP (bool tensors on one device)."""

    cons: torch.Tensor  # (n, n, d, d) bool — allowed pairs; zero block if unconstrained
    mask: torch.Tensor  # (n, n) bool — True where a constraint exists
    dom: torch.Tensor  # (n, d) bool — current domains

    @property
    def n_vars(self) -> int:
        return self.cons.shape[0]

    @property
    def dom_size(self) -> int:
        return self.cons.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.cons.device


def make_csp(cons, mask, dom, device: Device = "cuda") -> CSP:
    dev = resolve_device(device)
    as_bool = lambda a: torch.tensor(np.asarray(a, dtype=bool), device=dev)
    return CSP(cons=as_bool(cons), mask=as_bool(mask), dom=as_bool(dom))


def csp_from_numpy(cons: np.ndarray, mask: np.ndarray, dom: np.ndarray,
                   device: Device) -> CSP:
    """A reference CSP's arrays (passed as numpy: ``np.asarray(csp.cons)``
    etc.) as the port's CSP on ``device`` — how the same network is carried
    across from `repro` to `repro_torch`, bit for bit."""
    return make_csp(cons, mask, dom, device=device)


def random_csp(
    n_vars: int,
    dom_size: int,
    density: float,
    tightness: float = 0.3,
    seed=0,
    device: Device = "cuda",
) -> CSP:
    """Paper §5.2: each of the n(n-1)/2 pairs gets a constraint with prob
    ``density``; each tuple of a constraint is disallowed with prob
    ``tightness`` (model A). Same numpy draws as `repro.core.random_csp`."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n_vars, k=1)
    edge = rng.random(len(iu[0])) < density
    mask = np.zeros((n_vars, n_vars), dtype=bool)
    mask[iu[0][edge], iu[1][edge]] = True
    mask |= mask.T

    allowed = rng.random((n_vars, n_vars, dom_size, dom_size)) >= tightness
    # symmetrize: Cons[y,x,b,a] == Cons[x,y,a,b]
    upper = np.triu(np.ones((n_vars, n_vars), dtype=bool), k=1)
    allowed = np.where(
        upper[:, :, None, None], allowed, np.transpose(allowed, (1, 0, 3, 2))
    )
    cons = allowed & mask[:, :, None, None]
    dom = np.ones((n_vars, dom_size), dtype=bool)
    return make_csp(cons, mask, dom, device=device)
