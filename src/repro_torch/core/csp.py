"""CSP tensor representation and the seeded model-A generator.

The PyTorch counterpart of `repro.core.csp` (paper §4 / Alg. 2 `init`):

    Cons ∈ {0,1}^{n×n×d×d}   Cons[x,y,a,b] = 1  iff (x=a, y=b) jointly allowed
    Vars ∈ {0,1}^{n×d}       Vars[x,a]     = 1  iff value a currently in dom(x)

with an explicit ``mask ∈ {0,1}^{n×n}`` of constrained pairs and zero blocks
for unconstrained ones (``has_support = (count > 0) | ~mask``). Generators
and the structured builders run in numpy exactly as the reference does, so
the same seed gives byte-identical arrays; the tensors then land on
``device`` (`coloring_csp` and `hashed_random_csp` build their networks
there). ``to_paper_cons`` recovers the paper's all-ones encoding of
unconstrained pairs.
"""

from __future__ import annotations

import dataclasses
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


def to_paper_cons(csp: CSP) -> torch.Tensor:
    """The paper's exact encoding: all-ones d×d blocks for unconstrained pairs."""
    return torch.where(csp.mask[:, :, None, None], csp.cons, torch.ones_like(csp.cons))


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


_WORD = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 tensors holding values in [0, 2^32);
    multipliers under 2^31 keep every product inside int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _WORD
    h = h ^ (h >> 15)
    h = (h * 0x6A2C5B3F) & _WORD
    return h ^ (h >> 16)


def hashed_random_csp(
    n_vars: int,
    dom_size: int,
    density: float,
    tightness: float = 0.3,
    seed: int = 0,
    device: Device = "cuda",
) -> CSP:
    """Model A, as `random_csp`, drawn from a counter-based hash instead of a
    numpy stream, so it is built on ``device`` block by block: sizes whose
    numpy draws would not fit the host (n=4096, d=32 takes 137 GB of them)
    cost device memory for the network only. Pair (x, y) is constrained iff
    hash(seed, min, max) < density; a tuple is disallowed iff
    hash(seed, min, max, value of min, value of max) < tightness, which
    keeps Cons[y,x,b,a] == Cons[x,y,a,b]. Not the same draws as
    `random_csp`."""
    dev = resolve_device(device)
    n, d = n_vars, dom_size
    cons = torch.zeros((n, n, d, d), dtype=torch.bool, device=dev)
    mask = torch.zeros((n, n), dtype=torch.bool, device=dev)
    ys = torch.arange(n, device=dev)[None]
    a = torch.arange(d, device=dev)[:, None]
    b = torch.arange(d, device=dev)[None, :]
    base = _mix32(torch.tensor(seed & _WORD, dtype=torch.int64, device=dev))
    step = max(1, (1 << 24) // (n * d * d))
    for x0 in range(0, n, step):
        xs = torch.arange(x0, min(n, x0 + step), device=dev)[:, None]
        lo, hi = torch.minimum(xs, ys), torch.maximum(xs, ys)
        pair = _mix32(_mix32(base ^ lo) ^ hi)  # (xc, n)
        mask[x0:x0 + xs.shape[0]] = ((_mix32(pair ^ 0x5BD1E995) < density * 2**32)
                                     & (xs != ys))
        first = (xs < ys)[:, :, None, None]
        va, vb = torch.where(first, a, b), torch.where(first, b, a)  # values of lo, hi
        tup = _mix32(pair[:, :, None, None] ^ (1 + va + (vb << 16)))
        cons[x0:x0 + xs.shape[0]] = ((tup >= tightness * 2**32)
                                     & mask[x0:x0 + xs.shape[0], :, None, None])
    return CSP(cons=cons, mask=mask, dom=torch.ones((n, d), dtype=torch.bool, device=dev))


def nqueens_csp(n: int, device: Device = "cuda") -> CSP:
    """N-queens as a binary CSP: one variable per column, domain = row index."""
    a = np.arange(n)
    ra, rb = np.meshgrid(a, a, indexing="ij")  # (d, d) candidate rows
    cons = np.zeros((n, n, n, n), dtype=bool)
    mask = np.zeros((n, n), dtype=bool)
    for x in range(n):
        for y in range(n):
            if x == y:
                continue
            cons[x, y] = (ra != rb) & (np.abs(ra - rb) != abs(x - y))
            mask[x, y] = True
    dom = np.ones((n, n), dtype=bool)
    return make_csp(cons, mask, dom, device=device)


def coloring_csp(adjacency, n_colors: int, device: Device = "cuda") -> CSP:
    """Graph colouring: adjacent vertices take different colours.
    ``adjacency`` is an (n, n) array or tensor (nonzero = an edge; the
    diagonal is ignored). The (n, n, k, k) network is built on ``device``
    by broadcast from the mask, so only the (n, n) adjacency crosses from
    the host."""
    dev = resolve_device(device)
    adj = torch.as_tensor(adjacency, device=dev)
    n = adj.shape[0]
    mask = (adj != 0) & ~torch.eye(n, dtype=torch.bool, device=dev)
    neq = ~torch.eye(n_colors, dtype=torch.bool, device=dev)
    cons = mask[:, :, None, None] & neq
    dom = torch.ones((n, n_colors), dtype=torch.bool, device=dev)
    return CSP(cons=cons, mask=mask, dom=dom)


def sudoku_csp(givens: np.ndarray, device: Device = "cuda") -> CSP:
    """9x9 sudoku as a binary CSP: 81 variables, dom=9, all-diff on rows,
    columns and 3x3 boxes. ``givens``: (9,9) ints, 0 = empty."""
    n, d = 81, 9
    neq = ~np.eye(d, dtype=bool)
    mask = np.zeros((n, n), dtype=bool)
    for i in range(n):
        ri, ci = divmod(i, 9)
        for j in range(n):
            if i == j:
                continue
            rj, cj = divmod(j, 9)
            same_box = (ri // 3 == rj // 3) and (ci // 3 == cj // 3)
            if ri == rj or ci == cj or same_box:
                mask[i, j] = True
    cons = mask[:, :, None, None] & neq[None, None, :, :]
    dom = np.ones((n, d), dtype=bool)
    for i in range(n):
        ri, ci = divmod(i, 9)
        g = int(givens[ri, ci])
        if g:
            dom[i, :] = False
            dom[i, g - 1] = True
    return make_csp(cons, mask, dom, device=device)


def pad_domains(csp: CSP, pad_to: int) -> CSP:
    """Pad the value axis to ``pad_to``. Padding values are absent from every
    domain and allowed by no constraint, so the closure is unchanged."""
    n, d = csp.dom.shape
    if pad_to < d:
        raise ValueError(f"pad_to={pad_to} < dom_size={d}")
    if pad_to == d:
        return csp
    cons = torch.zeros((n, n, pad_to, pad_to), dtype=torch.bool, device=csp.device)
    cons[..., :d, :d] = csp.cons
    dom = torch.zeros((n, pad_to), dtype=torch.bool, device=csp.device)
    dom[:, :d] = csp.dom
    return CSP(cons=cons, mask=csp.mask, dom=dom)


@dataclasses.dataclass(frozen=True)
class CSPBenchSpec:
    """One cell of the paper's §5.2 benchmark grid."""

    n_vars: int
    density: float
    dom_size: int = 20
    tightness: float = 0.3
    seed: int = 0

    def build(self, device: Device = "cuda") -> CSP:
        return random_csp(self.n_vars, self.dom_size, self.density, self.tightness,
                          self.seed, device=device)


# The 25-cell grid from paper §5.2 / Table 1.
PAPER_GRID = [
    CSPBenchSpec(n_vars=n, density=p)
    for n in (100, 250, 500, 750, 1000)
    for p in (0.10, 0.25, 0.50, 0.75, 1.00)
]
