"""Frozen copy of the port's hashed model-A generator
(`repro_torch.core.csp.hashed_random_csp`), and the same network's
constrained pairs recomputed from the hash (`hashed_pairs`), which the
reference reads without the dense (n, n, d, d) tensor. Kept apart from
`generators` so that the numpy generators import no torch.
"""

from __future__ import annotations

import torch

_WORD = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _WORD
    h = h ^ (h >> 15)
    h = (h * 0x6A2C5B3F) & _WORD
    return h ^ (h >> 16)


def _pair_hash(base, lo, hi):
    return _mix32(_mix32(base ^ lo) ^ hi)


def _constrained(pair, density, xs, ys):
    return (_mix32(pair ^ 0x5BD1E995) < density * 2**32) & (xs != ys)


def _allowed(pair, xs, ys, a, b, tightness):
    """cons[x, y, a, b] of constrained pairs, from the pair hash."""
    first = (xs < ys)[..., None, None]
    va, vb = torch.where(first, a, b), torch.where(first, b, a)  # values of lo, hi
    tup = _mix32(pair[..., None, None] ^ (1 + va + (vb << 16)))
    return tup >= tightness * 2**32


def hashed_random_csp(n_vars: int, dom_size: int, density: float, tightness: float = 0.3,
                      seed: int = 0, device="cuda"):
    """Dense (cons, mask, dom) of the hashed model-A network on ``device``."""
    n, d = n_vars, dom_size
    cons = torch.zeros((n, n, d, d), dtype=torch.bool, device=device)
    mask = torch.zeros((n, n), dtype=torch.bool, device=device)
    ys = torch.arange(n, device=device)[None]
    a = torch.arange(d, device=device)[:, None]
    b = torch.arange(d, device=device)[None, :]
    base = _mix32(torch.tensor(seed & _WORD, dtype=torch.int64, device=device))
    step = max(1, (1 << 24) // (n * d * d))
    for x0 in range(0, n, step):
        xs = torch.arange(x0, min(n, x0 + step), device=device)[:, None]
        lo, hi = torch.minimum(xs, ys), torch.maximum(xs, ys)
        pair = _pair_hash(base, lo, hi)
        mask[x0:x0 + xs.shape[0]] = _constrained(pair, density, xs, ys)
        cons[x0:x0 + xs.shape[0]] = (_allowed(pair, xs, ys, a, b, tightness)
                                     & mask[x0:x0 + xs.shape[0], :, None, None])
    return cons, mask, torch.ones((n, d), dtype=torch.bool, device=device)


def hashed_pairs(n_vars: int, dom_size: int, density: float, tightness: float = 0.3,
                 seed: int = 0, device="cpu"):
    """The hashed network's constrained ordered pairs without the dense
    tensor: (xs, ys, blocks) with ``blocks[i] == cons[xs[i], ys[i]]`` (d, d),
    recomputed from the hash."""
    n, d = n_vars, dom_size
    base = _mix32(torch.tensor(seed & _WORD, dtype=torch.int64, device=device))
    ys_all = torch.arange(n, device=device)[None]
    xs_out, ys_out = [], []
    step = max(1, (1 << 24) // n)
    for x0 in range(0, n, step):
        xs = torch.arange(x0, min(n, x0 + step), device=device)[:, None]
        pair = _pair_hash(base, torch.minimum(xs, ys_all), torch.maximum(xs, ys_all))
        px, py = _constrained(pair, density, xs, ys_all).nonzero(as_tuple=True)
        xs_out.append(px + x0)
        ys_out.append(py)
    xs, ys = torch.cat(xs_out), torch.cat(ys_out)
    a = torch.arange(d, device=device)[:, None]
    b = torch.arange(d, device=device)[None, :]
    blocks = torch.empty((xs.shape[0], d, d), dtype=torch.bool, device=device)
    step = max(1, (1 << 24) // (d * d))
    for i in range(0, xs.shape[0], step):
        x, y = xs[i:i + step], ys[i:i + step]
        pair = _pair_hash(base, torch.minimum(x, y), torch.maximum(x, y))
        blocks[i:i + step] = _allowed(pair, x, y, a, b, tightness)
    return xs, ys, blocks


