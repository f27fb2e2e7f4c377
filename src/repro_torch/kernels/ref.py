"""Plain PyTorch oracles for the RTAC kernels.

The counterpart of `repro.kernels.ref`. ``revise_ref`` is the ground truth
for one recurrence of Eq. 1 (incremental, Prop. 2 masked form):
violated[x, a] == some *changed* neighbour y gives (x, a) no support.

Packed words are ``int32`` tensors holding the reference's little-endian
uint32 bit patterns (PyTorch has no ``>>``/``<<``/``~`` for uint32 on the
CPU); compare with the reference through ``numpy .view(np.uint32)``.
Packing ORs the bit lanes together, never sums them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _weights(device: torch.device) -> Tensor:
    """Little-endian bit weights 1 << i as int32 bit patterns (bit 31 is
    negative), kept per device: a host→device copy per call would block."""
    bits = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(bits).to(device)


def support_counts_ref(cons: Tensor, dom: Tensor) -> Tensor:
    """counts[x, y, a] = |{b in dom(y) : cons[x,y,a,b]}| — Alg. 1 line 14."""
    return torch.einsum("xyab,yb->xya", cons.float(), dom.float())


def has_support_ref(cons: Tensor, mask: Tensor, dom: Tensor) -> Tensor:
    """has[x, y, a] — support exists, or (x, y) unconstrained."""
    return (support_counts_ref(cons, dom) > 0) | ~mask[:, :, None]


def revise_ref(cons: Tensor, mask: Tensor, dom: Tensor, changed: Tensor) -> Tensor:
    """violated[x, a] (n, d) bool — the quantity every revise kernel produces."""
    has = has_support_ref(cons, mask, dom)
    return (changed[None, :, None] & ~has).any(dim=1)


def pack_bits_ref(bits: Tensor) -> Tensor:
    """Pack a trailing bool axis into 32-bit words (little-endian bit order).

    (..., d) bool -> (..., ceil(d/32)) int32 (uint32 bit patterns)."""
    *lead, d = bits.shape
    w = -(-d // 32)
    lanes = torch.zeros((*lead, w * 32), dtype=torch.int32, device=bits.device)
    lanes[..., :d] = bits
    lanes = lanes.view(*lead, w, 32) * _weights(bits.device)
    while lanes.shape[-1] > 1:  # OR-reduce the 32 lanes, halving each step
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] | lanes[..., half:]
    return lanes[..., 0]


def unpack_bits_ref(words: Tensor, d: int) -> Tensor:
    """Inverse of `pack_bits_ref`: (..., W) words -> (..., d) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :d].bool()


def revise_packed_ref(cons_packed: Tensor, mask: Tensor, dom_packed: Tensor,
                      changed: Tensor) -> Tensor:
    """Bitpacked oracle: support test is AND over words, nonzero anywhere.

    cons_packed (n, n, d, W) int32, mask (n, n) bool, dom_packed (n, W)
    int32, changed (n,) bool -> violated (n, d) bool."""
    anded = cons_packed & dom_packed[None, :, None, :]  # (n, n, d, W)
    has = (anded != 0).any(dim=-1) | ~mask[:, :, None]  # (n, n, d)
    return (changed[None, :, None] & ~has).any(dim=1)
