"""The least time the card could take for a revise or fixpoint call.

A frozen copy of the byte and operation count of ``chip_smoke.work_bound``:
each needed input byte is read once, each output byte written once, and one
32-bit AND is done for every 4 bytes of every constrained (x, a, seeded y)
entry. The seeds of each recurrence come from the benchmark's own plain
fixpoint (`reference.fixpoint`), so the bound counts the same work whatever
implements it. Peaks: NVIDIA's data sheet for one H100 SXM (80 GB HBM3).

Kernel coordinates follow the port's padding contract, copied here: n and d
round up to multiples of 8, and a packed entry (x, a, y) is ceil(d_p/32)
32-bit words.
"""

from __future__ import annotations

from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: the padding multiples of the variable and value axes
N_MULT = 8
D_MULT = 8


def padded(n: int, d: int):
    """(n_p, d_p, entry bytes of a packed network)."""
    n_p = -(-n // N_MULT) * N_MULT
    d_p = -(-d // D_MULT) * D_MULT
    return n_p, d_p, 4 * -(-d_p // 32)


class Bound:
    """Bytes and ANDs of calls, each call bound by the larger of its two
    times; a call's parts may be added in several pieces under one key."""

    def __init__(self):
        self.parts: Dict[object, list] = {}
        self.pieces = 0

    def add(self, call, nbytes: int, ands: int) -> None:
        part = self.parts.setdefault(call, [0, 0])
        part[0] += nbytes
        part[1] += ands
        self.pieces += 1

    def seconds(self, scale: float = 1.0) -> float:
        """The calls' least time, with every count multiplied by ``scale``."""
        return sum(max(scale * b / HBM_BYTES_PER_S, scale * a / ALU_OPS_PER_S)
                   for b, a in self.parts.values())


def call_bytes(cols: torch.Tensor, nets: torch.Tensor, seeds, n_p: int, d_p: int,
               entry: int, out_bytes: int, idx_bytes: int):
    """(bytes, ANDs) of one call whose rows use networks ``nets`` (R,) and
    whose recurrences seed ``seeds`` ((R, n) bool each). ``cols[net, y]`` is
    the number of constrained x of column y in that network."""
    r = nets.shape[0]
    nets = nets.to(cols.device).long()
    hits = torch.zeros(cols.shape, dtype=torch.int32, device=cols.device)
    ands = 0
    for seed in seeds:
        seed = seed.to(cols.device)
        hits.index_add_(0, nets, seed.to(torch.int32))  # distinct (network, y) read once
        ands += int((cols[nets] * seed).sum()) * d_p * entry // 4
    touched = hits > 0
    col_x = int((cols * touched).sum())
    # column slices, their mask columns (n_p bytes each), every row's padded
    # domains, seeds and routing, and the outputs
    nbytes = (col_x * d_p * entry + int(touched.sum()) * n_p
              + r * (n_p * entry + n_p + idx_bytes) + out_bytes)
    return nbytes, ands
