"""Shape-bucketed admission — the counterpart of `repro.service.buckets`.

Each request's ``(n_vars, dom_size)`` is rounded up to the next power of two
(with a small floor), the CSP is padded into that bucket under the padding
contract, and every request in a bucket shares one slot pool and one
lockstep round a step. O(log n · log d) bucket shapes cover every request;
the kernels take each bucket's padded shape as it comes.

Padding preserves search semantics exactly: padded variables are unconstrained
with singleton domain {0} (never change, never violate, never trip wipeout),
padded values are absent everywhere, and `core.search._mac_coroutine` takes
``n_active`` so padded variables are born assigned and never branched on — a
padded search takes bit-identical decisions to the unpadded one.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.csp import CSP
from repro_torch.core.engine import next_pow2, pad_dom


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One shared compilation shape: requests with n ≤ n_p, d ≤ d_p land here."""

    n_p: int
    d_p: int

    def contains(self, n: int, d: int) -> bool:
        return n <= self.n_p and d <= self.d_p

    @property
    def network_nbytes(self) -> int:
        """Resident bytes of ONE prepared network in this bucket (bool cons
        O(n_p²·d_p²) + bool mask O(n_p²)) — the cache's accounting unit."""
        return self.n_p * self.n_p * self.d_p * self.d_p + self.n_p * self.n_p

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"({self.n_p}x{self.d_p})"


def _round_up_pow2(x: int, floor: int) -> int:
    return next_pow2(max(x, floor))


def bucket_for(n: int, d: int, n_floor: int = 8, d_floor: int = 4) -> Bucket:
    """The admission bucket for a request of shape (n, d): each axis rounds up
    to the next power of two, floored so tiny requests coalesce. Idempotent on
    its own output (``bucket_for(n_p, d_p) == Bucket(n_p, d_p)``)."""
    if n < 1 or d < 1:
        raise ValueError(f"bucket_for: need n, d >= 1, got ({n}, {d})")
    return Bucket(_round_up_pow2(n, n_floor), _round_up_pow2(d, d_floor))


def speculative_budget(
    split: int,
    portfolio: int,
    queue_depth: int,
    spare_rows: int,
    queue_limit: int,
) -> tuple:
    """Size one request's speculative duplication against live load
    (DESIGN.md §9): speculation fills SLACK — it must never starve queued
    requests of rows or admission throughput.

    - At or beyond ``queue_limit`` queued requests (or with ≤ 1 spare row),
      speculation is off entirely: ``(0, 0)``.
    - Otherwise the request may claim ``spare_rows // (1 + queue_depth) - 1``
      extra rows (its own row is not speculative) — an even hypothetical
      share of the slack against everyone waiting, split-first (subtree
      siblings reuse resident parent rows; portfolio racers re-upload roots).

    Returns ``(split_eff, portfolio_eff)`` clamped budgets. Grant/deny
    outcomes publish into the obs registry (``speculation.*``)."""
    wanted = max(0, split) + max(0, portfolio)
    if queue_depth >= queue_limit or spare_rows <= 1:
        if wanted:
            obs.counter_add("speculation.denied")
        return 0, 0
    allowed = max(0, spare_rows // (1 + queue_depth) - 1)
    split_eff = min(max(0, split), allowed)
    portfolio_eff = min(max(0, portfolio), allowed - split_eff)
    if wanted:
        granted = split_eff + portfolio_eff
        if granted == 0:
            obs.counter_add("speculation.denied")
        else:
            obs.counter_add("speculation.split_granted", split_eff)
            obs.counter_add("speculation.portfolio_granted", portfolio_eff)
            if granted < wanted:
                obs.counter_add("speculation.clamped")
    return split_eff, portfolio_eff


def pad_csp(csp: CSP, bucket: Bucket) -> CSP:
    """Pad a CSP into its bucket shape under the §2 contract. The AC closure
    and the MAC search restricted to the original (n, d) slice are unchanged.
    The padded tensors are zeros written in place, on the CSP's device."""
    n, d = csp.dom.shape
    if not bucket.contains(n, d):
        raise ValueError(f"csp shape ({n}, {d}) does not fit bucket {bucket}")
    n_p, d_p = bucket.n_p, bucket.d_p
    if n_p == n and d_p == d:
        return csp
    cons = torch.zeros((n_p, n_p, d_p, d_p), dtype=torch.bool, device=csp.device)
    cons[:n, :n, :d, :d] = csp.cons
    mask = torch.zeros((n_p, n_p), dtype=torch.bool, device=csp.device)
    mask[:n, :n] = csp.mask
    return CSP(cons=cons, mask=mask, dom=pad_dom(csp.dom, n_p, d_p))
