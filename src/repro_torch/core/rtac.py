"""RTAC — Recurrent Tensor Arc Consistency enforcement (paper Eq. 1 / Alg. 1).

The PyTorch counterpart of `repro.core.rtac`. Where the reference runs each
fixpoint as one ``lax.while_loop``, here every fixpoint is a host loop that
synchronizes once per recurrence (one ``bool(...)`` on the loop predicate),
and ``vmap`` becomes an explicit leading batch axis. Two variants:

- :func:`enforce_full` — the bare recurrence of Eq. 1: every step recomputes
  the support test for all (x, a) pairs (the paper-faithful baseline).
- :func:`enforce` — the incremental variant licensed by Proposition 2: the
  revision test is masked to neighbours whose domain changed last step.

Support-test convention: ``cons`` holds zero blocks for unconstrained pairs
and ``mask`` marks real constraints, so

    has_support[x, y, a] = (Σ_b cons[x,y,a,b]·dom[y,b] > 0) | ~mask[x, y]

Batched forms freeze a row once it is inactive (``consistent & any(changed)``
false), so per-row results — domains, verdicts and recurrence counts ``k`` —
equal solo runs, exactly as the reference's vmapped ``while_loop``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs

Tensor = torch.Tensor

# support_fn(cons, mask, dom) -> has_support bool (..., n, n, d)
SupportFn = Callable[[Tensor, Tensor, Tensor], Tensor]


def einsum_support(cons: Tensor, mask: Tensor, dom: Tensor) -> Tensor:
    """The paper's ``matmul`` (Alg. 1 line 14) in einsum form, over any leading
    batch axes (broadcast between ``cons`` and ``dom``). float32 is exact:
    only ``count > 0`` is tested and counts are at most d."""
    cnt = torch.einsum("...xyab,...yb->...xya", cons.float(), dom.float())
    return (cnt > 0) | ~mask[..., :, :, None]


class EnforceResult(NamedTuple):
    dom: Tensor  # (..., n, d) bool — the AC closure (valid only if consistent)
    consistent: Tensor  # (...) bool — False iff some domain wiped out
    n_recurrences: Tensor  # (...) int32 — K of Eq. 1 (Table 1 "#Recurrence")


# revise_fn(network, dom, changed) -> violated (..., n, d) bool:
#   violated[x,a] == some *changed* neighbour y offers no support for (x,a).
ReviseFn = Callable


def make_einsum_revise(support_fn: SupportFn = einsum_support) -> ReviseFn:
    def revise(network, dom, changed):
        cons, mask = network
        has = support_fn(cons, mask, dom)  # (..., n, n, d)
        # (x,a) dies iff some *changed* neighbour y offers no support (Alg.1 l.16)
        return (changed[..., None, :, None] & ~has).any(dim=-2)

    return revise


_EINSUM_REVISE = make_einsum_revise()
_REVISE_CACHE: dict = {}


def _revise_for(support_fn: SupportFn) -> ReviseFn:
    if support_fn is einsum_support:
        return _EINSUM_REVISE
    return _REVISE_CACHE.setdefault(support_fn, make_einsum_revise(support_fn))


def _alive(dom: Tensor) -> Tensor:
    """(..., n, d) -> (...) bool: no variable's domain is empty."""
    return ~(dom.sum(dim=-1) == 0).any(dim=-1)


def _fixpoint_rows(step, dom: Tensor, changed0: Tensor) -> EnforceResult:
    """R fixpoints at once. ``step(dom, seed) -> new_dom`` is one recurrence
    over all rows; a row is *active* while ``consistent & any(changed)``, an
    inactive row is frozen (its seed zeroed, its domain kept, its ``k`` not
    counted), so each row's result equals its solo run. One host sync per
    recurrence (the loop predicate), and one before the first: ``max(k) + 1``
    ``sync.wait`` a call, each of the ``max(k)`` ``fixpoint.recurrence``
    spans holding its step and the predicate after it."""
    consistent = _alive(dom)  # (R,)
    changed = changed0 & consistent[:, None]
    k = torch.zeros(dom.shape[0], dtype=torch.int32, device=dom.device)
    active = consistent & changed.any(dim=-1)
    with obs.sync_wait():
        go = bool(active.any())
    while go:
        with obs.span("fixpoint.recurrence", cat="fixpoint"):
            new = step(dom, changed & active[:, None])
            new = torch.where(active[:, None, None], new, dom)
            changed = (new != dom).any(dim=-1)
            consistent = consistent & _alive(new)
            k += active.to(torch.int32)
            dom = new
            active = consistent & changed.any(dim=-1)
            with obs.sync_wait():
                go = bool(active.any())
    return EnforceResult(dom, consistent, k)


def _seed(changed0: Optional[Tensor], dom: Tensor) -> Tensor:
    if changed0 is None:
        return torch.ones(dom.shape[:-1], dtype=torch.bool, device=dom.device)
    return changed0.to(device=dom.device, dtype=torch.bool)


def enforce_generic(network, dom: Tensor, changed0: Optional[Tensor] = None,
                    revise_fn: ReviseFn = _EINSUM_REVISE) -> EnforceResult:
    """Incremental RTAC (Prop. 2) over an opaque network representation."""
    res = enforce_batch_generic(network, dom[None], None if changed0 is None
                                else _seed(changed0, dom)[None], revise_fn)
    return EnforceResult(res.dom[0], res.consistent[0], res.n_recurrences[0])


def enforce(cons: Tensor, mask: Tensor, dom: Tensor,
            changed0: Optional[Tensor] = None,
            support_fn: SupportFn = einsum_support) -> EnforceResult:
    """Incremental RTAC (Prop. 2). ``changed0`` seeds the revision set — all
    variables for a fresh network, ``one_hot(idx)`` after an assignment."""
    return enforce_generic((cons, mask), dom, changed0, revise_fn=_revise_for(support_fn))


def _full_step(cons, mask, support_fn):
    def step(dom, seed):
        del seed  # Eq. 1 re-tests every pair
        alive = support_fn(cons, mask, dom).all(dim=-2)  # supported on EVERY y
        return dom & alive

    return step


def enforce_full(cons: Tensor, mask: Tensor, dom: Tensor,
                 support_fn: SupportFn = einsum_support) -> EnforceResult:
    """Paper-faithful dense recurrence (Eq. 1, no incrementality)."""
    res = enforce_full_batch(cons, mask, dom[None], support_fn)
    return EnforceResult(res.dom[0], res.consistent[0], res.n_recurrences[0])


def enforce_full_batch(cons: Tensor, mask: Tensor, dom: Tensor,
                       support_fn: SupportFn = einsum_support) -> EnforceResult:
    """Batched paper-faithful recurrence: B domains, one shared network."""
    return _fixpoint_rows(_full_step(cons, mask, support_fn), dom, _seed(None, dom))


# ---------------------------------------------------------------------------
# Batched enforcement: one shared network, B candidate domains.
# ---------------------------------------------------------------------------


def enforce_batch_generic(network, dom: Tensor, changed0: Optional[Tensor] = None,
                          revise_fn: ReviseFn = _EINSUM_REVISE) -> EnforceResult:
    def step(d, seed):
        return d & ~revise_fn(network, d, seed)

    return _fixpoint_rows(step, dom, _seed(changed0, dom))


def enforce_batch(cons: Tensor, mask: Tensor, dom: Tensor,
                  changed0: Optional[Tensor] = None,
                  support_fn: SupportFn = einsum_support) -> EnforceResult:
    return enforce_batch_generic((cons, mask), dom, changed0,
                                 revise_fn=_revise_for(support_fn))


# ---------------------------------------------------------------------------
# Multi-instance enforcement — R domains, each against its OWN network.
# ``networks`` is a tuple of tensors with a leading instance axis (B, ...);
# ``instance_idx ∈ [0,B)^R`` maps each domain row to its network.
# ---------------------------------------------------------------------------


def _gather(networks, instance_idx: Tensor):
    return tuple(t[instance_idx] for t in networks)


def enforce_many_generic(networks, dom: Tensor, changed0: Optional[Tensor],
                         instance_idx: Tensor,
                         revise_fn: ReviseFn = _EINSUM_REVISE) -> EnforceResult:
    """R incremental fixpoints over per-row gathered networks (the
    reference's gather + vmap)."""
    return enforce_batch_generic(_gather(networks, instance_idx), dom, changed0, revise_fn)


# revise_rows_fn(tables, idx, doms, changed) -> violated (R, n, d) bool — the
# stacked revise: row i is revised against ``tables[idx[i]]``. It takes the
# slot tables and the routing, not gathered networks, so a kernel can read
# each row's network in place (`repro_torch.kernels.ops`).
ReviseRowsFn = Callable


def enforce_rows_generic(networks, dom: Tensor, changed0: Optional[Tensor],
                         instance_idx: Tensor,
                         revise_rows_fn: ReviseRowsFn) -> EnforceResult:
    """R incremental fixpoints, row i against ``networks[instance_idx[i]]``,
    as ONE host loop over a *stacked* revise: every recurrence revises all
    still-active rows in a single launch. A row is active while
    ``consistent & any(changed)``; an inactive row's seed is zeroed (the
    incremental revise is then a no-op) and ``k`` counts only the steps the
    row was active — per-row results equal solo `enforce_generic` runs."""

    def step(d, seed):
        return d & ~revise_rows_fn(networks, instance_idx, d, seed)

    return _fixpoint_rows(step, dom, _seed(changed0, dom))


def enforce_full_many(cons: Tensor, mask: Tensor, dom: Tensor, instance_idx: Tensor,
                      support_fn: SupportFn = einsum_support) -> EnforceResult:
    return enforce_full_batch(cons[instance_idx], mask[instance_idx], dom, support_fn)


# ---------------------------------------------------------------------------
# Fused assign + revise — the frontier dispatch.
# ---------------------------------------------------------------------------


def assign_and_seed(doms: Tensor, var: Tensor, val: Tensor) -> Tuple[Tensor, Tensor]:
    """Batched Alg. 2 ``assign`` fused with the Prop. 2 revision seed.

    Row i collapses ``dom(var[i])`` to ``{val[i]}`` and seeds
    ``changed = one_hot(var[i])``; ``var[i] < 0`` marks a *root* row — the
    domain is left untouched and every variable is seeded.
    Returns (doms', changed) of shapes (R, n, d) / (R, n)."""
    r, n, d = doms.shape
    is_root = var < 0
    safe_var = var.clamp(min=0).long()
    rows = torch.arange(r, device=doms.device)
    assigned = doms.clone()
    assigned[rows, safe_var] = (
        torch.arange(d, device=doms.device)[None, :] == val.long()[:, None]
    )
    doms = torch.where(is_root[:, None, None], doms, assigned)
    onehot = torch.arange(n, device=doms.device)[None, :] == safe_var[:, None]
    changed = torch.where(is_root[:, None], torch.ones_like(onehot), onehot)
    return doms, changed


def assign_enforce_many(networks, doms: Tensor, var: Tensor, val: Tensor,
                        instance_idx: Tensor,
                        revise_fn: ReviseFn = _EINSUM_REVISE) -> EnforceResult:
    """Fused frontier dispatch for the contraction engines: assignment + seed
    + the gathered incremental fixpoint of `enforce_many_generic`."""
    doms, changed = assign_and_seed(doms, var, val)
    return enforce_many_generic(networks, doms, changed, instance_idx, revise_fn=revise_fn)


def assign_enforce_full_many(cons: Tensor, mask: Tensor, doms: Tensor, var: Tensor,
                             val: Tensor, instance_idx: Tensor,
                             support_fn: SupportFn = einsum_support) -> EnforceResult:
    """Fused frontier dispatch for the paper-faithful recurrence (Eq. 1
    ignores the revision seed)."""
    doms, _ = assign_and_seed(doms, var, val)
    return enforce_full_many(cons, mask, doms, instance_idx, support_fn=support_fn)


def assign(dom: Tensor, var_idx, val_idx) -> Tensor:
    """Alg. 2 ``assign``: collapse dom(var) to {val}."""
    out = dom.clone()
    out[var_idx] = False
    out[var_idx, val_idx] = True
    return out
