"""MAC backtrack search (paper Alg. 2) over any registered enforcement Engine.

The PyTorch counterpart of `repro.core.search`. The search itself is host
numpy and ported line for line; only the engines, the `FrontierTable` and
the entry points' ``device=`` argument (default ``"cuda"``) differ.

``mac_solve`` prepares the constraint network ONCE (`Engine.prepare`) and then
maintains arc consistency after every assignment against the resident prepared
network, recording per-assignment statistics — exactly the quantities of paper
Table 1 (#Recurrence for the tensor engines / #Revision for AC3, averaged over
assignments, kept in separate fields) and Fig. 3 (time per assignment).

Beyond the paper, two batching axes (DESIGN.md §6) and a residency axis (§8):

- **Frontier batching** (within one search): all candidate values of the
  branching variable are enforced in one ``enforce_batch`` dispatch — one
  device round-trip per search *node* instead of per *child*. Pass
  ``batched_children=False`` for the classical one-child-at-a-time schedule.
  Engines with ``supports_batch=False`` (the sequential AC3 baseline, where
  eager batching is pure extra work) always use the classical schedule.
- **Instance batching** (across searches): ``solve_many`` runs B independent
  CSPs sharing (n, d) to completion. On batch-capable engines the searches
  advance in *lockstep*: each round resolves every active search's pending
  enforcement frontier in ONE dispatch, so a whole workload shares each device
  round-trip. Every search still takes exactly the decisions it would take
  alone — solutions and per-instance statistics are identical to sequential
  ``mac_solve`` (only wall-clock attribution differs).
- **Device residency** (DESIGN.md §8): on ``Engine.device_frontier`` backends
  the domains themselves never leave the device. The search coroutine speaks
  *row handles + decisions* — it never sees a domain tensor — and the lockstep
  round is one fused gather→assign→enforce→MRV dispatch against a
  `core.engine.FrontierTable`, shipping only O(R·d) metadata to the host
  (consistency bits, recurrence counts, the branching decision and its d-bit
  value row — domain sizes and assignment masks stay device-resident). Full
  domains cross the boundary exactly twice per search: the root upload at
  admission and the closure fetch at solution extraction. Engines without the
  capability (AC3, sharded) get `HostFrontierStore` — the same protocol with
  numpy-resident closures, bit-identical by construction.

The search logic itself is written once, as a coroutine that *yields*
enforcement requests and receives decision replies. `LockstepDriver`
multiplexes any number of coroutines over one `FrontierStore` in an **open
world**: searches are admitted between rounds (their root request simply rides
the next dispatch) and finished searches free their rows mid-flight — the
substrate of both the closed-batch ``solve_many`` portfolio and the
continuous-batching solver service (DESIGN.md §7). Rounds are
*pipelined*: ``round()`` launches the next dispatch asynchronously (CUDA's
asynchronous launch) and resolves it on the following call, so enforcement runs on device
while the host admits work, retires requests, and drives other buckets.
``engine`` accepts an `Engine` instance or a registry name
(`repro_torch.engines.available_engines()`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import sys
import threading
import time
import warnings
from typing import (
    Any,
    Dict,
    Generator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from repro_torch import faults, obs
from repro_torch.device import Device, to_numpy

from .ac3 import assign_np
from .csp import CSP
from .engine import (
    Engine,
    FrontierRow,
    FrontierTable,
    Instance,
    RoundMeta,
    frontier_capacity,
    instance_csp,
    next_pow2 as _next_pow2,
    pad_round_rows,
)
from .rtac import EnforceResult


@dataclasses.dataclass
class SearchStats:
    n_assignments: int = 0
    n_backtracks: int = 0
    # Per-enforcement work counters, SEPARATED by unit (Table 1 honesty):
    # tensor-engine fixpoint recurrence counts vs AC3 revise-call counts.
    recurrences: List[int] = dataclasses.field(default_factory=list)
    revisions: List[int] = dataclasses.field(default_factory=list)
    enforce_seconds: List[float] = dataclasses.field(default_factory=list)
    #: kernel launches billed to this search's enforcement rounds (a fused
    #: in-kernel fixpoint on the device frontier bills 1 per round; the
    #: stepped path and the host stores of ``mac_solve`` bill the round's max
    #: recurrence depth, the reference's bill). Host engines leave it 0.
    launches: int = 0
    #: True iff the search stopped on its ``max_assignments`` budget — a
    #: (None, stats) result with ``exhausted=True`` is *inconclusive*, NOT a
    #: proof of unsatisfiability.
    exhausted: bool = False
    #: lockstep rounds this search's rows rode (1 dispatch each in
    #: ``mac_solve``; shared dispatches under `LockstepDriver`) — the
    #: per-instance rounds-to-solution the `solve_many` telemetry histograms.
    rounds: int = 0
    #: frontier rows dispatched on this search's behalf (== requests enforced
    #: solo; the group total under speculation — the service's
    #: ``rows_per_request`` metric).
    rows: int = 0
    #: speculative members this request occupied (owner + split siblings +
    #: portfolio racers, DESIGN.md §9). 1 = no speculation; the stats object
    #: is SHARED across a group, so every counter above is the group total.
    members: int = 1
    #: members cancelled when the group resolved (first SAT wins / UNSAT
    #: needs the whole cover) — speculative work thrown away.
    cancelled_members: int = 0
    #: non-None iff the round watchdog evicted this search mid-flight; the
    #: string names the breached bound. A quarantined ``(None, stats)`` result
    #: is a FAILURE verdict, never a proof of unsatisfiability — consumers
    #: must check this BEFORE reading ``None`` as UNSAT.
    quarantined: Optional[str] = None

    @property
    def mean_recurrences(self) -> float:
        return float(np.mean(self.recurrences)) if self.recurrences else 0.0

    @property
    def mean_revisions(self) -> float:
        return float(np.mean(self.revisions)) if self.revisions else 0.0

    @property
    def mean_enforce_ms(self) -> float:
        return 1e3 * float(np.mean(self.enforce_seconds)) if self.enforce_seconds else 0.0


class BudgetExceeded(Exception):
    pass


def _select_var(dom_np: np.ndarray, assigned: np.ndarray) -> int:
    """Minimum-remaining-values heuristic (paper leaves `heuristics()` open).
    The device frontier computes exactly this (first argmin over unassigned
    domain sizes) in `core.engine._frontier_step` — same ints, same ties."""
    sizes = dom_np.sum(axis=1).astype(np.int64)
    sizes[assigned] = np.iinfo(np.int64).max
    return int(np.argmin(sizes))


def _select_var_anti(dom_np: np.ndarray, assigned: np.ndarray) -> int:
    """Anti-MRV (largest remaining domain first) — a deliberately contrarian
    portfolio heuristic (DESIGN.md §9). The device frontier's ``want_alt``
    metadata computes exactly this (first argmax, assigned → -1 sentinel)."""
    sizes = dom_np.sum(axis=1).astype(np.int64)
    sizes[assigned] = -1
    return int(np.argmax(sizes))


class PortfolioSpec(NamedTuple):
    """One portfolio racer's decision policy: the branching-variable heuristic
    (``"mrv"`` | ``"anti"``) and the value ordering (``"lex"`` — the oracle's
    native order, ``"flip"`` — reversed, ``"shuffle"`` — seeded random)."""

    heuristic: str = "mrv"
    value_order: str = "lex"
    seed: int = 0


#: the diversity cycle `default_portfolio` deals racers from — maximally
#: different from the owner's (mrv, lex) policy first
_PORTFOLIO_CYCLE = (
    PortfolioSpec("mrv", "flip"),
    PortfolioSpec("anti", "lex"),
    PortfolioSpec("anti", "flip"),
    PortfolioSpec("mrv", "shuffle"),
    PortfolioSpec("anti", "shuffle"),
)


def default_portfolio(k: int, seed: int = 0) -> List[PortfolioSpec]:
    """``k`` racer policies, cycling the diversity deck with distinct seeds."""
    return [
        _PORTFOLIO_CYCLE[i % len(_PORTFOLIO_CYCLE)]._replace(seed=seed + i)
        for i in range(max(0, k))
    ]


def _value_order_fn(order: str, seed: int = 0):
    """The values-tuple transform of a `PortfolioSpec` (None = native order).
    The shuffle RNG is seeded once per member — deterministic for a given
    (spec, search path), which is all verdict parity needs."""
    if order == "lex":
        return None
    if order == "flip":
        return lambda values: tuple(reversed(values))
    if order == "shuffle":
        rng = np.random.default_rng(seed)

        def shuffle(values):
            vs = list(values)
            rng.shuffle(vs)
            return tuple(vs)

        return shuffle
    raise ValueError(f"unknown value_order {order!r}")


def resolve_engine(engine: Union[Engine, str], support_fn=None,
                   device: Device = "cuda") -> Engine:
    """Engine instance passthrough (it keeps its own device), or registry
    lookup by name on ``device``. ``support_fn`` is honoured by the
    einsum-contraction engines."""
    if isinstance(engine, Engine):
        if support_fn is not None:
            warnings.warn(
                "support_fn is ignored when an Engine instance is passed",
                stacklevel=3,
            )
        return engine
    from repro_torch.engines import get_engine

    opts = {}
    if support_fn is not None and engine in ("einsum", "full"):
        opts["support_fn"] = support_fn
    return get_engine(engine, device=device, **opts)


# ---------------------------------------------------------------------------
# The MAC search coroutine — search logic decoupled from dispatch AND data.
# The coroutine never sees a domain tensor: it yields (parent handle, var,
# values) decisions and receives handles plus the on-store MRV selection.
# ---------------------------------------------------------------------------


class _Request(NamedTuple):
    """One pending enforcement: create and enforce the children of ``parent``
    obtained by assigning ``var := v`` for each v in ``values`` (``parent is
    None`` = the root propagation; exactly one implicit row). ``assigned`` is
    the (n,) bool assignment mask the children's own MRV selection must see."""

    parent: Optional[int]
    var: int
    values: Tuple[int, ...]
    assigned: np.ndarray


class _Reply(NamedTuple):
    """Per-child decision metadata — everything dfs needs at the next level.
    ``handles[i]`` is None where the child wiped out (its row was freed);
    ``branch_var``/``values`` are the MRV decision computed ON the closure
    (ignored for inconsistent or fully-assigned children). ``alt_var``/
    ``alt_values`` are the anti-MRV decision — present only when the store
    ships it (`enable_alt`), consumed only by anti-heuristic portfolio
    members."""

    handles: List[Optional[int]]
    consistent: np.ndarray  # (b,) bool
    branch_var: np.ndarray  # (b,) int
    values: List[Optional[Tuple[int, ...]]]
    alt_var: Optional[np.ndarray] = None  # (b,) int
    alt_values: Optional[List[Optional[Tuple[int, ...]]]] = None


_MacGen = Generator[_Request, _Reply, Optional[List[int]]]


#: frames a search's callers may take beyond its own nesting
_DEPTH_MARGIN = 1000
#: the recursion limit the live searches found, and what each of them needs
_DEPTH_LOCK = threading.Lock()
_DEPTH_BASE = [0]
_DEPTH_NEEDS: List[int] = []


@contextlib.contextmanager
def _allow_depth(n_vars: int):
    """Let the interpreter nest a search over ``n_vars`` variables while it
    runs: its `dfs` nests one generator a branching level, at most one a
    variable, and resuming the chain counts every level against the
    recursion limit (a quasigroup with holes of order 40, n = 1,600, goes
    deeper than the default 1,000). The limit is raised to what the live
    searches need and goes back to the one they found when the last of
    them ends."""
    need = 2 * n_vars + _DEPTH_MARGIN
    with _DEPTH_LOCK:
        if not _DEPTH_NEEDS:
            _DEPTH_BASE[0] = sys.getrecursionlimit()
        _DEPTH_NEEDS.append(need)
        sys.setrecursionlimit(max([_DEPTH_BASE[0], *_DEPTH_NEEDS]))
    try:
        yield
    finally:
        with _DEPTH_LOCK:
            _DEPTH_NEEDS.remove(need)
            sys.setrecursionlimit(max([_DEPTH_BASE[0], *_DEPTH_NEEDS]))


def _mac_coroutine(
    dom0: np.ndarray,
    free_fn,
    extract_fn,
    supports_batch: bool,
    batched_children: bool,
    max_assignments: Optional[int],
    stats: SearchStats,
    n_active: Optional[int] = None,
    *,
    heuristic: str = "mrv",
    value_order=None,
    root_spec: Optional[Tuple[int, int, Tuple[int, ...]]] = None,
    assigned0: Optional[np.ndarray] = None,
    split_fn=None,
) -> _MacGen:
    """Alg. 2 as a coroutine: yields `_Request`s, receives `_Reply`s, returns
    the solution (or None), searching from the root domain ``dom0`` (n, d)
    bool. The coroutine owns every search decision and the
    assignment/backtrack counters; the driver owns dispatch, padding, timing
    and work-counter recording — so one search behaves identically whether it
    is driven alone (`mac_solve`) or multiplexed with others (`solve_many`),
    against host-resident closures or a device `FrontierTable`.

    ``free_fn(handle)`` releases a node the search will never revisit (a dead
    branch); ``extract_fn(handle)`` fetches a closure as a numpy (n, d) array —
    called exactly once, at solution extraction.

    ``n_active`` marks the first ``n_active`` variables as the real problem:
    variables beyond it (bucket padding under the §2 contract — unconstrained,
    singleton domain) start out assigned, are never branched on, and are
    excluded from the returned solution, so a padded search takes bit-identical
    decisions to the unpadded one.

    Speculation hooks (DESIGN.md §9; all default off — the oracle path above
    is byte-for-byte the classical search):

    - ``heuristic``: ``"mrv"`` (the oracle) or ``"anti"`` — branch on the
      reply's anti-MRV decision instead (requires the store's alt metadata).
    - ``value_order``: optional tuple transform applied to each node's value
      list (portfolio value diversity).
    - ``root_spec=(parent, var, values)``: start as a *split sibling* — the
      first request is a child-create against the (foreign, still-resident)
      ``parent`` row instead of a root propagation; ``assigned0`` is the
      assignment mask at the split node. The sibling touches the foreign row
      exactly once, at its first yield, which the driver dispatches while the
      owner still holds the row — after that every row it reads is its own.
    - ``split_fn(handle, var, values, assigned)``: called at every node with
      >1 values; returns the values THIS coroutine keeps and queues sibling
      spawns for the rest (the driver's group budget decides how many).
    """
    n, _ = dom0.shape
    n_real = n if n_active is None else n_active

    if assigned0 is not None:
        assigned = np.array(assigned0, dtype=bool)
    else:
        assigned = np.zeros((n,), dtype=bool)
        assigned[n_real:] = True

    anti = heuristic == "anti"
    if heuristic not in ("mrv", "anti"):
        raise ValueError(f"unknown heuristic {heuristic!r}")

    def decide(reply: _Reply, i: int) -> Tuple[int, Optional[Tuple[int, ...]]]:
        if anti:
            if reply.alt_var is None:
                raise RuntimeError(
                    "anti-MRV member needs a store with alt metadata "
                    "(FrontierStore.enable_alt) — the driver enables it at "
                    "group admission"
                )
            return int(reply.alt_var[i]), reply.alt_values[i]
        return int(reply.branch_var[i]), reply.values[i]

    def solution_of(handle: int) -> List[int]:
        dom_np = extract_fn(handle)
        return [int(np.argmax(dom_np[x])) for x in range(n_real)]

    def dfs(handle: int, var: int, values: Tuple[int, ...]) -> _MacGen:
        if assigned.all():
            return solution_of(handle)

        if value_order is not None and len(values) > 1:
            values = tuple(value_order(values))
        if split_fn is not None and len(values) > 1:
            values = split_fn(handle, var, values, assigned)

        child_reply: Optional[_Reply] = None
        child_mask = assigned.copy()
        child_mask[var] = True
        if batched_children and supports_batch and len(values) > 1:
            child_reply = yield _Request(handle, var, values, child_mask)

        assigned[var] = True
        try:
            for i, val in enumerate(values):
                stats.n_assignments += 1
                if max_assignments and stats.n_assignments > max_assignments:
                    raise BudgetExceeded
                if child_reply is not None:
                    child, ok = child_reply.handles[i], bool(child_reply.consistent[i])
                    cvar, cvals = decide(child_reply, i)
                else:
                    r = yield _Request(handle, var, (val,), child_mask)
                    child, ok = r.handles[0], bool(r.consistent[0])
                    cvar, cvals = decide(r, 0)
                if ok:
                    sol = yield from dfs(child, cvar, cvals)
                    if sol is not None:
                        return sol
                    free_fn(child)  # dead branch: its row is reusable now
                stats.n_backtracks += 1
            return None
        finally:
            assigned[var] = False

    with _allow_depth(n):
        try:
            if root_spec is not None:
                parent_h, var0, values0 = root_spec
                return (yield from dfs(parent_h, var0, tuple(values0)))

            # Root propagation (Alg. 2 line 3).
            reply = yield _Request(None, -1, (), assigned.copy())
            if not bool(reply.consistent[0]):
                return None
            var0, values0 = decide(reply, 0)
            return (yield from dfs(reply.handles[0], var0, values0))
        finally:
            # `dfs` refers to itself through its closure, and the closure
            # holds the store's hooks: without this the cycle would keep the
            # store, and with it the prepared network (0.76 GiB on the card
            # at n = 1,600), until the cycle collector ran
            dfs = None  # noqa: F841




# ---------------------------------------------------------------------------
# HostFrontierStore — the host-resident FrontierStore (AC3 / sharded / oracle)
# ---------------------------------------------------------------------------


class _SyncRound:
    """A resolved-at-dispatch round (host stores have nothing in flight)."""

    def __init__(self, meta: RoundMeta):
        self._meta = meta

    def resolve(self) -> RoundMeta:
        return self._meta


class HostFrontierStore:
    """Host-side frontier store — same protocol as `core.engine.FrontierTable`
    with numpy-resident closures: child domains are materialized with
    ``assign_np`` and MRV runs through `_select_var`, exactly the pre-frontier
    dispatch path. This is both the fallback for engines without
    ``device_frontier`` (AC3, sharded) and the semantic oracle the device
    table must match bit-for-bit."""

    pipelined = False

    def __init__(self, n_vars: int, dispatch_rows, pad_rounds: bool = False):
        self._n = n_vars
        self._dispatch_rows = dispatch_rows  # (doms, chs, idx) -> EnforceResult
        self._pad_rounds = pad_rounds
        self._doms: Dict[int, np.ndarray] = {}
        self._of_key: Dict[Any, set] = {}
        self._net_of: Dict[Any, int] = {}
        self._handles = itertools.count()
        self._want_alt = False

    def enable_alt(self) -> None:
        """Ship the anti-MRV decision with every subsequent round (portfolio
        heuristic diversity — mirrors `FrontierTable.enable_alt`)."""
        self._want_alt = True

    def spare_rows(self) -> int:
        """Host closures are heap-allocated — occupancy never limits
        speculation here (admission clamps by the engine hint instead)."""
        return 1 << 20

    def _new_handle(self, key) -> int:
        h = next(self._handles)
        self._of_key[key].add(h)
        return h

    def register(self, key, net: int) -> None:
        """Register a search key with its network routing but no root closure
        — how a split sibling joins: its first request is a child-create
        against the owner's still-resident node."""
        if key in self._of_key:
            raise ValueError(f"search key {key!r} already registered")
        self._of_key[key] = set()
        self._net_of[key] = int(net)

    def begin(self, key, net: int, root_dom: np.ndarray, assigned=None) -> int:
        # ``assigned`` is part of the store protocol (the device table keeps
        # the mask resident); the host store reads it off each request instead
        del assigned
        self.register(key, net)
        h = self._new_handle(key)
        self._doms[h] = np.asarray(root_dom, dtype=bool)
        return h

    def free(self, key, handle: int) -> None:
        if handle in self._of_key.get(key, ()):
            self._of_key[key].discard(handle)
            self._doms.pop(handle, None)

    def release(self, key) -> None:
        for h in self._of_key.pop(key, ()):
            self._doms.pop(h, None)
        self._net_of.pop(key, None)

    def extract(self, key, handle: int) -> np.ndarray:
        return self._doms[handle]

    def _enforce_rows(self, doms, chs, idx, roots) -> EnforceResult:
        r = doms.shape[0]
        r_p = _next_pow2(r) if self._pad_rounds else r
        doms, chs, idx = pad_round_rows((doms, chs, idx), r_p)
        return self._dispatch_rows(doms, chs, idx)

    def dispatch(self, specs: Sequence[FrontierRow], net_idx=None) -> _SyncRound:
        r = len(specs)
        rows, roots = [], np.zeros((r,), dtype=bool)
        chs = np.zeros((r, self._n), dtype=bool)
        for i, s in enumerate(specs):
            parent_dom = self._doms[s.parent]
            if s.var < 0:
                rows.append(parent_dom)
                chs[i] = True
                roots[i] = True
            else:
                rows.append(assign_np(parent_dom, s.var, s.val))
                chs[i, s.var] = True
        doms = np.stack(rows)
        if net_idx is None:
            net_idx = np.fromiter((self._net_of[s.key] for s in specs), np.int32, r)
        # the enforcement up to its read-back (a host-loop fixpoint blocks on
        # its predicate inside: its sync.waits are children of this span)
        with obs.span("kernel.launch", cat="kernel", rows=r) as sp:
            faults.inject("kernel.launch", rows=r)
            res = self._enforce_rows(doms, chs, np.asarray(net_idx, np.int32), roots)
            obs.fence(res.dom)
            if sp is not None:
                sp.args["fenced"] = obs.fencing()
        with obs.sync_wait(rows=r):
            dom_out = to_numpy(res.dom)[:r]
            cons = np.atleast_1d(to_numpy(res.consistent))[:r]
            k = np.atleast_1d(to_numpy(res.n_recurrences))[:r]

        d = dom_out.shape[-1]
        handles: List[Optional[int]] = []
        bvar = np.zeros((r,), np.int32)
        vrow = np.zeros((r, d), dtype=bool)
        avar = np.zeros((r,), np.int32) if self._want_alt else None
        arow = np.zeros((r, d), dtype=bool) if self._want_alt else None
        for i, s in enumerate(specs):
            if not bool(cons[i]):
                handles.append(None)
                continue
            h = s.parent if s.var < 0 else self._new_handle(s.key)
            self._doms[h] = dom_out[i]
            handles.append(h)
            bvar[i] = _select_var(dom_out[i], s.assigned)
            vrow[i] = dom_out[i][bvar[i]]
            if avar is not None:
                avar[i] = _select_var_anti(dom_out[i], s.assigned)
                arow[i] = dom_out[i][avar[i]]
        # the reference's bill for a host store: one enforcement dispatch per
        # iteration of the deepest row, whichever route the engine took (the
        # stepped device frontier's model — `core.engine._PendingFrontierRound.resolve`)
        launches = max(1, int(k.max())) if k.size else 1
        return _SyncRound(RoundMeta(handles, cons, k, bvar, vrow, launches,
                                    avar, arow))


class _SingleSearchStore(HostFrontierStore):
    """`mac_solve`'s store over ONE `PreparedNetwork`: single rows go through
    ``enforce`` (the root keeps the engine-native ``changed0=None`` seed),
    child frontiers through ``enforce_batch`` padded up to a power of two
    (repeating the last child — enforcement is idempotent per element) so the
    batched fixpoint sees O(log d) shapes instead of one per
    frontier size — exactly the pre-frontier dispatch schedule."""

    def __init__(self, prepared):
        super().__init__(prepared.n_vars, None, pad_rounds=False)
        self._prepared = prepared

    def _enforce_rows(self, doms, chs, idx, roots) -> EnforceResult:
        b = doms.shape[0]
        if b == 1:
            res = self._prepared.enforce(doms[0], None if roots[0] else chs[0])
            return EnforceResult(res.dom[None], res.consistent, res.n_recurrences)
        doms, chs = pad_round_rows((doms, chs), _next_pow2(b))
        return self._prepared.enforce_batch(doms, chs)


def _drive_single(store: HostFrontierStore, root: int, gen: _MacGen, req: _Request,
                  counts: List[int], stats: SearchStats,
                  collect_stats: bool) -> Optional[List[int]]:
    """Run one coroutine, primed to its first request ``req``, to completion
    against a single-search store. A round has `LockstepDriver.round`'s
    spans: ``frontier.step`` builds the rows and dispatches them,
    ``round.resolve`` takes the results and advances the coroutine."""
    try:
        while True:
            with obs.span("driver.round", cat="driver"):
                with obs.span("frontier.step", cat="driver") as sp:
                    if req.parent is None:
                        specs = [FrontierRow(0, root, -1, 0, req.assigned, 0)]
                    else:
                        specs = [
                            FrontierRow(0, req.parent, req.var, v, req.assigned, 0)
                            for v in req.values
                        ]
                    if sp is not None:
                        sp.args["rows"] = len(specs)
                    t0 = time.perf_counter()
                    pend = store.dispatch(specs)
                with obs.span("round.resolve", cat="driver", rows=len(specs)):
                    res = pend.resolve()
                    obs.REGISTRY.counter_add("driver.rounds")
                    obs.REGISTRY.counter_add("driver.rows", len(specs))
                    obs.REGISTRY.counter_add("driver.launches", res.launches)
                    stats.rounds += 1
                    stats.rows += len(specs)
                    if collect_stats:
                        stats.enforce_seconds.append(time.perf_counter() - t0)
                        counts.extend(int(v) for v in res.k)
                        stats.launches += res.launches
                    req = gen.send(_Reply(res.handles, res.consistent, res.branch_var,
                                          _value_lists(res.handles, res.value_row)))
    except StopIteration as stop:
        return stop.value


def _value_lists(handles: Sequence[Optional[int]],
                 rows: np.ndarray) -> List[Optional[Tuple[int, ...]]]:
    """Per-row live values of a selected variable (None where the row wiped
    out) — the host side of the d-bit value rows the round shipped back."""
    return [
        tuple(int(v) for v in np.nonzero(rows[i])[0])
        if handles[i] is not None
        else None
        for i in range(len(handles))
    ]


def mac_solve(
    csp: CSP,
    engine: Union[Engine, str] = "einsum",
    support_fn=None,
    max_assignments: Optional[int] = None,
    batched_children: bool = True,
    collect_stats: bool = True,
    split_budget: int = 0,
    portfolio: int = 0,
    portfolio_seed: int = 0,
    device: Device = "cuda",
) -> Tuple[Optional[List[int]], SearchStats]:
    """Returns (solution | None, stats). Raises nothing on budget exhaustion —
    stops and returns (None, stats) with ``stats.n_assignments`` at the cap.

    With ``split_budget > 0`` or ``portfolio > 0`` the single solve becomes a
    speculative *group* (DESIGN.md §9): up to ``split_budget`` tree-split
    siblings plus ``portfolio`` heuristic-diverse racers explore concurrently
    under a shared assignment budget; the first SAT wins, UNSAT needs the
    whole cover. Both default 0 so plain ``mac_solve`` stays the bit-identical
    sequential oracle the parity suite compares everything against. Verdicts
    (SAT/UNSAT) are identical to the oracle's; a budget stop remains
    inconclusive either way. ``device`` places an engine given by name."""
    eng = resolve_engine(engine, support_fn, device)
    speculative = bool(split_budget or portfolio)
    with obs.span("search.prepare", cat="driver"):
        prepared = eng.prepare(csp)  # the ONLY preparation in the whole run
        store = _SingleSearchStore(prepared)
        if speculative:
            driver = LockstepDriver(store, prepared.n_vars, count_unit=eng.count_unit)
            stats = driver.admit_group(
                0, csp.dom,
                split_budget=split_budget,
                portfolio=portfolio,
                portfolio_seed=portfolio_seed,
                supports_batch=eng.supports_batch,
                batched_children=batched_children,
                max_assignments=max_assignments,
                collect_stats=collect_stats,
            )
        else:
            stats = SearchStats()
            dom0 = to_numpy(csp.dom)
            root = store.begin(0, 0, dom0)  # host store: mask per request
            gen = _mac_coroutine(
                dom0,
                functools.partial(store.free, 0),
                functools.partial(store.extract, 0),
                eng.supports_batch,
                batched_children,
                max_assignments,
                stats,
            )
            req = gen.send(None)  # the root request; always yields first
    if speculative:
        sol = None
        while driver.has_work:
            for _k, (s, _st) in driver.round().items():
                sol = s
        return sol, stats
    counts = stats.recurrences if eng.count_unit == "recurrences" else stats.revisions
    try:
        sol = _drive_single(store, root, gen, req, counts, stats, collect_stats)
    except BudgetExceeded:
        stats.exhausted = True
        return None, stats
    finally:
        store.release(0)
    return sol, stats


# ---------------------------------------------------------------------------
# LockstepDriver — open-world lockstep multiplexing (DESIGN.md §6/§7/§8)
# ---------------------------------------------------------------------------


class RoundInfo(NamedTuple):
    """Telemetry of one RESOLVED lockstep round. ``seconds`` spans dispatch
    launch → metadata arrival: on a pipelined store that window deliberately
    overlaps host work done between ``round()`` calls (admissions, other
    buckets' dispatches), so it is an upper bound on the round's device time,
    not a pure enforcement measurement."""

    rows: int
    searches: int
    seconds: float
    launches: int = 1


class _MemberKey(NamedTuple):
    """Store/driver key of one speculative group member: ``(group key, member
    ordinal)``. Member 0 is the owner (the cover's first tile); higher
    ordinals are split siblings and portfolio racers in admission order."""

    group: Any
    m: int


def _sort_key(k):
    """Total order over mixed solo keys and `_MemberKey`s (a solo key sorts
    as member -1 of itself, so one group's members stay adjacent)."""
    return (k.group, k.m) if isinstance(k, _MemberKey) else (k, -1)


@dataclasses.dataclass
class _Group:
    """One speculative request: the members racing on its behalf and the
    resolution state (DESIGN.md §9). The verdict contract:

    - any member returning a solution resolves the group SAT (losers are
      cancelled — their rows free immediately);
    - the ``cover`` set (owner + split siblings, including queued spawns not
      yet admitted) tiles the search tree exactly once: when every cover
      member has returned None un-exhausted, the group is proven UNSAT;
    - a ``complete`` member (portfolio racer — its own full restart of the
      tree) returning None un-exhausted proves UNSAT by itself;
    - ``stats`` is ONE object shared by every member, so ``max_assignments``
      is a group-total budget and the merged counters come for free; any
      member tripping the budget resolves the whole group exhausted
      (inconclusive), eagerly."""

    key: Any
    dom0: np.ndarray  # the root domain (n, d)
    idx: int
    stats: SearchStats
    split_budget: int
    supports_batch: bool
    batched_children: bool
    n_active: Optional[int]
    max_assignments: Optional[int]
    collect: bool
    split_fn: Any = None
    live: set = dataclasses.field(default_factory=set)
    cover: set = dataclasses.field(default_factory=set)
    complete: set = dataclasses.field(default_factory=set)
    done: bool = False
    result: Optional[List[int]] = None
    exhausted: bool = False
    next_m: int = 0


class LockstepDriver:
    """Multiplexes MAC-search coroutines over ONE `FrontierStore`, open-world.

    Each round gathers every live search's pending request into a single
    dispatch against the store — a device-resident `core.engine.FrontierTable`
    on ``device_frontier`` engines (domains never leave the device; only
    per-row metadata crosses the host boundary), a `HostFrontierStore`
    otherwise — scatters the decision replies back, and advances each search
    to its next request. Unlike the closed batch that ``solve_many``
    historically hard-coded, membership is dynamic:

    - ``admit`` joins a new search *between* rounds — its root propagation
      simply rides the next dispatch alongside everyone else's frontiers;
    - a search that finishes (solution, exhaustion, or budget) is reported by
      the ``round()`` that retired it and frees its rows immediately — the
      batch never drains to a stragglers-only tail before new work can enter;
    - ``cancel`` evicts a search mid-flight (deadline expiry in the service).

    Rounds are **pipelined** on stores that advertise ``pipelined=True``:
    ``round()`` resolves the previous dispatch (blocking only on its small
    metadata), advances the coroutines, then launches the next dispatch
    asynchronously and returns — enforcement for round *t+1* runs on device
    while the host retires requests, admits new work, and drives other
    buckets' rounds. Synchronous stores resolve within the same call.

    The driver owns dispatch, routing, timing, and work-counter filing; every
    search still takes exactly the decisions it would take alone (solutions
    and per-instance statistics are bit-identical to sequential `mac_solve` —
    only ``enforce_seconds`` attribution differs, splitting each round's
    wall-clock across participants proportionally to their row counts; the
    per-round attributions sum exactly to the round's measured seconds).
    """

    def __init__(
        self,
        store,
        n_vars: int,
        count_unit: str = "recurrences",
        round_wall_s: Optional[float] = None,
        round_recurrences: Optional[int] = None,
    ):
        self._store = store
        self._n = n_vars
        self._count_unit = count_unit
        # round watchdog bounds (None = unbounded, the solve_many default):
        # a resolved round breaching either evicts its deepest live search
        # via `_quarantine_offender` instead of letting one pathological
        # instance stall every search sharing the lockstep
        if round_wall_s is not None and round_wall_s <= 0:
            raise ValueError("round_wall_s must be positive (or None)")
        if round_recurrences is not None and round_recurrences < 1:
            raise ValueError("round_recurrences must be >= 1 (or None)")
        self._round_wall_s = round_wall_s
        self._round_recurrences = round_recurrences
        self.watchdog_trips = 0
        self._gens: Dict[object, _MacGen] = {}
        self._pending: Dict[object, _Request] = {}
        self._idx: Dict[object, int] = {}
        self._root: Dict[object, int] = {}
        self._stats: Dict[object, SearchStats] = {}
        self._collect: Dict[object, bool] = {}
        # speculative groups (DESIGN.md §9): group key -> _Group, member key
        # -> its group, and the sibling spawns queued by split_fn between
        # rounds (admitted at the top of the next round, while the parent row
        # they reference is guaranteed still live)
        self._groups: Dict[object, _Group] = {}
        self._group_of: Dict[object, _Group] = {}
        self._spawns: List[Tuple] = []
        self._inflight = None  # (layout, pending round, t0)
        # membership-stable caches: the sorted key order is rebuilt only when
        # membership changes, the np.repeat routing array only when the
        # per-search row counts differ from the previous round
        self._order: List = []
        self._order_dirty = False
        self._route_cache: Optional[Tuple[Tuple[int, ...], np.ndarray]] = None
        #: telemetry over resolved rounds
        self.last_round: Optional[RoundInfo] = None
        self.rounds = 0
        self.rows_dispatched = 0
        self.launches = 0  # kernel-launch bill across resolved rounds
        self.round_seconds: List[float] = []

    # --- membership --------------------------------------------------------

    def admit(
        self,
        key,
        dom0,
        idx: int = 0,
        *,
        supports_batch: bool = True,
        batched_children: bool = True,
        n_active: Optional[int] = None,
        max_assignments: Optional[int] = None,
        collect_stats: bool = True,
    ) -> SearchStats:
        """Join a new search from the root domain ``dom0`` (n, d) (a tensor
        or an array; the search keeps a host copy, never the network); it
        participates from the next dispatch on. ``idx`` routes the search's
        rows to its constraint network. Returns the live `SearchStats`
        (filled in as rounds run)."""
        if key in self._gens or key in self._groups:
            raise ValueError(f"search key {key!r} already admitted")
        stats = SearchStats()
        dom0 = np.asarray(to_numpy(dom0), dtype=bool)
        gen = _mac_coroutine(
            dom0,
            functools.partial(self._store.free, key),
            functools.partial(self._store.extract, key),
            supports_batch,
            batched_children,
            max_assignments,
            stats,
            n_active=n_active,
        )
        req0 = gen.send(None)  # root request; always yields ≥ once
        root = self._store.begin(key, idx, dom0, req0.assigned)
        self._pending[key] = req0
        self._gens[key] = gen
        self._idx[key] = int(idx)
        self._root[key] = root
        self._stats[key] = stats
        self._collect[key] = collect_stats
        self._order_dirty = True
        return stats

    def admit_group(
        self,
        key,
        dom0,
        idx: int = 0,
        *,
        split_budget: int = 0,
        portfolio: int = 0,
        portfolio_seed: int = 0,
        supports_batch: bool = True,
        batched_children: bool = True,
        n_active: Optional[int] = None,
        max_assignments: Optional[int] = None,
        collect_stats: bool = True,
    ) -> SearchStats:
        """Join one request as a speculative GROUP (DESIGN.md §9): an owner
        search that may scatter up to ``split_budget`` sibling subtrees onto
        spare rows as it branches, racing ``portfolio`` heuristic-diverse full
        restarts. ``round()`` reports the group under ``key`` exactly like a
        solo search — first SAT wins (the rest are cancelled), UNSAT needs
        the whole cover, ``max_assignments`` is a group-total budget. The
        returned `SearchStats` is shared by every member, so its counters are
        the request's totals. With both knobs 0 this IS ``admit``."""
        if split_budget <= 0 and portfolio <= 0:
            return self.admit(
                key, dom0, idx,
                supports_batch=supports_batch,
                batched_children=batched_children,
                n_active=n_active,
                max_assignments=max_assignments,
                collect_stats=collect_stats,
            )
        if key in self._gens or key in self._groups:
            raise ValueError(f"search key {key!r} already admitted")
        g = _Group(
            key=key, dom0=np.asarray(to_numpy(dom0), dtype=bool), idx=int(idx),
            stats=SearchStats(),
            split_budget=int(split_budget), supports_batch=supports_batch,
            batched_children=batched_children, n_active=n_active,
            max_assignments=max_assignments, collect=collect_stats,
        )
        self._groups[key] = g

        def split_fn(handle, var, values, assigned):
            if g.done or g.split_budget <= 0 or len(values) < 2:
                return values
            s = min(g.split_budget, len(values) - 1)
            g.split_budget -= s
            keep = values[: len(values) - s]
            for v in values[len(values) - s:]:
                mkey = _MemberKey(g.key, g.next_m)
                g.next_m += 1
                # in the cover from queue time: the subtree is spoken for even
                # before its sibling is admitted, so an emptying cover can't
                # mis-declare UNSAT while spawns are still queued
                g.cover.add(mkey)
                g.stats.members += 1
                self._spawns.append((g, mkey, handle, var, (v,), assigned.copy()))
            return keep

        if split_budget > 0:
            g.split_fn = split_fn

        owner = _MemberKey(key, g.next_m)
        g.next_m += 1
        g.cover.add(owner)
        self._admit_member(g, owner, heuristic="mrv", value_order=None,
                           split_fn=g.split_fn)
        for spec in default_portfolio(portfolio, portfolio_seed):
            mkey = _MemberKey(key, g.next_m)
            g.next_m += 1
            g.complete.add(mkey)
            g.stats.members += 1
            if spec.heuristic == "anti" and hasattr(self._store, "enable_alt"):
                self._store.enable_alt()
            self._admit_member(
                g, mkey, heuristic=spec.heuristic,
                value_order=_value_order_fn(spec.value_order, spec.seed),
                split_fn=None,
            )
        return g.stats

    def _admit_member(self, g: _Group, mkey, *, heuristic, value_order,
                      split_fn) -> None:
        """Admit one full-restart group member (owner or portfolio racer):
        its own root upload, the group's shared stats and budget."""
        gen = _mac_coroutine(
            g.dom0,
            functools.partial(self._store.free, mkey),
            functools.partial(self._store.extract, mkey),
            g.supports_batch,
            g.batched_children,
            g.max_assignments,
            g.stats,
            n_active=g.n_active,
            heuristic=heuristic,
            value_order=value_order,
            split_fn=split_fn,
        )
        req0 = gen.send(None)  # root request; always yields ≥ once
        root = self._store.begin(mkey, g.idx, g.dom0, req0.assigned)
        self._pending[mkey] = req0
        self._gens[mkey] = gen
        self._idx[mkey] = g.idx
        self._root[mkey] = root
        self._stats[mkey] = g.stats
        self._collect[mkey] = g.collect
        self._group_of[mkey] = g
        g.live.add(mkey)
        self._order_dirty = True

    def _admit_spawns(self, finished: Dict) -> None:
        """Materialize the sibling spawns split_fn queued during the last
        ``_advance``: each joins with `FrontierStore.register` (no root
        upload — its first request is a child-create against the owner's
        still-live parent row) and rides the next dispatch."""
        while self._spawns:
            spawns, self._spawns = self._spawns, []
            for g, mkey, parent, var, values, mask in spawns:
                if g.done:
                    continue
                gen = _mac_coroutine(
                    g.dom0,
                    functools.partial(self._store.free, mkey),
                    functools.partial(self._store.extract, mkey),
                    g.supports_batch,
                    g.batched_children,
                    g.max_assignments,
                    g.stats,
                    n_active=g.n_active,
                    root_spec=(parent, var, values),
                    assigned0=mask,
                    split_fn=g.split_fn,
                )
                try:
                    req0 = gen.send(None)
                except BudgetExceeded:
                    # the group-total budget tripped while priming: the whole
                    # group is exhausted — resolve it now (also drops this
                    # batch's remaining spawns for the group)
                    g.cover.discard(mkey)
                    self._resolve_group(g, None, True, finished)
                    continue
                self._store.register(mkey, g.idx)
                self._pending[mkey] = req0
                self._gens[mkey] = gen
                self._idx[mkey] = g.idx
                self._root[mkey] = parent
                self._stats[mkey] = g.stats
                self._collect[mkey] = g.collect
                self._group_of[mkey] = g
                g.live.add(mkey)
                self._order_dirty = True

    def _finish_key(self, k, sol, exhausted: bool, finished: Dict) -> None:
        """Route one coroutine's completion: solo searches report directly;
        group members feed the group's verdict logic."""
        stats = self._retire_key(k)
        g = self._group_of.pop(k, None)
        if g is None:
            if exhausted:
                stats.exhausted = True
            finished[k] = (sol, stats)
            return
        g.live.discard(k)
        complete = k in g.complete
        g.cover.discard(k)
        g.complete.discard(k)
        if g.done:
            return  # a straggler of an already-resolved group
        if sol is not None:
            self._resolve_group(g, sol, False, finished)
        elif exhausted:
            self._resolve_group(g, None, True, finished)
        elif complete or not g.cover:
            # a full restart came back UNSAT, or the cover tiles are all
            # exhausted-free and empty — either is a proof
            self._resolve_group(g, None, False, finished)

    def _resolve_group(self, g: _Group, sol, exhausted: bool,
                       finished: Dict) -> None:
        """Settle a group's verdict: cancel the losers (rows free now), drop
        its queued spawns, report it under the group key."""
        g.done = True
        g.result, g.exhausted = sol, exhausted
        self._cancel_members(g)
        if exhausted:
            g.stats.exhausted = True
        self._groups.pop(g.key, None)
        finished[g.key] = (sol, g.stats)

    def _retire_key(self, key) -> SearchStats:
        """Drop every piece of driver state for one search key and reclaim its
        store rows (safe mid-flight: the in-flight round's results for the key
        are dropped at resolution). Returns the search's stats."""
        self._gens.pop(key).close()
        self._pending.pop(key, None)  # absent while the search is in flight
        self._idx.pop(key, None)
        self._root.pop(key, None)
        self._collect.pop(key, None)
        self._store.release(key)
        self._order_dirty = True
        return self._stats.pop(key)

    def _cancel_members(self, g: _Group) -> None:
        """Retire every live member of ``g`` and drop its queued spawns,
        billing each as a cancelled member."""
        before = g.stats.cancelled_members
        with obs.span("group.cancel", cat="driver", n=len(g.live)):
            for k in list(g.live):
                if k in self._gens:
                    self._retire_key(k)
                    self._group_of.pop(k, None)
                    g.stats.cancelled_members += 1
            g.live.clear()
            kept = [s for s in self._spawns if s[0] is not g]
            g.stats.cancelled_members += len(self._spawns) - len(kept)
            self._spawns = kept
        obs.REGISTRY.counter_add(
            "driver.cancelled_members", g.stats.cancelled_members - before
        )

    def cancel(self, key) -> SearchStats:
        """Evict a live search or a whole speculative group (e.g. deadline
        expiry); frees its rows even if they are part of an in-flight round
        (the round's results are simply dropped at resolution)."""
        g = self._groups.pop(key, None)
        if g is not None:
            g.done = True
            self._cancel_members(g)
            return g.stats
        return self._retire_key(key)

    @property
    def active_keys(self) -> List:
        return sorted(self._gens, key=_sort_key)

    def is_active(self, key) -> bool:
        return key in self._gens or key in self._groups

    @property
    def has_work(self) -> bool:
        return (
            bool(self._pending)
            or bool(self._spawns)
            or self._inflight is not None
        )

    @property
    def n_pending_rows(self) -> int:
        return sum(max(1, len(req.values)) for req in self._pending.values())

    # --- one lockstep round -------------------------------------------------

    def round(self) -> Dict[object, Tuple[Optional[List[int]], SearchStats]]:
        """Resolve the in-flight dispatch (if any), advance its searches, then
        launch the next dispatch; returns ``{key: (solution | None, stats)}``
        for the searches that finished (their rows are freed). On pipelined
        stores the launch is asynchronous — it resolves on the NEXT call."""
        self.last_round = None
        finished: Dict[object, Tuple[Optional[List[int]], SearchStats]] = {}
        with obs.span("driver.round", cat="driver"):
            if self._inflight is not None:
                layout, pend, t0 = self._inflight
                self._inflight = None
                with obs.span("round.resolve", cat="driver", rows=sum(b for _, b in layout)):
                    finished = self._advance(layout, pend, t0)
            if self._spawns:
                # admit split siblings NOW, before the next dispatch: their
                # first request reads the parent row, whose owner is still
                # paused on a yield — the row cannot be freed before this
                # round resolves
                with obs.span("group.spawn", cat="driver", n=len(self._spawns)):
                    self._admit_spawns(finished)
            if self._pending:
                with obs.span("frontier.step", cat="driver") as _sp:
                    specs, layout, net_idx = self._collect_rows()
                    if _sp is not None:
                        _sp.args["rows"] = len(specs)
                    t0 = time.perf_counter()
                    pend = self._store.dispatch(specs, net_idx)
                    if getattr(self._store, "pipelined", False):
                        self._inflight = (layout, pend, t0)
                if self._inflight is None:
                    with obs.span("round.resolve", cat="driver", rows=len(specs)):
                        finished.update(self._advance(layout, pend, t0))
        return finished

    def _collect_rows(self):
        """Flatten every pending request into row specs, in cached sorted-key
        order, with the np.repeat routing array rebuilt only when the round
        shape actually changed."""
        if self._order_dirty:
            self._order = sorted(self._pending, key=_sort_key)
            self._order_dirty = False
            self._route_cache = None
        order = self._order
        sizes = tuple(
            1 if self._pending[k].parent is None else len(self._pending[k].values)
            for k in order
        )
        if self._route_cache is not None and self._route_cache[0] == sizes:
            net_idx = self._route_cache[1]
        else:
            per_key = np.asarray([self._idx[k] for k in order], np.int32)
            net_idx = np.repeat(per_key, sizes)
            self._route_cache = (sizes, net_idx)

        specs: List[FrontierRow] = []
        layout: List[Tuple[object, int]] = []
        for k, b in zip(order, sizes):
            req = self._pending.pop(k)
            if req.parent is None:
                specs.append(
                    FrontierRow(k, self._root[k], -1, 0, req.assigned, self._idx[k])
                )
            else:
                specs.extend(
                    FrontierRow(k, req.parent, req.var, v, req.assigned, self._idx[k])
                    for v in req.values
                )
            layout.append((k, b))
        return specs, layout, net_idx

    def _quarantine_offender(self, layout, res, reason: str, finished: Dict) -> None:
        """Watchdog eviction: retire the live search whose rows did the
        deepest work this round, reporting ``(None, stats)`` with
        ``stats.quarantined`` set (rows freed mid-flight through the normal
        `_retire_key` → ``store.release`` lifetime). Group members take their
        whole speculative group down with them — the group shares one verdict."""
        offender, depth = None, -1.0
        off = 0
        for k, b in layout:
            rows_k = res.k[off:off + b]
            off += b
            if k not in self._gens:
                continue
            d = float(np.max(rows_k)) if rows_k.size else 0.0
            if d > depth:
                offender, depth = k, d
        if offender is None:
            return
        self.watchdog_trips += 1
        obs.counter_add("watchdog.trips")
        g = self._group_of.get(offender)
        if g is not None and not g.done:
            self._resolve_group(g, None, False, finished)
            g.stats.quarantined = reason
        else:
            stats = self._retire_key(offender)
            self._group_of.pop(offender, None)
            stats.quarantined = reason
            finished[offender] = (None, stats)

    def _advance(self, layout, pend, t0) -> Dict:
        """Block on a round's metadata, file stats, advance every coroutine."""
        faults.inject("round.resolve", rows=sum(b for _, b in layout))
        res = pend.resolve()
        dt = time.perf_counter() - t0
        r = sum(b for _, b in layout)
        self.rounds += 1
        self.rows_dispatched += r
        self.round_seconds.append(dt)
        self.launches += res.launches
        self.last_round = RoundInfo(r, len(layout), dt, res.launches)
        obs.REGISTRY.counter_add("driver.rounds")
        obs.REGISTRY.counter_add("driver.rows", r)
        obs.REGISTRY.counter_add("driver.launches", res.launches)
        obs.REGISTRY.counter_add("driver.recurrences", int(np.sum(res.k)))
        values = _value_lists(res.handles, res.value_row)
        alt_values = (
            _value_lists(res.handles, res.alt_row)
            if res.alt_var is not None
            else None
        )

        finished: Dict[object, Tuple[Optional[List[int]], SearchStats]] = {}
        breach = None
        if self._round_wall_s is not None and dt > self._round_wall_s:
            breach = f"round wall-clock {dt:.3f}s > {self._round_wall_s:g}s"
        elif (
            self._round_recurrences is not None
            and res.k.size
            and int(np.max(res.k)) > self._round_recurrences
        ):
            breach = (
                f"round recurrence depth {int(np.max(res.k))} > "
                f"{self._round_recurrences}"
            )
        if breach is not None:
            # evict BEFORE advancing coroutines: the offender's results for
            # this round are dropped and the `k not in self._gens` guard below
            # skips its layout slice
            self._quarantine_offender(layout, res, breach, finished)

        off = 0
        # a speculative group's members share ONE stats object: per-REQUEST
        # round quantities (rounds ridden, the round's launch bill) must be
        # filed once per stats object, not once per member
        billed = set()
        for k, b in layout:
            rows = slice(off, off + b)
            off += b
            if k not in self._gens:  # cancelled while the round was in flight
                continue
            stats = self._stats[k]
            first = id(stats) not in billed
            billed.add(id(stats))
            if first:
                stats.rounds += 1
            stats.rows += b
            if self._collect[k]:
                # attribute the round's wall-clock over its REAL rows, so the
                # per-search attributions sum exactly to the measured seconds
                stats.enforce_seconds.append(dt * b / r)
                counts = (
                    stats.recurrences
                    if self._count_unit == "recurrences"
                    else stats.revisions
                )
                counts.extend(int(v) for v in res.k[rows])
                if first:
                    stats.launches += res.launches
            reply = _Reply(
                res.handles[rows], res.consistent[rows], res.branch_var[rows],
                values[rows],
                None if res.alt_var is None else res.alt_var[rows],
                None if alt_values is None else alt_values[rows],
            )
            try:
                self._pending[k] = self._gens[k].send(reply)
            except StopIteration as stop:
                self._finish_key(k, stop.value, False, finished)
            except BudgetExceeded:
                self._finish_key(k, None, True, finished)
        return finished


# ---------------------------------------------------------------------------
# solve_many — the portfolio entry point (one workload, many CSPs)
# ---------------------------------------------------------------------------


def solve_many(
    csps: Sequence[Instance],
    engine: Union[Engine, str] = "einsum",
    support_fn=None,
    max_assignments: Optional[int] = None,
    batched_children: bool = True,
    collect_stats: bool = True,
    telemetry: Optional[dict] = None,
    split_budget: int = 0,
    portfolio: int = 0,
    portfolio_seed: int = 0,
    device: Device = "cuda",
) -> Tuple[List[Optional[List[int]]], List[SearchStats]]:
    """Run B independent MAC searches (instances sharing (n, d)) to completion.

    An instance is a CSP or a zero-argument callable that builds one
    (`core.engine.Instance`): `Engine.prepare_many` builds a lazy instance
    when its slot is prepared and, on a stacked engine, drops it once the
    slot is written, so at most one instance's dense network is alive
    besides the tables; the searches keep each instance's root domain.

    On ``device_frontier`` engines the searches advance in lockstep against a
    device-resident `FrontierTable` over the `Engine.prepare_many` stacked
    networks: every round is ONE fused assign+enforce+MRV dispatch and only
    per-row metadata crosses the host boundary (DESIGN.md §8). Other
    batch-capable engines run the same lockstep through the host store.
    ``max_assignments`` is a *per-instance* budget. Solutions and per-instance
    search statistics are identical to sequential ``mac_solve``;
    ``enforce_seconds`` attributes each round's wall-clock to its participants
    proportionally to their row counts.

    Sequential engines (``supports_batch=False``, i.e. AC3) degrade to one
    ``mac_solve`` per instance — same results, no amortization.

    ``telemetry``, if a dict, is filled with round/transfer counters
    (``rounds``, ``rows_dispatched``, ``round_seconds_total``,
    ``prepare_seconds`` — the wall time of the ``search.prepare`` span:
    networks, frontier, admissions — and, on the
    device frontier — ``host_bytes_per_round`` vs the counterfactual
    ``domain_bytes_per_round``), plus the PER-INSTANCE rounds-to-solution
    distribution (``rounds_per_instance`` summary + log2-binned
    ``rounds_hist``) — batch totals hid exactly the stragglers this exists
    to expose.

    ``split_budget``/``portfolio`` turn each instance into a speculative
    group (DESIGN.md §9; see `mac_solve`) — verdicts still match the
    sequential oracle, per-instance stats become group totals.

    ``device`` places an engine given by name (default ``"cuda"``; it
    raises without a card unless ``device="cpu"``).

    Returns (solutions, stats) as same-length lists, index-aligned with
    ``csps``.
    """
    csps = list(csps)
    eng = resolve_engine(engine, support_fn, device)
    if not csps:
        return [], []

    if not eng.supports_batch:
        sols, stats = [], []
        for instance in csps:
            s, st = mac_solve(
                instance_csp(instance),
                engine=eng,
                max_assignments=max_assignments,
                batched_children=batched_children,
                collect_stats=collect_stats,
                split_budget=split_budget,
                portfolio=portfolio,
                portfolio_seed=portfolio_seed,
            )
            sols.append(s)
            stats.append(st)
        if telemetry is not None:
            _fill_rounds_histogram(telemetry, stats)
        return sols, stats

    # the call's preparation: networks, the frontier store, every search's
    # admission (its root read and its coroutine's first step)
    t_prepare = time.perf_counter()
    with obs.span("search.prepare", cat="driver"):
        prepared = eng.prepare_many(csps)  # the ONLY preparation in the whole run
        # speculative members multiply the worst-case live rows per instance
        n_eff = len(csps) * (1 + max(0, split_budget) + max(0, portfolio))
        if eng.device_frontier:
            networks = eng.frontier_networks(prepared)
            store = eng.open_frontier(
                lambda: networks, prepared.n_vars, prepared.dom_size,
                # presize for the worst case a DFS can hold live (every level keeps
                # its node + unvisited siblings): growth mid-run would recompile
                # the fused step for every round shape, and rows are n·d bools —
                # cheap enough that oversizing beats recompiling
                capacity=frontier_capacity(n_eff, prepared.n_vars, prepared.dom_size),
            )
        else:
            # host store over the stacked/host-routed enforce_many dispatch; pad
            # rounds only when the dispatch is one stacked program
            store = HostFrontierStore(
                prepared.n_vars, prepared.enforce_many, pad_rounds=eng.stacked_many
            )
        driver = LockstepDriver(store, prepared.n_vars, count_unit=eng.count_unit)
        all_stats = [
            driver.admit_group(
                i,
                dom0,
                idx=i,
                split_budget=split_budget,
                portfolio=portfolio,
                portfolio_seed=portfolio_seed + i,
                supports_batch=eng.supports_batch,
                batched_children=batched_children,
                max_assignments=max_assignments,
                collect_stats=collect_stats,
            )
            for i, dom0 in enumerate(prepared.doms)
        ]
    prepare_seconds = time.perf_counter() - t_prepare
    sols: List[Optional[List[int]]] = [None] * len(csps)
    while driver.has_work:
        for i, (sol, _st) in driver.round().items():
            sols[i] = sol
    # per-instance distributions into the central registry (DESIGN.md §10):
    # this is where tracker history and the obs CLI read straggler spread
    # and the launches-per-solve claim from, tracing on or off
    obs.REGISTRY.counter_add("many.solves", len(csps))
    obs.REGISTRY.observe("many.launches_per_solve", driver.launches / len(csps))
    for st in all_stats:
        obs.REGISTRY.observe("many.rounds_per_instance", st.rounds)
    if telemetry is not None:
        telemetry.update(
            engine=eng.name,
            device_frontier=bool(eng.device_frontier),
            fused_fixpoint=bool(getattr(eng, "fused_fixpoint", False)),
            rounds=driver.rounds,
            rows_dispatched=driver.rows_dispatched,
            launches=driver.launches,
            launches_per_round=driver.launches / max(driver.rounds, 1),
            round_seconds_total=float(sum(driver.round_seconds)),
            prepare_seconds=prepare_seconds,
        )
        _fill_rounds_histogram(telemetry, all_stats)
        if isinstance(store, FrontierTable):
            telemetry.update(
                host_bytes_per_round=store.host_bytes_per_round,
                domain_bytes_per_round=store.domain_bytes_per_round,
                rows_padded=store.rows_padded,
                root_bytes=store.root_bytes,
                extract_bytes=store.extract_bytes,
            )
    return sols, all_stats


def _fill_rounds_histogram(telemetry: dict, all_stats: Sequence[SearchStats]) -> None:
    """Per-instance rounds-to-solution distribution: summary percentiles plus
    a log2-binned histogram (bin 0 counts instances that took 0 rounds; bin
    j ≥ 1 counts 2^(j-1) ≤ rounds < 2^j). Batch totals average the stragglers
    away — this is where a 4/32-solved workload becomes visible."""
    rp = np.asarray([st.rounds for st in all_stats], dtype=np.int64)
    if rp.size == 0:
        telemetry["rounds_per_instance"] = {}
        telemetry["rounds_hist"] = []
        return
    bins = np.bincount(
        np.where(rp > 0, np.floor(np.log2(np.maximum(rp, 1))).astype(np.int64) + 1, 0)
    )
    telemetry["rounds_per_instance"] = {
        "min": int(rp.min()),
        "p50": float(np.median(rp)),
        "p90": float(np.percentile(rp, 90)),
        "max": int(rp.max()),
    }
    telemetry["rounds_hist"] = [int(c) for c in bins]


def check_solution(csp: CSP, solution: List[int]) -> bool:
    """Verify a full assignment in O(n²) numpy (no Python pair loop): one
    gather checks every value is in-domain, one gather over the upper-triangle
    constrained pairs checks every binary constraint."""
    sol = np.asarray(solution, dtype=np.int64)
    n = sol.shape[0]
    dom = to_numpy(csp.dom)
    if not dom[np.arange(n), sol].all():
        return False
    mask = to_numpy(csp.mask)[:n, :n]
    cons = to_numpy(csp.cons)
    xs, ys = np.nonzero(np.triu(mask, 1))
    return bool(cons[xs, ys, sol[xs], sol[ys]].all())
