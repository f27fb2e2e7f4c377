"""The Engine protocol — prepare-once, enforce-many arc consistency.

The PyTorch counterpart of `repro.core.engine`. Every backend satisfies:

    engine.prepare(csp)              -> PreparedNetwork   (expensive, once)
    prepared.enforce(dom, ch)        -> EnforceResult     (hot path)
    prepared.enforce_batch(doms, ch) -> EnforceResult     (B domains at once)
    engine.prepare_many(csps)        -> PreparedMany      (stacked workload)
    many.enforce_many(doms, ch, idx) -> EnforceResult     (R domains, each
                                                           vs its OWN network)

open-world engines hand out a `SlotPool` (``engine.open_slot_pool``): a table
of resident network slots that searches join and leave mid-flight, the
substrate of `repro_torch.service`; and device-frontier engines back a
`FrontierTable`: the search frontier's
closures live in one preallocated device buffer, and every lockstep round is
one `_frontier_step` (gather → assign → fixpoint → scatter → MRV) whose host
traffic is O(R·d) metadata both ways. Where the reference writes donated
buffers with ``.at[].set``, this module writes the preallocated buffers in
place (``index_put_``, a slot install ``t[slot].copy_(v)``) on the device's
current stream; ``_PendingFrontierRound.resolve`` is the round's only
device→host copy.

Padding contract: padded variables are unconstrained with the singleton
domain {0}, so they never change, never violate and never wipe out; padded
values are absent from every domain and allowed by no constraint. This
module is the port's only implementation of that contract.
"""

from __future__ import annotations

import abc
import bisect
from typing import Any, Callable, ClassVar, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.device import Device, resolve_device, to_numpy

from .csp import CSP
from .rtac import EnforceResult

Tensor = torch.Tensor
Changed = Optional[Union[Tensor, np.ndarray]]


# ---------------------------------------------------------------------------
# Padding contract — the ONE implementation (kernels and engines import these)
# ---------------------------------------------------------------------------


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def next_pow2(x: int) -> int:
    """The next power of two ≥ x (x ≥ 1) — the round-width quantization every
    batching layer uses."""
    return 1 << (x - 1).bit_length()


def pad_round_rows(arrays: Sequence[np.ndarray], r_p: int) -> List[np.ndarray]:
    """Pad each (R, ...) array to ``r_p`` rows by replicating its LAST row —
    enforcement is idempotent per element and duplicate scatters write
    identical values, so padded rows are inert."""
    r = arrays[0].shape[0]
    if r_p == r:
        return list(arrays)
    return [np.concatenate([a, np.repeat(a[-1:], r_p - r, axis=0)]) for a in arrays]


def padded_shape(n: int, d: int, n_block: int, d_mult: int):
    """The kernel shape a network of (n, d) is padded to (`kernels.ops`
    pads it a chunk of x-rows at a time)."""
    return round_up(max(n, n_block), n_block), round_up(d, d_mult)


def pad_dom(dom: Tensor, n_p: int, d_p: int) -> Tensor:
    """Pad a domain tensor (..., n, d) -> (..., n_p, d_p). Padded variables get
    the singleton domain {0}; padded values are False everywhere."""
    *batch, n, d = dom.shape
    out = torch.zeros((*batch, n_p, d_p), dtype=torch.bool, device=dom.device)
    out[..., :n, :d] = dom
    out[..., n:, 0] = True
    return out


def pad_changed(changed0: Changed, n: int, n_p: int, batch: tuple = (),
                device: Device = "cpu") -> Tensor:
    """Normalize+pad a changed seed (..., n) -> (..., n_p); None = all-changed.
    Padded variables are never marked changed."""
    ch = as_changed(changed0, device)
    if ch is None:
        ch = torch.ones((*batch, n), dtype=torch.bool, device=device)
    out = torch.zeros((*ch.shape[:-1], n_p), dtype=torch.bool, device=ch.device)
    out[..., :n] = ch
    return out


def as_changed(changed0: Changed, device: Device = "cpu") -> Optional[Tensor]:
    """Normalize a caller-supplied changed seed to a bool tensor (or None).
    A tensor keeps its device; anything else lands on ``device``."""
    if changed0 is None:
        return None
    if isinstance(changed0, torch.Tensor):
        return changed0.to(torch.bool)
    return torch.as_tensor(np.asarray(changed0, dtype=bool), device=device)


#: the least bytes of bools a host domain uploads through pinned chunks
#: (`stages`): below it one pageable copy's fixed costs are the smaller.
#: Both constants come from a sweep of plain against staged uploads on an
#: H100's host (PERF.md §6): the staged upload no slower from 2 MiB, and
#: 8 MiB the fastest chunk at 64 MiB.
STAGE_MIN_BYTES = 2 << 20
#: the bytes of one pinned chunk of a staged upload (`_staged_upload`)
STAGE_CHUNK_BYTES = 8 << 20


def stages(nbytes: int, device: Device) -> bool:
    """Whether a host domain of ``nbytes`` bools goes to ``device`` through
    pinned chunks (`_staged_upload`) rather than one pageable copy."""
    return torch.device(device).type == "cuda" and nbytes >= STAGE_MIN_BYTES


def chunk_rows(shape: Sequence[int]) -> int:
    """Leading-axis rows a staged chunk of a bool array of ``shape`` holds:
    about `STAGE_CHUNK_BYTES`, at least one row."""
    row = int(np.prod(shape[1:], dtype=np.int64))
    return max(1, STAGE_CHUNK_BYTES // max(1, row))


def _staged_upload(src: Tensor, device: Device) -> Tensor:
    """``src`` (a host tensor, any dtype) as a bool tensor on ``device``,
    chunk by chunk: each chunk copied on torch's intra-op threads into a
    page-locked block of the caching host allocator, then copied to the
    device without blocking on the current stream, so a chunk's DMA runs
    while the host fills the next. The allocator reuses a block only once
    the copy that read it is done; every byte of ``src`` has been read when
    this returns."""
    out = torch.empty(src.shape, dtype=torch.bool, device=device)
    step = chunk_rows(src.shape)
    for i in range(0, src.shape[0], step):
        part = src[i:i + step]
        pinned = torch.empty(part.shape, dtype=torch.bool, pin_memory=True)
        pinned.copy_(part)
        out[i:i + step].copy_(pinned, non_blocking=True)
    obs.counter_add("upload.staged")
    return out


def as_dom(dom, device: Device) -> Tensor:
    """A caller-supplied domain (numpy or tensor) as a bool tensor on
    ``device``. A host array of at least `STAGE_MIN_BYTES` bools bound for a
    card goes through pinned chunks (`stages`, `_staged_upload`)."""
    if isinstance(dom, torch.Tensor):
        if stages(dom.numel(), device) and dom.device.type == "cpu" and not dom.is_pinned():
            return _staged_upload(dom, device)
        return dom.to(device=device, dtype=torch.bool)
    dom = np.asarray(dom, dtype=bool)
    if stages(dom.size, device):
        return _staged_upload(torch.from_numpy(dom), device)
    return torch.as_tensor(dom, device=device)


# ---------------------------------------------------------------------------
# PreparedNetwork + Engine
# ---------------------------------------------------------------------------


class PreparedNetwork:
    """A CSP's constraint network compiled into one backend's resident form
    (``payload`` is backend-owned)."""

    __slots__ = ("engine", "csp", "payload")

    def __init__(self, engine: "Engine", csp: CSP, payload: Any):
        self.engine = engine
        self.csp = csp
        self.payload = payload

    @property
    def n_vars(self) -> int:
        return self.csp.dom.shape[0]

    @property
    def dom_size(self) -> int:
        return self.csp.dom.shape[1]

    def enforce(self, dom=None, changed0: Changed = None) -> EnforceResult:
        """Enforce AC on one domain (n, d); ``dom=None`` uses the root domain."""
        if dom is None:
            dom = self.csp.dom
        return self.engine.enforce(self, dom, changed0)

    def enforce_batch(self, doms, changed0: Changed = None) -> EnforceResult:
        """Enforce AC on B domains (B, n, d) in one dispatch."""
        return self.engine.enforce_batch(self, doms, changed0)


class PreparedMany:
    """B constraint networks sharing (n, d), compiled into one backend's
    *stacked* resident form. Of each instance it keeps the root domain
    (``doms[i]``), never the network: a stacked engine's tables hold that."""

    __slots__ = ("engine", "doms", "payload")

    def __init__(self, engine: "Engine", doms: Sequence[Tensor], payload: Any):
        self.engine = engine
        self.doms = list(doms)
        self.payload = payload

    @property
    def n_instances(self) -> int:
        return len(self.doms)

    @property
    def n_vars(self) -> int:
        return self.doms[0].shape[0]

    @property
    def dom_size(self) -> int:
        return self.doms[0].shape[1]

    def enforce_many(self, doms, changed0: Changed = None, instance_idx=None) -> EnforceResult:
        """Enforce AC on R domains (R, n, d), row i against the network of
        instance ``instance_idx[i]`` (default ``arange(B)``)."""
        return self.engine.enforce_many(self, doms, changed0, instance_idx)


#: an instance of a stacked workload: a CSP, or a zero-argument callable
#: that builds one (lazy: built only when its turn to be prepared comes)
Instance = Union[CSP, Callable[[], CSP]]


def instance_csp(instance: Instance) -> CSP:
    """The CSP of an instance, built now if it is lazy."""
    return instance() if callable(instance) else instance


def prepare_each(instances: Sequence[Instance],
                 install: Callable[[int, CSP], None]) -> List[Tensor]:
    """Prepare a workload one instance at a time: build instance i (a lazy
    one only now), check that it shares the first one's (n, d), hand it to
    ``install(i, csp)`` inside a ``prepare.slot`` span, keep its root domain,
    and drop it before the next is built; a lazy instance's network is then
    freed unless ``install`` kept it. Returns the root domains."""
    doms: List[Tensor] = []
    for i, instance in enumerate(instances):
        with obs.span("prepare.slot", cat="engine", slot=i):
            csp = instance_csp(instance)
            if doms and tuple(csp.dom.shape) != tuple(doms[0].shape):
                raise ValueError(
                    f"prepare_many: instance {i} has shape {tuple(csp.dom.shape)}, "
                    f"expected {tuple(doms[0].shape)} — all instances must share "
                    "(n_vars, dom_size)"
                )
            install(i, csp)
            doms.append(csp.dom)
            del csp
    return doms


# ---------------------------------------------------------------------------
# Slot pools — open-world resident networks
# ---------------------------------------------------------------------------


def route_rows_on_host(enforce_row, doms, changed0: Changed, idx) -> EnforceResult:
    """The generic host-routing dispatch shared by `Engine.enforce_many` and
    `SlotPool.enforce_rows`: row i goes through ``enforce_row(idx[i], dom_i,
    changed_i)`` and the per-row results are stacked into one EnforceResult
    of numpy arrays."""
    results = [
        enforce_row(int(j), doms[i], None if changed0 is None else changed0[i])
        for i, j in enumerate(idx)
    ]
    return EnforceResult(
        dom=np.stack([to_numpy(r.dom) for r in results]),
        consistent=np.asarray([bool(r.consistent) for r in results]),
        n_recurrences=np.asarray([int(r.n_recurrences) for r in results]),
    )


class SlotPool:
    """An *open-world* `PreparedMany`: a fixed-capacity table of resident
    network slots that searches join and leave mid-flight.

    ``install`` compiles one network into a slot (the only O(n²d²) step,
    paid once per distinct network), ``enforce_rows`` resolves R domains —
    row i against slot ``slot_idx[i]`` — and ``release`` frees a slot for
    reuse. All slots share one (n_vars, dom_size) bucket shape.

    This generic pool keeps one `PreparedNetwork` per slot and routes rows on
    the host (it works for every engine, AC3 included). Engines that
    advertise ``slot_table = True`` get a device-resident `StackedSlotPool`
    instead."""

    stacked: ClassVar[bool] = False

    def __init__(self, engine: "Engine", n_vars: int, dom_size: int, capacity: int):
        if capacity < 1:
            raise ValueError("SlotPool needs capacity >= 1")
        self.engine = engine
        self.n_vars = n_vars
        self.dom_size = dom_size
        self._nets: List[Optional[Any]] = [None] * capacity

    @property
    def capacity(self) -> int:
        return len(self._nets)

    def _check(self, slot: int, installing: bool) -> None:
        if not 0 <= slot < self.capacity:
            raise ValueError(f"slot {slot} out of range [0, {self.capacity})")
        if installing and self._nets[slot] is not None:
            raise ValueError(f"slot {slot} already installed; release it first")

    def install(self, slot: int, csp: CSP) -> None:
        """Compile ``csp``'s network into ``slot`` (must match the pool shape)."""
        self._check(slot, installing=True)
        if tuple(csp.dom.shape) != (self.n_vars, self.dom_size):
            raise ValueError(
                f"install: csp shape {tuple(csp.dom.shape)} != pool bucket "
                f"({self.n_vars}, {self.dom_size})"
            )
        faults.inject("slot.install", slot=slot)
        with obs.span("slot.install", cat="engine", slot=slot,
                      n=self.n_vars, d=self.dom_size):
            self._nets[slot] = self._prepare_slot(slot, csp)
        obs.REGISTRY.counter_add("slots.installed")

    def _prepare_slot(self, slot: int, csp: CSP):
        """Backend hook: build the slot's resident form. The generic pool keeps
        a `PreparedNetwork`; stacked pools write the tables and return a
        truthy sentinel."""
        return self.engine.prepare(csp)

    def release(self, slot: int) -> None:
        """Free a slot (its network may be overwritten by a later install)."""
        self._check(slot, installing=False)
        self._nets[slot] = None

    def grow(self, capacity: int) -> None:
        """Enlarge the table (amortized doubling in the service layer)."""
        if capacity < self.capacity:
            raise ValueError("SlotPool.grow cannot shrink")
        self._nets.extend([None] * (capacity - self.capacity))

    def enforce_rows(self, doms, changed0: Changed = None, slot_idx=None):
        """Enforce R domains (R, n, d), row i against slot ``slot_idx[i]``."""
        doms = to_numpy(doms)
        idx = resolve_instance_idx(slot_idx, self.capacity, doms.shape[0])

        def enforce_row(j, dom, ch):
            net = self._nets[j]
            if net is None:
                raise ValueError(f"enforce_rows: slot {j} is empty")
            return net.enforce(dom, ch)

        return route_rows_on_host(enforce_row, doms, changed0, idx)

    @property
    def resident_nbytes(self) -> int:
        """Device bytes this pool's resident networks occupy, in the engine's
        own representation (`Engine.network_nbytes`)."""
        occupied = sum(net is not None for net in self._nets)
        return occupied * self.engine.network_nbytes(self.n_vars, self.dom_size)


class StackedSlotPool(SlotPool):
    """A device-resident `SlotPool`: the networks live in stacked ``(C, ...)``
    tensors on the engine's device, an install writes one slot row in place
    (``t[slot].copy_(v)``), and ``enforce_rows`` is one dispatch that reads
    each row's network from the tables through its slot id.

    The backend supplies its representation as the engine's three hooks:

    - ``_slot_tables(n, d, capacity)``: the initial (zeroed) slot tables —
      ``(C, n, n, d, d)`` bool cons for the einsum engines,
      ``(C, n_p·d_p, n_p·W)`` int32 packed words for `hopper_packed`;
    - ``_write_slot(tables, slot, csp)``: one network compiled into its slot
      of the tables, in place (the only O(n²d²) step, paid once per
      install);
    - ``_rows_dispatch(tables, doms, changed0, idx)``: the round over the
      tables.

    Installs and growth are ordered on the device's current stream, like the
    rounds that read the tables; an empty slot stays all zeros."""

    stacked: ClassVar[bool] = True

    def __init__(self, engine: "Engine", n_vars: int, dom_size: int, capacity: int):
        super().__init__(engine, n_vars, dom_size, capacity)
        self._tables = tuple(engine._slot_tables(n_vars, dom_size, capacity))

    def _prepare_slot(self, slot: int, csp: CSP):
        self.engine._write_slot(self._tables, slot, csp)
        return True  # occupancy sentinel; the network lives in the tables

    def grow(self, capacity: int) -> None:
        """A larger table, the old slots copied into it; the old tensors are
        dropped, so every later round reads the new ones (`tables`)."""
        old = self.capacity
        super().grow(capacity)
        if capacity > old:
            grown = []
            for t in self._tables:
                g = torch.zeros((capacity, *t.shape[1:]), dtype=t.dtype, device=t.device)
                g[:old].copy_(t)
                grown.append(g)
            self._tables = tuple(grown)

    def require_installed(self, slot_idx) -> None:
        """Fail loudly if any routed slot has no resident network (also the
        `FrontierTable` round's ``check_net`` hook in the service)."""
        for j in np.unique(to_numpy(slot_idx)):
            if self._nets[int(j)] is None:
                raise ValueError(f"enforce_rows: slot {int(j)} is empty")

    def enforce_rows(self, doms, changed0: Changed = None, slot_idx=None):
        idx = resolve_instance_idx(slot_idx, self.capacity, len(doms))
        self.require_installed(idx)
        return self.engine._rows_dispatch(self._tables, doms, changed0, idx)

    @property
    def tables(self) -> Tuple[Tensor, ...]:
        """The live slot tables — what a `FrontierTable` round reads its
        networks from (re-read every round, so installs and growth between
        rounds are picked up)."""
        return self._tables

    @property
    def resident_nbytes(self) -> int:
        """The tables' whole footprint (allocated whole, occupied or not)."""
        return sum(t.numel() * t.element_size() for t in self._tables)


# ---------------------------------------------------------------------------
# FrontierTable — device-resident search frontiers
# ---------------------------------------------------------------------------


class FrontierRow(NamedTuple):
    """One row of a frontier dispatch: create (and enforce) the child of
    ``parent`` obtained by assigning ``var := val``; ``var < 0`` marks a root
    row. ``assigned`` is the child's (n,) assignment mask; ``net`` routes the
    row to its constraint network."""

    key: Any
    parent: int
    var: int
    val: int
    assigned: np.ndarray
    net: int


class RoundMeta(NamedTuple):
    """What a frontier round ships back to the host: O(R·d) metadata."""

    handles: List[Optional[int]]
    consistent: np.ndarray  # (R,) bool
    k: np.ndarray  # (R,) int32 — per-row recurrence counts
    branch_var: np.ndarray  # (R,) int32
    value_row: np.ndarray  # (R, d) bool — the branching variable's domain row
    #: kernel launches this round's enforcement cost: 1 on a fused in-kernel
    #: fixpoint, the round's max recurrence depth on the stepped loop
    launches: int = 1
    #: anti-MRV decision (portfolio heuristic diversity), when enabled
    alt_var: Optional[np.ndarray] = None  # (R,) int32
    alt_row: Optional[np.ndarray] = None  # (R, d) bool


_INT32_MAX = np.iinfo(np.int32).max


def _frontier_step(buf, abuf, networks, parent, var, val, dest, net_idx, *, fix,
                   want_alt=False):
    """ONE round: gather parent closures and assignment masks from the
    resident frontier planes, assign + enforce (the engine's ``fix``),
    scatter the children back in place, and reduce the per-row metadata —
    neither domains nor assignment masks leave the device."""
    doms = buf[parent]  # (R, n, d)
    res = fix(networks, doms, var, val, net_idx)
    buf[dest] = res.dom
    # the child's assignment mask: parent's mask plus the assigned variable
    # (root rows, var < 0, inherit the parent mask unchanged)
    n = buf.shape[1]
    one_hot = torch.arange(n, device=buf.device)[None, :] == var.clamp(min=0)[:, None]
    assigned = abuf[parent] | (one_hot & (var >= 0)[:, None])  # (R, n)
    abuf[dest] = assigned
    # MRV on device — first argmin over unassigned domain sizes, identical to
    # search._select_var (torch.argmin returns the first minimal index)
    sizes = res.dom.sum(dim=-1, dtype=torch.int32)  # (R, n)
    rows = torch.arange(res.dom.shape[0], device=buf.device)
    bvar = torch.where(assigned, _INT32_MAX, sizes).argmin(dim=-1).to(torch.int32)
    vrow = res.dom[rows, bvar.long()]  # (R, d)
    out = (res.consistent, res.n_recurrences.to(torch.int32), bvar, vrow)
    if want_alt:
        # anti-MRV: first argmax over unassigned domain sizes (assigned → -1)
        avar = torch.where(assigned, -1, sizes).argmax(dim=-1).to(torch.int32)
        out = out + (avar, res.dom[rows, avar.long()])
    return out


class _PendingFrontierRound:
    """Handle for one launched frontier round: the metadata tensors are still
    being computed on the device; ``resolve()`` copies them to the host — the
    round's only device→host transfer — and frees inconsistent rows."""

    def __init__(self, table: "FrontierTable", meta, dest: List[int], keys: List[Any], r: int):
        self._table = table
        self._meta = meta
        self._dest = dest
        self._keys = keys
        self._r = r

    def resolve(self) -> RoundMeta:
        with obs.sync_wait(rows=self._r):
            host = [t.to("cpu", non_blocking=True) for t in self._meta]
            if self._meta[0].is_cuda:
                torch.cuda.current_stream(self._meta[0].device).synchronize()
            cons, k, bvar, vrow, *alt = [t.numpy() for t in host]
        self._table._count_d2h(cons, k, bvar, vrow, *alt)
        r = self._r
        handles: List[Optional[int]] = []
        for i, (key, row) in enumerate(zip(self._keys, self._dest)):
            if bool(cons[i]):
                handles.append(row)
            else:  # a wiped-out child is never revisited — free its row now
                self._table.free(key, row)
                handles.append(None)
        # the round's launch bill: a fused fixpoint is ONE kernel regardless
        # of recurrence depth; the stepped path launched one revise per
        # recurrence of the deepest row
        launches = 1 if self._table.fused_fixpoint else max(1, int(k[:r].max()))
        self._table.launches += launches
        avar, arow = (alt[0][:r], alt[1][:r]) if alt else (None, None)
        return RoundMeta(handles, cons[:r], k[:r], bvar[:r], vrow[:r], launches, avar, arow)


class FrontierTable:
    """Device-resident search frontiers: a preallocated ``(R_cap, n, d)``
    buffer holding every live search node's AC closure, plus the round
    dispatch over it.

    ``begin`` uploads one root domain per admitted search, ``dispatch``
    launches `_frontier_step` (host traffic: O(R·d) metadata both ways),
    ``extract`` fetches one closure exactly once, at solution extraction.
    Rows are owned per search key; capacity grows by doubling. All
    host↔device traffic is explicit and metered by the byte counters."""

    pipelined: ClassVar[bool] = True

    def __init__(
        self,
        n_vars: int,
        dom_size: int,
        networks: Callable[[], Any],
        fix: Callable,
        capacity: int = 64,
        pad_rounds: bool = True,
        check_net: Optional[Callable] = None,
        fused_fixpoint: bool = False,
        device: Device = "cuda",
    ):
        if capacity < 2:
            raise ValueError("FrontierTable needs capacity >= 2")
        self.device = resolve_device(device)
        self._check_net = check_net
        self.n_vars = n_vars
        self.dom_size = dom_size
        self._networks = networks  # () -> tensors; re-read every round
        self._fix = fix
        self._buf = torch.zeros((capacity, n_vars, dom_size), dtype=torch.bool,
                                device=self.device)
        self._abuf = torch.zeros((capacity, n_vars), dtype=torch.bool, device=self.device)
        self._free_rows: List[int] = list(range(capacity - 1, -1, -1))
        self._rows_of: Dict[Any, set] = {}
        self._net_of: Dict[Any, int] = {}
        self._pad_rounds = pad_rounds
        # The round-width ratchet of the reference: rounds pad to the nearest
        # width already used that is ≥ r (a new pow2 width only when r exceeds
        # them all), so the row counts and byte meters match it exactly.
        # Padded rows replicate the last real row (idempotent).
        self._widths: List[int] = []
        #: whether ``fix`` runs the whole recurrence in one kernel launch
        self.fused_fixpoint = bool(fused_fixpoint)
        # transfer telemetry (metadata bytes; root/extract counted separately)
        self.rounds = 0
        self.launches = 0
        self.rows_dispatched = 0
        self.rows_padded = 0
        self.rows_pow2 = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.root_bytes = 0
        self.extract_bytes = 0
        self._want_alt = False

    def enable_alt(self) -> None:
        """Ship the anti-MRV metadata pair with every subsequent round."""
        self._want_alt = True

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def rows_live(self) -> int:
        return self.capacity - len(self._free_rows)

    def spare_rows(self) -> int:
        return len(self._free_rows)

    @property
    def host_bytes_per_round(self) -> float:
        """Mean metadata bytes (both directions) one lockstep round moves."""
        return (self.h2d_bytes + self.d2h_bytes) / max(self.rounds, 1)

    @property
    def domain_bytes_per_round(self) -> float:
        """The counterfactual: full (R, n, d) bool domains both ways at plain
        next-pow2 round widths."""
        return 2.0 * self.rows_pow2 * self.n_vars * self.dom_size / max(self.rounds, 1)

    def _count_d2h(self, *arrays) -> None:
        nbytes = sum(np.asarray(a).nbytes for a in arrays)
        self.d2h_bytes += nbytes
        obs.REGISTRY.counter_add("frontier.d2h_bytes", nbytes)

    def _alloc(self, key) -> int:
        if not self._free_rows:
            old = self.capacity
            self._buf = torch.cat([self._buf, torch.zeros_like(self._buf)])
            self._abuf = torch.cat([self._abuf, torch.zeros_like(self._abuf)])
            self._free_rows.extend(range(2 * old - 1, old - 1, -1))
        row = self._free_rows.pop()
        self._rows_of[key].add(row)
        return row

    # --- search lifecycle ---------------------------------------------------

    def register(self, key, net: int) -> None:
        """Register a search key with its network routing but NO root upload
        (a split sibling's first row is a child of the owner's row)."""
        if key in self._rows_of:
            raise ValueError(f"search key {key!r} already registered")
        self._rows_of[key] = set()
        self._net_of[key] = int(net)

    def begin(self, key, net: int, root_dom: np.ndarray, assigned=None) -> int:
        """Register a search and upload its root domain + initial assignment
        mask into a fresh row — the one domain-sized host→device transfer of
        the search's lifetime."""
        self.register(key, net)
        row = self._alloc(key)
        dom = np.asarray(to_numpy(root_dom), dtype=bool)
        if assigned is None:
            assigned = np.zeros((self.n_vars,), dtype=bool)
        mask = np.asarray(assigned, dtype=bool)
        self.root_bytes += int(dom.nbytes) + int(mask.nbytes)
        self._buf[row] = torch.from_numpy(dom).to(self.device)
        self._abuf[row] = torch.from_numpy(mask).to(self.device)
        return row

    def free(self, key, row: int) -> None:
        """Return one row (a dead branch) to the free list."""
        rows = self._rows_of.get(key)
        if rows is not None and row in rows:
            rows.discard(row)
            self._free_rows.append(row)

    def release(self, key) -> None:
        """Reclaim every row a retired search still holds."""
        self._free_rows.extend(self._rows_of.pop(key, ()))
        self._net_of.pop(key, None)

    def extract(self, key, row: int) -> np.ndarray:
        """Fetch one closure — once per search, at solution extraction."""
        with obs.sync_wait():
            dom = self._buf[row].cpu().numpy()
        self.extract_bytes += int(dom.nbytes)
        return dom

    # --- the round ----------------------------------------------------------

    def dispatch(self, specs: Sequence[FrontierRow], net_idx=None) -> _PendingFrontierRound:
        """Launch one round over ``specs``; ``resolve()`` on the result blocks
        on the metadata. With a fused fixpoint the launch is asynchronous."""
        r = len(specs)
        if r == 0:
            raise ValueError("dispatch needs at least one row")
        faults.inject("frontier.step", rows=r)
        if self._check_net is not None:
            self._check_net(
                net_idx
                if net_idx is not None
                else np.fromiter((self._net_of[s.key] for s in specs), np.int32, r)
            )
        dest = [s.parent if s.var < 0 else self._alloc(s.key) for s in specs]
        parent = np.fromiter((s.parent for s in specs), np.int32, r)
        var = np.fromiter((s.var for s in specs), np.int32, r)
        val = np.fromiter((s.val for s in specs), np.int32, r)
        if net_idx is None:
            net_idx = np.fromiter((self._net_of[s.key] for s in specs), np.int32, r)
        dest_arr = np.asarray(dest, np.int32)
        if self._pad_rounds:
            r_p = next((w for w in self._widths if w >= r), None)
            if r_p is None:
                r_p = next_pow2(r)
                bisect.insort(self._widths, r_p)
        else:
            r_p = r
        # one (5, r_p) int32 upload: parent, var, val, dest, net (the last row
        # replicated verbatim — identical inputs write identical values)
        host = np.stack(pad_round_rows(
            (parent, var, val, dest_arr, np.asarray(net_idx, np.int32)), r_p
        ))
        args = torch.from_numpy(host).to(self.device, non_blocking=True).long()
        h2d = int(host.nbytes)
        self.h2d_bytes += h2d
        obs.REGISTRY.counter_add("frontier.h2d_bytes", h2d)
        self.rounds += 1
        self.rows_dispatched += r
        self.rows_padded += r_p
        self.rows_pow2 += next_pow2(r)
        with obs.span("kernel.launch", cat="kernel", rows=r, padded=r_p,
                      fused=self.fused_fixpoint) as sp:
            faults.inject("kernel.launch", rows=r)
            meta = _frontier_step(
                self._buf, self._abuf, self._networks(), *args, fix=self._fix,
                want_alt=self._want_alt,
            )
            obs.fence(meta)
            if sp is not None:
                sp.args["fenced"] = obs.fencing()
        return _PendingFrontierRound(self, meta, dest, [s.key for s in specs], r)


def frontier_capacity(n_searches: int, n_vars: int, dom_size: int,
                      cap: int = 8192) -> int:
    """Initial `FrontierTable` rows for ``n_searches`` concurrent searches:
    ~(n + d) rows per search bound a DFS's live nodes in the common case."""
    return max(64, min(cap, next_pow2(n_searches * (n_vars + dom_size + 2))))


def resolve_instance_idx(instance_idx, n_instances: int, n_rows: int) -> np.ndarray:
    """Normalize/validate the row→instance map of ``enforce_many``."""
    if instance_idx is None:
        if n_rows != n_instances:
            raise ValueError(
                f"enforce_many got {n_rows} domains for {n_instances} instances; "
                "pass instance_idx to map rows to instances"
            )
        return np.arange(n_instances, dtype=np.int32)
    idx = np.asarray(to_numpy(instance_idx), dtype=np.int32)
    if idx.shape != (n_rows,):
        raise ValueError(f"instance_idx shape {idx.shape} != ({n_rows},)")
    if idx.size and (idx.min() < 0 or idx.max() >= n_instances):
        raise ValueError(f"instance_idx out of range [0, {n_instances})")
    return idx


class Engine(abc.ABC):
    """One enforcement backend on one device. Register concrete engines in
    `repro_torch.engines`."""

    name: ClassVar[str]
    #: "recurrences" for the tensor fixpoints, "revisions" for AC3
    count_unit: ClassVar[str] = "recurrences"
    #: whether ``enforce_batch`` is genuinely one parallel dispatch
    supports_batch: ClassVar[bool] = True
    #: whether ``enforce_many`` is one stacked device dispatch
    stacked_many: ClassVar[bool] = False
    #: whether ``open_slot_pool`` is a device-resident `StackedSlotPool`
    #: (True requires ``_slot_tables``, ``_write_slot`` and ``_rows_dispatch``)
    slot_table: ClassVar[bool] = False
    #: whether this engine backs a device-resident `FrontierTable`
    device_frontier: ClassVar[bool] = False
    #: whether enforcement runs its whole recurrence inside ONE kernel launch
    fused_fixpoint: ClassVar[bool] = False
    #: ceiling on the frontier rows ONE request may speculatively occupy
    speculative_rows_hint: ClassVar[int] = 32

    def __init__(self, device: Device = "cuda"):
        self.device = resolve_device(device)

    def network_nbytes(self, n_vars: int, dom_size: int) -> int:
        """Resident device bytes of ONE prepared network (logical bool form)."""
        return n_vars * n_vars * dom_size * dom_size + n_vars * n_vars

    def prepare(self, csp: CSP) -> PreparedNetwork:
        """Compile the constraint network into this backend's resident form."""
        return PreparedNetwork(self, csp, self._prepare_payload(csp))

    @abc.abstractmethod
    def _prepare_payload(self, csp: CSP) -> Any:
        ...

    @abc.abstractmethod
    def enforce(self, prepared: PreparedNetwork, dom, changed0: Changed = None) -> EnforceResult:
        ...

    def enforce_batch(self, prepared: PreparedNetwork, doms, changed0: Changed = None) -> EnforceResult:
        """Generic fallback: loop on the host and stack. Device backends
        override this with one dispatch."""
        return route_rows_on_host(lambda _j, dom, ch: self.enforce(prepared, dom, ch),
                                  doms, changed0, np.zeros(len(doms), np.int32))

    # --- multi-instance (one workload, many independent CSPs) ---------------

    def prepare_many(self, instances: Sequence[Instance]) -> PreparedMany:
        """Compile B constraint networks sharing (n, d) into one stacked form,
        one instance at a time (`prepare_each`). An instance is a CSP or a
        zero-argument callable that builds one (`Instance`): a lazy instance
        is built when its turn comes and, on a stacked engine, freed once
        its slot is written, so one instance's dense network at most is
        alive besides the tables."""
        instances = list(instances)
        if not instances:
            raise ValueError("prepare_many needs at least one CSP")
        return PreparedMany(self, *self._prepare_many_payload(instances))

    def _prepare_many_payload(self, instances: List[Instance]) -> Tuple[List[Tensor], Any]:
        """(root domains, payload). ``slot_table`` engines allocate their slot
        tables once (`_slot_tables`) and write each instance into its slot
        in place (`_write_slot`; the always-on counter ``prepare.slots``
        ticks once a slot); the generic fallback keeps a `PreparedNetwork`
        per instance."""
        if not self.slot_table:
            nets: List[PreparedNetwork] = []
            doms = prepare_each(instances, lambda _i, csp: nets.append(self.prepare(csp)))
            return doms, nets
        tables: List[Tensor] = []

        def install(i: int, csp: CSP) -> None:
            if not tables:  # the first instance gives the shape
                tables.extend(self._slot_tables(*csp.dom.shape, len(instances)))
            self._write_slot(tables, i, csp)
            obs.counter_add("prepare.slots")

        doms = prepare_each(instances, install)
        return doms, tuple(tables)

    def enforce_many(self, prepared: PreparedMany, doms, changed0: Changed = None,
                     instance_idx=None) -> EnforceResult:
        """R domains, row i against the network of ``instance_idx[i]``.
        Generic fallback: route each row to its instance on the host."""
        doms = to_numpy(doms)
        idx = resolve_instance_idx(instance_idx, prepared.n_instances, doms.shape[0])
        nets: List[PreparedNetwork] = prepared.payload
        return route_rows_on_host(
            lambda j, dom, ch: self.enforce(nets[j], dom, ch), doms, changed0, idx
        )

    # --- device-resident frontiers -------------------------------------------

    def frontier_fix(self) -> Callable:
        """The assign+enforce core of a `FrontierTable` round:
        ``fix(networks, doms, var, val, net_idx)`` → `EnforceResult`."""
        raise NotImplementedError(
            f"{type(self).__name__} advertises device_frontier="
            f"{self.device_frontier} and does not implement frontier_fix"
        )

    def frontier_networks(self, prepared: PreparedMany) -> Any:
        """The stacked network tensors ``frontier_fix`` consumes."""
        raise NotImplementedError

    def open_frontier(self, networks: Callable[[], Any], n_vars: int,
                      dom_size: int, capacity: int = 64,
                      check_net: Optional[Callable] = None) -> FrontierTable:
        """A device-resident `FrontierTable` on this engine's device."""
        return FrontierTable(n_vars, dom_size, networks, self.frontier_fix(),
                             capacity=capacity, check_net=check_net,
                             fused_fixpoint=self.fused_fixpoint, device=self.device)

    # --- open-world slots (continuous batching) ------------------------------

    def open_slot_pool(self, n_vars: int, dom_size: int, capacity: int) -> SlotPool:
        """A `SlotPool` of ``capacity`` resident network slots sharing one
        (n_vars, dom_size) bucket shape: the device-resident stacked table on
        ``slot_table`` engines, the generic host-routing pool otherwise."""
        if self.slot_table:
            return StackedSlotPool(self, n_vars, dom_size, capacity)
        return SlotPool(self, n_vars, dom_size, capacity)

    def _slot_tables(self, n_vars: int, dom_size: int, capacity: int) -> Tuple[Tensor, ...]:
        """``slot_table`` hook: ``capacity`` zeroed slots of the tables."""
        raise NotImplementedError(
            f"{type(self).__name__} advertises slot_table=True but does not "
            "implement _slot_tables"
        )

    def _write_slot(self, tables: Sequence[Tensor], slot: int, csp: CSP) -> None:
        """``slot_table`` hook: ``csp``'s network into slot ``slot`` of
        ``tables``, in place."""
        raise NotImplementedError

    def _rows_dispatch(self, tables: Sequence[Tensor], doms, changed0: Changed,
                       idx) -> EnforceResult:
        """``slot_table`` hook: R rows, row i against slot ``idx[i]``."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} name={self.name!r} device={self.device}>"
