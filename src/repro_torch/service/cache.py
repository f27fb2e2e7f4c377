"""Prepared-network cache: constraint-tensor fingerprint → resident slot.

The counterpart of `repro.service.cache`.

A prepared network is O(n²d²) device memory, so a service cannot keep every
network it has ever seen resident — but workloads repeat (the same puzzle
re-submitted, a family's deterministic instances, retries), and re-preparing
is the one expensive step admission has. The cache maps a *fingerprint of the
constraint network* (cons + mask — NOT the domain, which is per-request) to
the bucket slot where that network is installed, with LRU eviction under an
explicit byte budget.

Byte accounting is in the ENGINE's resident representation, not logical cons
bytes: the service supplies each entry's ``nbytes`` from
`Engine.network_nbytes(bucket.n_p, bucket.d_p)`, so on `hopper_packed` an
entry costs packed 32-bit words (≈8× fewer bytes than the bool network) and
the same budget legally holds ≈8× more networks resident.

Pinning: every in-flight search against a network holds a pin on its entry,
and eviction skips pinned entries unconditionally — a network is only ever
evicted between flights. The byte budget is therefore a *target*: if every
resident network is pinned the cache runs over budget rather than corrupt
live searches (admission control is the service's job, not the cache's).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch import faults, obs
from repro_torch.core.csp import CSP
from repro_torch.device import to_numpy
from .buckets import Bucket  # noqa: F401  (re-export; keys are opaque here)


def network_fingerprint(csp: CSP) -> str:
    """Content hash of the constraint *network* (cons, mask, shape). Two CSPs
    sharing a fingerprint share a prepared slot; their domains stay separate
    (the domain rides each request, not the network). Hashed from host numpy
    copies, so `repro.service.network_fingerprint` gives the same hex digest
    for the same network."""
    cons = to_numpy(csp.cons)
    mask = to_numpy(csp.mask)
    h = hashlib.sha1()
    h.update(repr(cons.shape).encode())
    h.update(np.packbits(cons).tobytes())
    h.update(np.packbits(mask).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class CacheEntry:
    """One resident network: where it lives and who is flying against it.
    ``bucket`` is an opaque hashable runtime key — the service keys runtimes
    by (Bucket, engine fallback level), so networks prepared on different
    ladder levels never alias a slot."""

    bucket: object
    fingerprint: str
    slot: int
    nbytes: int
    pins: int = 0


class PreparedNetworkCache:
    """LRU cache of resident prepared networks under a byte budget.

    ``acquire`` returns a pinned entry (installing via ``build`` on miss,
    evicting LRU *unpinned* entries first when over budget); ``release`` drops
    a pin when a search retires — the entry stays resident (warm) until
    evicted by a later admission. ``on_evict`` is the service's callback that
    returns the evicted entry's slot to its bucket pool.
    """

    def __init__(self, byte_budget: int, on_evict: Callable[[CacheEntry], None]):
        if byte_budget < 1:
            raise ValueError("cache needs a positive byte budget")
        self.byte_budget = byte_budget
        self._on_evict = on_evict
        self._entries: "OrderedDict[Tuple[Bucket, str], CacheEntry]" = OrderedDict()
        self.bytes_in_use = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, bucket: Bucket, fingerprint: str) -> Optional[CacheEntry]:
        """Peek without pinning or LRU promotion (introspection/tests)."""
        return self._entries.get((bucket, fingerprint))

    def acquire(
        self,
        bucket: Bucket,
        fingerprint: str,
        nbytes: int,
        build: Callable[[], int],
    ) -> Tuple[CacheEntry, bool]:
        """Pin (and on miss, install) the network. ``build()`` does the actual
        slot install and returns the slot id. Returns (entry, was_hit).

        A fault fired (or raised by ``build``) before the entry is registered
        leaves the cache byte-exact: no entry, no pin, no bytes accounted."""
        faults.inject("cache.lookup", fingerprint=fingerprint[:12])
        key = (bucket, fingerprint)
        with obs.span("cache.lookup", cat="cache") as _sp:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.pins += 1
                self.hits += 1
                obs.counter_add("cache.hits")
                if _sp is not None:
                    _sp.args["hit"] = True
                return entry, True
            self.misses += 1
            obs.counter_add("cache.misses")
            if _sp is not None:
                _sp.args["hit"] = False
            self._evict_down_to(self.byte_budget - nbytes)
            # the miss path's build() (slot install) nests under this span —
            # a cache.lookup that cost milliseconds IS the re-preparation
            slot = build()
            entry = CacheEntry(bucket, fingerprint, slot, nbytes, pins=1)
            self._entries[key] = entry
            self.bytes_in_use += nbytes
        return entry, False

    def release(self, entry: CacheEntry) -> None:
        """Drop one pin (a search against this network retired)."""
        if entry.pins <= 0:
            raise ValueError(f"release without pin: {entry.fingerprint[:12]}")
        entry.pins -= 1

    def _evict_down_to(self, target_bytes: int) -> None:
        """Evict LRU-first until ``bytes_in_use <= target`` — skipping pinned
        entries unconditionally (in-flight networks are never evicted)."""
        if self.bytes_in_use <= target_bytes:
            return
        for key in list(self._entries):
            if self.bytes_in_use <= target_bytes:
                break
            entry = self._entries[key]
            if entry.pins > 0:
                continue
            del self._entries[key]
            self.bytes_in_use -= entry.nbytes
            self.evictions += 1
            obs.counter_add("cache.evictions")
            self._on_evict(entry)

    def stats(self) -> Dict[str, int]:
        return {
            "resident": len(self._entries),
            "bytes_in_use": self.bytes_in_use,
            "byte_budget": self.byte_budget,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
