"""repro_torch.faults — deterministic, seeded fault injection (DESIGN.md §12).

Production failure modes — a kernel launch that dies, a garbage verdict
plane, a stale autotune schedule, an OOM-shaped allocation error — are rare
enough on a healthy box that the recovery machinery around them would rot
untested. This package makes them *reproducible*: named injection sites sit
on the real host-side boundaries of the request path, and a seeded `FaultPlan`
decides, per site, whether a given crossing raises.

Sites (the complete list is `KNOWN_SITES`; each names the host boundary it
guards):

- ``service.admit``   — request admission (`SolverService._admit_one`)
- ``cache.lookup``    — prepared-network cache acquire (`service/cache.py`)
- ``slot.install``    — slot-table install (`core.engine.SlotPool.install`)
- ``frontier.step``   — frontier round dispatch (`FrontierTable`/host store)
- ``kernel.launch``   — kernel-layer host entries (`kernels/ops.py` prepare
  paths and the launch edge of every dispatch)
- ``round.resolve``   — lockstep round resolution (`LockstepDriver._advance`)

The hook is ``inject(site, **ctx)``. With no plan configured (the default —
``REPRO_TORCH_FAULTS`` unset) it is a single global-is-None check and returns
immediately, so the fault layer adds zero measurable overhead to production
paths; the acceptance gate for that claim is `check_regression` holding the
service p95 against the pre-faults baseline.

Recipes are strings, set programmatically via `configure` or from the
environment (``REPRO_TORCH_FAULTS``, seeded by ``REPRO_TORCH_FAULTS_SEED``):

    REPRO_TORCH_FAULTS="all:0.05"                      # every site at 5%
    REPRO_TORCH_FAULTS="frontier.step:0.1:oom"         # one site, OOM-shaped
    REPRO_TORCH_FAULTS="cache.lookup:1.0:fault:2"      # fire exactly twice
    REPRO_TORCH_FAULTS="all:0.05,round.resolve:0.2:garbage"

``site:rate[:kind[:max_fires]]``, comma-separated; ``all`` expands to every
known site (later entries override). Kinds map to the typed exceptions below:
``fault`` → `InjectedFault`, ``garbage`` → `GarbageVerdict` (NaN/garbage
verdict plane), ``stale`` → `StaleSchedule` (autotune schedule for a shape
that no longer exists), ``oom`` → `OomError` (also a `MemoryError`).

Determinism: each site draws from its own `numpy` Generator seeded by
``(seed, crc32(site))``, so whether the k-th crossing of a site faults is a
pure function of (recipe, seed, k) — independent of dict ordering, other
sites' traffic, or process hashing. That is what lets `tests/test_faults.py`
assert bit-identical verdicts against the no-fault oracle run.

Every fired injection ticks ``faults.injected`` and
``faults.injected.<site>`` in the `repro_torch.obs` registry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import zlib
from typing import Dict, Optional, Union

import numpy as np

from repro_torch import obs

#: every wired injection site (recipes naming anything else are rejected)
KNOWN_SITES = (
    "service.admit",
    "cache.lookup",
    "slot.install",
    "frontier.step",
    "kernel.launch",
    "round.resolve",
)


class FaultError(Exception):
    """Base of every injectable failure. ``site`` names the injection site
    (or the real boundary that raised); the service's retry/fallback ladder
    catches exactly this type."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(f"{site}: {detail}" if detail else site)


class InjectedFault(FaultError):
    """A generic injected failure (recipe kind ``fault``)."""


class GarbageVerdict(FaultError):
    """A verdict plane that came back NaN/garbage — the device returned
    bits that cannot be trusted as consistency metadata (kind ``garbage``)."""


class StaleSchedule(FaultError):
    """An autotune schedule referencing a bucket/block shape that no longer
    matches the compiled program (kind ``stale``)."""


class OomError(FaultError, MemoryError):
    """An OOM-shaped allocation failure at a device boundary (kind ``oom``).
    Subclasses `MemoryError` so generic OOM handling also sees it."""


class Overloaded(Exception):
    """Typed load-shed verdict: the service refused the request *before*
    spending padding/preparation work on it. ``retry_after_s`` is the
    service's estimate of when capacity frees up — the client-facing
    Retry-After hint."""

    def __init__(self, retry_after_s: float = 0.0, detail: str = "overloaded"):
        self.retry_after_s = float(retry_after_s)
        super().__init__(f"{detail} (retry after ~{retry_after_s:.2f}s)")


_KIND_EXC = {
    "fault": InjectedFault,
    "garbage": GarbageVerdict,
    "stale": StaleSchedule,
    "oom": OomError,
}

_KIND_DETAIL = {
    "fault": "injected fault",
    "garbage": "injected NaN/garbage verdict plane",
    "stale": "injected stale autotune schedule",
    "oom": "injected OOM-shaped allocation failure",
}


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One site's injection policy: fire with probability ``rate`` per
    crossing, raising the ``kind`` exception, at most ``max_fires`` times
    (None = unbounded). ``rate=1.0`` fires on every crossing."""

    rate: float
    kind: str = "fault"
    max_fires: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")
        if self.kind not in _KIND_EXC:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {sorted(_KIND_EXC)}"
            )
        if self.max_fires is not None and self.max_fires < 0:
            raise ValueError("max_fires must be >= 0 (or None)")


class FaultPlan:
    """A seeded injection plan over `KNOWN_SITES`. Each site owns an
    independent Generator seeded ``(seed, crc32(site))`` — crc32, not
    ``hash()``, because the latter is salted per process and would break
    cross-run determinism."""

    def __init__(self, sites: Dict[str, SiteSpec], seed: int = 0):
        unknown = sorted(set(sites) - set(KNOWN_SITES))
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {unknown}; known: {list(KNOWN_SITES)}"
            )
        self.sites = dict(sites)
        self.seed = int(seed)
        self._rngs = {
            s: np.random.default_rng((self.seed, zlib.crc32(s.encode())))
            for s in self.sites
        }
        #: per-site observed crossings / raised faults (introspection + tests)
        self.draws: Dict[str, int] = {s: 0 for s in self.sites}
        self.fires: Dict[str, int] = {s: 0 for s in self.sites}

    def roll(self, site: str) -> Optional[str]:
        """One crossing of ``site``: returns the fault kind to raise, or None.
        Draws ALWAYS advance the site's RNG stream (even past ``max_fires``),
        so the k-th crossing's outcome never depends on earlier handling."""
        spec = self.sites.get(site)
        if spec is None:
            return None
        self.draws[site] += 1
        fire = self._rngs[site].random() < spec.rate
        if not fire:
            return None
        if spec.max_fires is not None and self.fires[site] >= spec.max_fires:
            return None
        self.fires[site] += 1
        return spec.kind

    @property
    def total_fires(self) -> int:
        return sum(self.fires.values())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        parts = ", ".join(
            f"{s}:{sp.rate:g}:{sp.kind}" for s, sp in sorted(self.sites.items())
        )
        return f"<FaultPlan seed={self.seed} [{parts}] fires={self.total_fires}>"


def parse_recipe(recipe: str) -> Dict[str, SiteSpec]:
    """``site:rate[:kind[:max_fires]]`` comma-list → site specs. ``all``
    expands to every known site; later entries override earlier ones."""
    sites: Dict[str, SiteSpec] = {}
    for part in recipe.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2 or len(fields) > 4:
            raise ValueError(
                f"bad fault recipe entry {part!r} "
                "(want site:rate[:kind[:max_fires]])"
            )
        site, rate = fields[0].strip(), float(fields[1])
        kind = fields[2].strip() if len(fields) > 2 and fields[2].strip() else "fault"
        max_fires = int(fields[3]) if len(fields) > 3 else None
        spec = SiteSpec(rate, kind, max_fires)
        targets = KNOWN_SITES if site == "all" else (site,)
        for t in targets:
            if t not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {t!r}; known: {list(KNOWN_SITES)}"
                )
            sites[t] = spec
    if not sites:
        raise ValueError(f"empty fault recipe {recipe!r}")
    return sites


# the process-wide plan; None = fault layer off (the production default)
_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    return _PLAN is not None


def active() -> Optional[FaultPlan]:
    """The live plan (for introspection: ``active().fires`` etc.), or None."""
    return _PLAN


def configure(
    recipe: Union[str, Dict[str, SiteSpec], FaultPlan],
    seed: Optional[int] = None,
) -> FaultPlan:
    """Install a process-wide fault plan from a recipe string, a site-spec
    dict, or a ready `FaultPlan`. Returns the installed plan."""
    global _PLAN
    if isinstance(recipe, FaultPlan):
        plan = recipe
    else:
        sites = parse_recipe(recipe) if isinstance(recipe, str) else dict(recipe)
        plan = FaultPlan(sites, seed=0 if seed is None else seed)
    _PLAN = plan
    return plan


def clear() -> None:
    """Remove the process-wide plan — `inject` returns to its no-op path."""
    global _PLAN
    _PLAN = None


@contextlib.contextmanager
def injected(recipe: Union[str, Dict[str, SiteSpec]], seed: int = 0):
    """Scoped plan for tests: install, yield the plan, always restore the
    previous state (usually None) on exit."""
    global _PLAN
    prev = _PLAN
    plan = configure(recipe, seed=seed)
    try:
        yield plan
    finally:
        _PLAN = prev


def inject(site: str, **ctx) -> None:
    """The injection hook. With no plan installed this is ONE global check —
    the zero-overhead-off contract every hot path relies on. With a plan, the
    site's seeded RNG decides whether this crossing raises its typed fault;
    ``ctx`` rides into the exception detail and the obs span args."""
    plan = _PLAN
    if plan is None:
        return
    kind = plan.roll(site)
    if kind is None:
        return
    obs.counter_add("faults.injected")
    obs.counter_add(f"faults.injected.{site}")
    detail = _KIND_DETAIL[kind]
    if ctx:
        detail += " [" + ", ".join(f"{k}={v}" for k, v in sorted(ctx.items())) + "]"
    raise _KIND_EXC[kind](site, detail)


def enable_from_env() -> None:
    """Install a plan from ``REPRO_TORCH_FAULTS`` / ``REPRO_TORCH_FAULTS_SEED`` if set —
    called once at import, mirroring `repro_torch.obs.enable_from_env`."""
    recipe = os.environ.get("REPRO_TORCH_FAULTS")
    if recipe:
        configure(recipe, seed=int(os.environ.get("REPRO_TORCH_FAULTS_SEED", "0")))


enable_from_env()
