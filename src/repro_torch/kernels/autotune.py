"""Tuned launch schedules for the Hopper kernels (the counterpart of
`repro.kernels.autotune`).

The CUDA kernels expose a *schedule* that never changes results, only which
compiled instantiation runs and the shape of its grid:

- ``width`` — the fused fixpoints (kinds ``packed``, ``dense``) and the
  stacked revises (``packed_revise``, ``dense_revise``): ``"compiled"`` runs
  the instantiation compiled for the entry width where there is one (packed
  W = 1 and 2, dense d/8 = 2; `compiled_width`), ``"runtime"`` the one that
  reads the width at run time. Both run the same support tests on the same
  words.
- ``span`` — the single-network revises (``packed_single``,
  ``dense_single``): the variables one CTA revises, a multiple of 8 and at
  most n_p rounded up to 8, so a row's variables go to ceil(n_p/span) CTAs.
  Each CTA writes the bytes of its own variables, from the same tests.
  Where ``launch.single_wide`` holds (from n_p = 2048, or where a narrow
  CTA owning a row would not fit) these revises run the block route, which
  picks its own grid: the one schedule there is 0, the default.

This module picks the fastest schedule per shape bucket, once, and persists
the choice.

- Buckets are ``kind/n{n_p}/d{d_p}/w{W}/r{pow2(R)}`` (W = 0 for the dense
  kinds), the reference's format: padded kernel dims are already quantized
  and the row count R is pow2-bucketed like the frontier's round widths.
- `tune`/`ensure_tuned` time every candidate of a bucket on the card with
  CUDA events, on a seeded synthetic workload of real `random_csp` networks
  at the bucket shape, and store the winner. `tune` raises on a CPU device:
  there the wrappers run their plain versions and there is nothing to tune.
- The winners persist in a versioned JSON cache, by default
  ``~/.cache/repro_torch/autotune.json`` (``REPRO_TORCH_AUTOTUNE_CACHE``
  overrides it); the reference's cache is never read or written.
- The engines call `maybe_tune` before their first dispatch of a bucket.
  With ``REPRO_TORCH_AUTOTUNE=1`` it tunes the bucket if the cache has no
  entry and makes its schedule active. The kernel wrappers read the active
  schedules through `schedule` — one dict read on a tuple a launch. An
  untuned bucket, and every bucket with the gate unset, gets the default:
  the launch the unscheduled C launchers make (`default_config`).
- ``python -m repro_torch.kernels.autotune`` tunes one bucket.

Cache format (``repro-torch-autotune/v1``)::

    {"schema": "repro-torch-autotune/v1",
     "configs": {"packed/n104/d40/w2/r1024": {"width": "compiled"},
                 "packed_single/n104/d40/w2/r2": {"span": 16}}}
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import next_pow2
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.launch import single_wide

SCHEMA = "repro-torch-autotune/v1"
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
TUNE_ENV = "REPRO_TORCH_AUTOTUNE"

#: kind -> (kernel module, wrapper) of the kernel it schedules
KINDS = {
    "packed": ("bitpack_support", "packed_fixpoint_stacked"),
    "dense": ("rtac_support", "dense_fixpoint_stacked"),
    "packed_revise": ("bitpack_support", "packed_revise_stacked"),
    "dense_revise": ("rtac_support", "dense_revise_stacked"),
    "packed_single": ("bitpack_support", "packed_revise"),
    "dense_single": ("rtac_support", "dense_revise"),
}
SPAN_KINDS = ("packed_single", "dense_single")
#: the width schedules, in the order of their C values (kCompiledWidth = 0,
#: kRuntimeWidth = 1 in csrc/fixpoint_common.cuh)
WIDTHS = ("compiled", "runtime")
#: single-network CTAs the default span aims to give each SM (kCtasPerSm in
#: csrc/revise_common.cuh), and an H100's SM count, used without a card
CTAS_PER_SM = 4
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One launch schedule: ``width`` for the fused and stacked kinds,
    ``span`` for the single-network ones. Every field is parity-neutral by
    construction (see the module docstring): tuning never changes results."""

    width: Optional[str] = None
    span: Optional[int] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "TuneConfig":
        return cls(width=str(d["width"]) if "width" in d else None,
                   span=int(d["span"]) if "span" in d else None)

    def sched(self) -> int:
        """The schedule as the ``*_launch_sched`` launchers take it: the
        span, or the width's C value."""
        return self.span if self.span is not None else WIDTHS.index(self.width)


#: every config known, keyed by bucket string: the loaded cache and `tune`'s
#: winners
_CONFIGS: Dict[str, TuneConfig] = {}
_LOADED: Optional[str] = None  # path the table was loaded from, or None
#: the schedules `maybe_tune` made active, keyed (kind, n_p, d_p, W, pow2(R)):
#: the configs, and their C values the wrappers read
_ACTIVE: Dict[tuple, TuneConfig] = {}
_SCHEDULES: Dict[tuple, int] = {}
#: bucket -> [(config, seconds a launch)] of the searches `tune` ran
SEARCHES: Dict[str, List[Tuple[TuneConfig, float]]] = {}


def cache_path() -> Path:
    override = os.environ.get(CACHE_ENV)
    if override:
        return Path(override)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


def entry_words(kind: str, d_p: int) -> int:
    """The W of a bucket key: packed words an entry, 0 for the dense kinds."""
    return -(-d_p // 32) if kind.startswith("packed") else 0


def bucket_key(kind: str, n_p: int, d_p: int, w: int, r: int) -> str:
    """Bucket id: kernel dims are already padded; the row count R is
    pow2-bucketed (the quantization of the frontier's round widths)."""
    return f"{kind}/n{n_p}/d{d_p}/w{w}/r{next_pow2(max(int(r), 1))}"


def load_cache(path: Optional[Path] = None, force: bool = False) -> int:
    """Merge the on-disk cache into the in-memory table (idempotent; a
    missing, corrupt or other-schema file loads zero entries). Returns the
    number of entries."""
    global _LOADED
    p = Path(path) if path is not None else cache_path()
    if _LOADED == str(p) and not force:
        return len(_CONFIGS)
    try:
        payload = json.loads(p.read_text())
        if payload.get("schema") != SCHEMA:
            raise ValueError(f"unknown autotune schema {payload.get('schema')!r}")
        loaded = {key: TuneConfig.from_dict(cfg) for key, cfg in payload["configs"].items()}
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        loaded = {}
    _CONFIGS.update(loaded)
    _LOADED = str(p)
    return len(_CONFIGS)


def save_cache(path: Optional[Path] = None) -> Path:
    p = Path(path) if path is not None else cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {"schema": SCHEMA,
               "configs": {k: c.to_dict() for k, c in sorted(_CONFIGS.items())}}
    p.write_text(json.dumps(payload, indent=2) + "\n")
    return p


def reset(clear_loaded: bool = True) -> None:
    """Drop the in-memory tables and the active schedules (tests, and runs
    that compare tuned launches with the default ones)."""
    global _LOADED
    _CONFIGS.clear()
    _ACTIVE.clear()
    _SCHEDULES.clear()
    SEARCHES.clear()
    _tune_networks.cache_clear()
    if clear_loaded:
        _LOADED = None


# ---------------------------------------------------------------------------
# The default schedule: what the unscheduled launchers do
# ---------------------------------------------------------------------------


def compiled_width(kind: str, d_p: int) -> bool:
    """Whether ``kind``'s kernel has an instantiation compiled for this entry
    width (csrc/*.cu): packed W = 1 and 2, dense d/8 = 2. The single-network
    kinds' widths are not a tuned knob."""
    if kind.startswith("packed"):
        return entry_words(kind, d_p) in (1, 2)
    return d_p // 8 == 2


def _sm_count() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return H100_SMS


def single_span(rows: int, n: int, sms: Optional[int] = None) -> int:
    """`revise::single_span` (csrc/revise_common.cuh): the fewest variables
    a CTA (a multiple of 8) that still give the card `CTAS_PER_SM` CTAs an
    SM over ``rows`` rows, and at least one variable a warp. ``sms``
    defaults to the card's SM count, or an H100's without a card. The
    narrow route's rule alone: where `launch.single_wide` holds the block
    route takes no span (`default_config`)."""
    sms = _sm_count() if sms is None else sms
    blocks = -(-n // 8)  # groups of 8 variables
    groups = max(1, min(-(-(CTAS_PER_SM * sms) // rows), blocks))
    return 8 * -(-blocks // groups)


def default_config(kind: str, n_p: int, d_p: int, r: int) -> TuneConfig:
    """The schedule of an untuned bucket, exactly the unscheduled launch: the
    compiled width where there is one, or `single_span`'s rule (0 on the
    wide route, `single_wide`)."""
    if kind in SPAN_KINDS:
        if single_wide(n_p, d_p):
            return TuneConfig(span=0)
        return TuneConfig(span=single_span(next_pow2(max(r, 1)), n_p))
    return TuneConfig(width=WIDTHS[0] if compiled_width(kind, d_p) else WIDTHS[1])


def _sanitize(kind: str, cfg: TuneConfig, n_p: int, d_p: int, r: int) -> TuneConfig:
    """A cached schedule must still fit this shape (the cache may predate a
    layout change): a span that is not a positive multiple of 8 at most n_p
    rounded up to 8, or a width with no instantiation for the shape, falls
    back to the default field."""
    default = default_config(kind, n_p, d_p, r)
    if kind in SPAN_KINDS:
        span = cfg.span
        ok = span == default.span or (span is not None and not single_wide(n_p, d_p)
                                      and 0 < span <= 8 * -(-n_p // 8) and span % 8 == 0)
        return TuneConfig(span=span if ok else default.span)
    ok = cfg.width == "runtime" or (cfg.width == "compiled" and compiled_width(kind, d_p))
    return TuneConfig(width=cfg.width if ok else default.width)


def get_config(kind: str, n_p: int, d_p: int, w: int, r: int) -> TuneConfig:
    """The bucket's schedule: the cached one, sanitized, or the default. A
    pure read; it never times anything."""
    if _LOADED is None:
        load_cache()
    cfg = _CONFIGS.get(bucket_key(kind, n_p, d_p, w, r))
    if cfg is None:
        return default_config(kind, n_p, d_p, r)
    return _sanitize(kind, cfg, n_p, d_p, r)


def schedule(kind: str, n_p: int, d_p: int, w: int, r: int) -> Optional[int]:
    """The wrappers' lookup, once a launch: the active schedule of the
    bucket (the C value), or None for the default launch."""
    if not _SCHEDULES:
        return None
    return _SCHEDULES.get((kind, n_p, d_p, w, 1 << (r - 1).bit_length()))


# ---------------------------------------------------------------------------
# The search: on the card, never on the CPU
# ---------------------------------------------------------------------------


def candidate_configs(kind: str, n_p: int, d_p: int, r: int) -> List[TuneConfig]:
    """Both widths where a compiled one exists (else the run-time one
    alone); for the single-network kinds the smallest span of each distinct
    count of CTAs a row, widest first (7 at n_p = 104 or 128), and on the
    wide route (`single_wide`) the default alone."""
    if kind in SPAN_KINDS:
        if single_wide(n_p, d_p):
            return [default_config(kind, n_p, d_p, r)]
        blocks = -(-n_p // 8)
        spans = sorted({8 * -(-blocks // g) for g in range(1, blocks + 1)}, reverse=True)
        return [TuneConfig(span=s) for s in spans]
    return [TuneConfig(width=x) for x in (WIDTHS if compiled_width(kind, d_p) else WIDTHS[1:])]


class Workload(NamedTuple):
    """A kernel's operands (in its wrapper's argument order) and keywords."""

    args: tuple
    kw: dict


def _wrapper(kind: str, plain: bool = False):
    from repro_torch import kernels

    module, name = KINDS[kind]
    return getattr(getattr(kernels, module), f"{name}_plain" if plain else name)


@functools.lru_cache(maxsize=4)
def _tune_networks(packed: bool, n_p: int, d_p: int, count: int, device: str) -> list:
    """``count`` seeded `random_csp` networks at (n_p, d_p), prepared for the
    packed or dense kernels on ``device`` (kept for the next bucket of the
    shape: drawing a network costs more than timing its candidates)."""
    from repro_torch.core.csp import random_csp
    from repro_torch.kernels import ops

    prepare = ops.prepare_packed if packed else ops.prepare_dense
    prepared = [prepare(random_csp(n_p, d_p, 0.6, 0.5, seed=1000 + i, device=device),
                        device=device, memo=False) for i in range(count)]
    if prepared[0][2][:2] != (n_p, d_p):
        raise ValueError(f"bucket ({n_p}, {d_p}) is not a padded shape: got {prepared[0][2]}")
    return prepared


def _tune_workload(kind: str, n_p: int, d_p: int, r: int, device: Device) -> Workload:
    """A seeded synthetic bucket workload of real `random_csp` networks at
    exactly the padded shape (n_p and d_p are multiples of 8, so preparation
    keeps it). Stacked kinds: 3 networks, rows round-robin over them, 7 rows
    in 8 a root domain with one random assignment and its one-hot seed and
    the eighth a root row, every variable seeded (the main path's mix).
    Single-network kinds: one network, r rows each with one random
    assignment, seeded on that variable and on about a tenth of the others
    (`mac_solve` calls with about 10 seeds a row)."""
    from repro_torch.kernels import ops, ref

    packed = kind.startswith("packed")
    single = kind in SPAN_KINDS
    device = torch.device(device)
    prepared = _tune_networks(packed, n_p, d_p, 1 if single else 3, str(device))
    rng = np.random.default_rng([n_p, d_p, r])
    var = rng.integers(0, n_p, r)
    val = torch.as_tensor(rng.integers(0, d_p, r), device=device)
    if single:
        seed = rng.random((r, n_p)) < 0.1
        seed[np.arange(r), var] = True
        seed = torch.as_tensor(seed, device=device)
    else:
        var[::8] = -1
        seed = ops._padded_seed(torch.as_tensor(var, device=device), n_p, n_p)
    var = torch.as_tensor(var, device=device)
    idx = torch.arange(r, device=device, dtype=torch.int32) % len(prepared)
    dom_p = ops.assign_padded_rows(prepared[0][1].expand(r, n_p, d_p), var, val)
    rows = (ref.pack_bits_ref(dom_p).reshape(r, -1) if packed
            else dom_p.to(torch.uint8).reshape(r, -1)).contiguous()
    seed = seed.to(torch.uint8).contiguous()
    kw = dict(d=d_p, w=entry_words(kind, d_p)) if packed else dict(d=d_p)
    if single:
        return Workload((*prepared[0][0], rows, seed), kw)
    tables = [torch.stack([p[0][i] for p in prepared]) for i in (0, 1)]
    return Workload((*tables, idx, rows, seed), kw)


def run_candidate(kind: str, workload: Workload, cfg: Optional[TuneConfig]):
    """One call of ``kind``'s wrapper on ``workload`` with ``cfg``'s
    schedule, or of its plain version for ``cfg`` None."""
    if cfg is None:
        return _wrapper(kind, plain=True)(*workload.args, **workload.kw)
    return _wrapper(kind)(*workload.args, **workload.kw, sched=cfg.sched())


_SLEEP_CYCLES_PER_MS: Dict[str, float] = {}


def _sleep_cycles_per_ms(device: torch.device) -> float:
    """Cycles of ``torch.cuda._sleep`` (a private PyTorch function that spins
    one device thread) per millisecond, measured once per device."""
    key = str(device)
    if key not in _SLEEP_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS[key] = 10_000_000 / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS[key]


def _time_candidate(kind: str, workload: Workload, cfg: TuneConfig, repeats: int) -> float:
    """Seconds a launch of ``cfg`` on ``workload``: the best of ``repeats``
    runs of back-to-back launches, timed with CUDA events behind a device
    sleep twice as long as the host takes to queue them (so a kernel shorter
    than its wrapper is not timed at the host's pace). The wrapper's launch
    count is left as it was: a search's launches are not a path's."""
    fn = _wrapper(kind)
    device = workload.args[0].device
    launches = fn.launches
    try:
        run = lambda: run_candidate(kind, workload, cfg)  # noqa: E731
        run()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        reps = max(3, min(200, int(5e-3 / max(time.perf_counter() - t0, 1e-6))))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            queue_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2 * queue_ms * _sleep_cycles_per_ms(device)))
            start.record()
            for _ in range(reps):
                run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / reps)
        return best
    finally:
        fn.launches = launches


def _card(device: Device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("autotune.tune times the CUDA kernels on the card; on the CPU the "
                           "wrappers run their plain versions and there is nothing to tune")
    return device


def tune(
    kind: str,
    n_p: int,
    d_p: int,
    r: int = 8,
    *,
    device: Device = "cuda",
    repeats: int = 3,
    save: bool = True,
    path: Optional[Path] = None,
) -> TuneConfig:
    """Time every candidate schedule of one bucket on the card, record the
    winner (and every candidate's time in `SEARCHES`), persist the cache.
    Returns the winner."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; kinds: {sorted(KINDS)}")
    device = _card(device)
    r = next_pow2(max(int(r), 1))
    key = bucket_key(kind, n_p, d_p, entry_words(kind, d_p), r)
    t_search0 = time.perf_counter()
    with obs.span("autotune.search", cat="autotune", kind=kind, n=n_p, d=d_p, r=r) as sp:
        workload = _tune_workload(kind, n_p, d_p, r, device)
        candidates = candidate_configs(kind, n_p, d_p, r)
        times = [(cfg, _time_candidate(kind, workload, cfg, repeats)) for cfg in candidates]
        best = min(times, key=lambda ct: ct[1])[0]
        if sp is not None:
            sp.args["candidates"] = len(candidates)
    obs.counter_add("autotune.tuned_buckets")
    obs.observe("autotune.search_seconds", time.perf_counter() - t_search0)
    _CONFIGS[key] = best
    SEARCHES[key] = times
    if save:
        save_cache(path)
    return best


def ensure_tuned(kind: str, n_p: int, d_p: int, w: int, r: int, **tune_kwargs) -> TuneConfig:
    """The bucket's cached schedule, sanitized; tunes it only if the (loaded)
    cache has no entry."""
    if _LOADED is None:
        load_cache(tune_kwargs.get("path"))
    hit = _CONFIGS.get(bucket_key(kind, n_p, d_p, w, r))
    if hit is not None:
        return _sanitize(kind, hit, n_p, d_p, r)
    return tune(kind, n_p, d_p, r, **tune_kwargs)


def maybe_tune(kind: str, n_p: int, d_p: int, w: int, r: int,
               device: Device = "cuda") -> Optional[TuneConfig]:
    """Engine hook before a dispatch: with ``REPRO_TORCH_AUTOTUNE=1`` and a
    CUDA ``device``, tune the bucket on first use (`ensure_tuned`) and make
    its schedule active for the wrappers. Otherwise None, and the launches
    keep the default."""
    if not os.environ.get(TUNE_ENV) or torch.device(device).type != "cuda":
        return None
    key = (kind, n_p, d_p, w, next_pow2(max(int(r), 1)))
    cfg = _ACTIVE.get(key)
    if cfg is None:
        cfg = _ACTIVE[key] = ensure_tuned(kind, n_p, d_p, w, r, device=device)
        _SCHEDULES[key] = cfg.sched()
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Tune the launch schedule of one kernel bucket")
    ap.add_argument("--kind", choices=sorted(KINDS), default="packed")
    ap.add_argument("--n", type=int, default=104, help="padded var count n_p")
    ap.add_argument("--d", type=int, default=40, help="padded domain size d_p")
    ap.add_argument("--rows", type=int, default=1024, help="round width R (rows B)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cache", type=Path, default=None,
                    help=f"cache file (default: ${CACHE_ENV} or "
                         f"~/.cache/repro_torch/autotune.json)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (tunes) or 'cpu' (prints the bucket's schedule, no timing)")
    args = ap.parse_args(argv)
    if args.cache is not None:
        os.environ[CACHE_ENV] = str(args.cache)
    load_cache(args.cache)
    w = entry_words(args.kind, args.d)
    key = bucket_key(args.kind, args.n, args.d, w, args.rows)
    out = {"bucket": key, "cache": str(args.cache or cache_path())}
    if resolve_device(args.device).type == "cpu":
        cfg = get_config(args.kind, args.n, args.d, w, args.rows)
        print(json.dumps({**out, "config": cfg.to_dict(), "tuned": False, "device": "cpu"}))
        return 0
    cfg = tune(args.kind, args.n, args.d, args.rows, device=args.device,
               repeats=args.repeats, path=args.cache)
    print(json.dumps({**out, "config": cfg.to_dict(), "tuned": True,
                      "device": torch.cuda.get_device_name(),
                      "candidates": [{**c.to_dict(), "us": round(1e6 * s, 3)}
                                     for c, s in SEARCHES[key]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
