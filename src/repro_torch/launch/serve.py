"""Serving driver — replay a seeded arrival trace through `SolverService`.

The port's service entry point, the counterpart of `repro.launch.serve`:
draws a Poisson arrival trace over the `repro_torch.problems` registry,
feeds it through the continuous-batching solver service against a
fast-forward clock (idle gaps are skipped, queueing under load is real),
and prints sustained throughput plus tail latency.

    python -m repro_torch.launch.serve --trace poisson \
        --families model_rb,coloring_random --rate 8 --duration 20 \
        --engine hopper_packed
    python -m repro_torch.launch.serve --device cpu --duration 2

The service runs on ``--device`` (default ``cuda``; without a card, pass
``--device cpu`` to run the kernels' plain PyTorch versions).

With ``--trace-out run.json`` (or ``REPRO_TORCH_TRACE=1`` in the
environment) the replay runs under the `repro_torch.obs` tracer and drops
the full run payload plus a ``run.perfetto.json`` timeline next to it —
load the latter in ui.perfetto.dev, or ``python -m repro_torch.obs
summarize run.json``.

With ``--faults RECIPE`` (or ``REPRO_TORCH_FAULTS`` in the environment) the
replay runs under seeded fault injection — the chaos drill: every future
must still resolve, demotions ride the fallback ladder, and the outcome line
breaks down recovered / shed / failed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch import faults, obs
from repro_torch.service import (
    DEFAULT_VARIANTS,
    FastForwardClock,
    RequestStatus,
    SolverService,
    poisson_trace,
    replay,
)

TRACES = ("poisson",)


def serve(
    families=("model_rb", "coloring_random"),
    trace: str = "poisson",
    rate: float = 8.0,
    duration: float = 20.0,
    engine: str = "einsum",
    seed: int = 0,
    cache_mb: int = 256,
    deadline_s: float = None,
    max_assignments: int = None,
    initial_slots: int = 8,
    quiet: bool = False,
    trace_out: str = None,
    trace_timing: str = "async",
    faults_recipe: str = None,
    faults_seed: int = 0,
    service_kwargs: dict = None,
    device: str = "cuda",
):
    """Run one trace replay on ``device``; returns (service, requests). With ``trace_out``
    set, the replay is traced (enabling the obs tracer if the environment
    didn't already) and the run payload + Perfetto timeline land on disk.
    ``faults_recipe`` installs a seeded `repro_torch.faults` plan for the
    replay (on top of any ``REPRO_TORCH_FAULTS`` already active); ``service_kwargs``
    forwards extra `SolverService` knobs (retry caps, watchdog limits, shed
    thresholds)."""
    if trace not in TRACES:
        raise ValueError(f"unknown trace {trace!r}; available: {list(TRACES)}")
    if trace_out and not obs.enabled():
        obs.enable(timing=trace_timing)
    if faults_recipe:
        faults.configure(faults_recipe, seed=faults_seed)
    events = poisson_trace(list(families), rate=rate, duration=duration, seed=seed)
    clock = FastForwardClock()
    svc = SolverService(
        engine=engine,
        device=device,
        cache_bytes=cache_mb << 20,
        initial_slots=initial_slots,
        clock=clock,
        **(service_kwargs or {}),
    )
    if not quiet:
        print(
            f"[serve] engine={engine} device={svc.device} trace={trace} "
            f"families={','.join(families)} "
            f"rate={rate:g}/s duration={duration:g}s seed={seed} "
            f"-> {len(events)} requests"
        )
    requests = replay(
        svc, events, clock, deadline_s=deadline_s, max_assignments=max_assignments
    )

    snap = svc.snapshot()
    if not quiet:
        n_to = snap["timed_out"]
        print(
            f"[serve] completed {snap['completed']}/{snap['submitted']}"
            + (f" ({n_to} timed out)" if n_to else "")
            + f" over {snap['span_s']:.2f}s of service time"
        )
        plan = faults.active()
        if plan is not None or snap["shed"] or snap["failed"]:
            n_rec = sum(
                r.status is RequestStatus.DONE
                and (r.retries > 0 or r.engine_level > 0)
                for r in requests
            )
            print(
                f"[serve] robustness: {plan.total_fires if plan else 0} faults "
                f"injected | {n_rec} recovered, {snap['shed']} shed, "
                f"{snap['failed']} failed | {snap['retries']} retries, "
                f"{snap['demotions']} demotions, "
                f"{snap['breaker_trips']} breaker trips"
            )
        print(
            f"[serve] throughput {snap['throughput_rps']:.2f} inst/s | "
            f"latency p50 {snap['p50_ms']:.1f} ms  p95 {snap['p95_ms']:.1f} ms  "
            f"p99 {snap['p99_ms']:.1f} ms"
        )
        cache = snap["cache"]
        print(
            f"[serve] {snap['rounds']} rounds, {snap['mean_rows_per_dispatch']:.1f} "
            f"rows/dispatch | cache {cache['hits']} hits / {cache['misses']} misses "
            f"/ {cache['evictions']} evictions | buckets "
            + " ".join(
                f"{b}:{info['capacity']}slots" for b, info in snap["buckets"].items()
            )
        )
        n_solved = sum(r.solution is not None for r in requests)
        n_capped = sum(
            r.status is RequestStatus.DONE and r.solution is None
            and r.stats is not None and r.stats.exhausted
            for r in requests
        )
        n_unsat = sum(
            r.status is RequestStatus.DONE and r.solution is None
            and not (r.stats is not None and r.stats.exhausted)
            for r in requests
        )
        print(
            f"[serve] outcomes: {n_solved} SAT, {n_unsat} UNSAT"
            + (f", {n_capped} budget-capped (inconclusive)" if n_capped else "")
        )
    if trace_out and obs.enabled():
        run_path = Path(trace_out)
        tracer = obs.get_tracer()
        obs.dump_run(run_path, tracer=tracer)
        perfetto_path = run_path.with_name(run_path.stem + ".perfetto.json")
        obs.write_trace(perfetto_path, tracer)
        if not quiet:
            spans = tracer.snapshot_spans()
            cov = obs.child_coverage(spans, "driver.round")
            print(
                f"[serve] obs run -> {run_path} ({len(spans)} spans, "
                f"driver.round child coverage {cov:.1%}); "
                f"timeline -> {perfetto_path}"
            )
    return svc, requests


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default="poisson", choices=TRACES)
    ap.add_argument(
        "--families",
        default="model_rb,coloring_random",
        help=f"comma-separated problem families (known: {sorted(DEFAULT_VARIANTS)})",
    )
    ap.add_argument("--rate", type=float, default=8.0, help="arrivals per second")
    ap.add_argument("--duration", type=float, default=20.0, help="trace length (s)")
    ap.add_argument("--engine", default="einsum")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-mb", type=int, default=256, help="prepared-network cache budget")
    ap.add_argument("--deadline", type=float, default=None, help="per-request deadline (s)")
    ap.add_argument("--budget", type=int, default=None, help="per-request assignment budget")
    ap.add_argument("--slots", type=int, default=8, help="initial slots per bucket")
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="trace the replay and write the obs run payload here "
             "(a .perfetto.json timeline lands next to it)",
    )
    ap.add_argument(
        "--trace-timing", default="async", choices=("async", "fenced"),
        help="span timing mode: 'fenced' blocks on device results inside "
             "kernel.launch spans so durations are true device time",
    )
    ap.add_argument(
        "--faults", default=None, metavar="RECIPE",
        help="seeded fault-injection recipe, e.g. 'all:0.05' or "
             "'frontier.step:0.1:oom' (same syntax as REPRO_TORCH_FAULTS)",
    )
    ap.add_argument("--faults-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the service runs (default: the card)")
    args = ap.parse_args(argv)
    serve(
        families=[f.strip() for f in args.families.split(",") if f.strip()],
        trace=args.trace,
        rate=args.rate,
        duration=args.duration,
        engine=args.engine,
        seed=args.seed,
        cache_mb=args.cache_mb,
        deadline_s=args.deadline,
        max_assignments=args.budget,
        initial_slots=args.slots,
        trace_out=args.trace_out,
        trace_timing=args.trace_timing,
        faults_recipe=args.faults,
        faults_seed=args.faults_seed,
        device=args.device,
    )


if __name__ == "__main__":
    main()
