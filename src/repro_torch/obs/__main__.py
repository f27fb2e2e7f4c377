"""CLI: ``python -m repro_torch.obs summarize|export <run.json>``.

``summarize`` prints the per-phase time breakdown (by span name), the
``driver.round`` child-coverage figure, counter-derived per-solve rates
(rounds / launches / recurrences per completed solve), and speculation
outcomes. ``export`` writes ``trace.perfetto.json`` — open it at
https://ui.perfetto.dev.

Run dumps (``repro-obs/v1`` JSON: registry snapshot + tracer spans) come
from any entry point that calls `repro_torch.obs.dump_run` under
``REPRO_TORCH_TRACE=1`` — e.g. ``python -m repro_torch.launch.serve
--trace-out run.json``.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

from .export import child_coverage, export_run, load_run


def _phase_table(spans: List[dict]) -> List[tuple]:
    agg = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
    for s in spans:
        agg[s["name"]][0] += 1
        agg[s["name"]][1] += max(s["dur"], 0.0)
    return sorted(
        ((name, n, tot) for name, (n, tot) in agg.items()),
        key=lambda row: -row[2],
    )


def _per_solve(counters: dict) -> List[str]:
    solved = counters.get("service.completed", 0) or counters.get("many.solves", 0)
    lines = []
    if solved:
        for metric in ("driver.rounds", "driver.launches", "driver.recurrences"):
            v = counters.get(metric)
            if v is not None:
                lines.append(f"  {metric.split('.')[1]}/solve {v / solved:10.2f}")
    return lines


def summarize(run: dict) -> str:
    out = []
    spans = run.get("spans", [])
    snap = run.get("snapshot", {})
    counters = snap.get("counters", {})
    tracer = run.get("tracer")

    out.append(f"schema {run.get('schema')}")
    if tracer:
        out.append(
            f"tracer timing={tracer.get('timing')} spans={len(spans)} "
            f"dropped={tracer.get('dropped', 0)} "
            f"force_closed={tracer.get('force_closed', 0)}"
        )
    if spans:
        out.append("")
        out.append(f"{'span':24s} {'count':>8s} {'total_ms':>12s} {'mean_ms':>10s}")
        for name, n, tot in _phase_table(spans):
            out.append(f"{name:24s} {n:8d} {tot * 1e3:12.3f} {tot * 1e3 / n:10.3f}")
        cov = child_coverage(spans, "driver.round")
        out.append("")
        out.append(f"driver.round child coverage: {cov * 100:.1f}%")

    if counters:
        out.append("")
        out.append("counters:")
        for k in sorted(counters):
            out.append(f"  {k:32s} {counters[k]:>12g}")
        per_solve = _per_solve(counters)
        if per_solve:
            out.append("per-solve:")
            out.extend(per_solve)
        granted = counters.get("speculation.split_granted", 0) + counters.get(
            "speculation.portfolio_granted", 0
        )
        denied = counters.get("speculation.denied", 0)
        cancelled = counters.get("driver.cancelled_members", 0)
        if granted or denied or cancelled:
            out.append(
                f"speculation: {granted:g} member(s) granted, {denied:g} "
                f"request(s) denied, {cancelled:g} member(s) cancelled"
            )
    hists = snap.get("histograms", {})
    if hists:
        out.append("histograms:")
        for k in sorted(hists):
            h = hists[k]
            out.append(
                f"  {k:32s} n={h.get('count', 0):<7d} "
                f"p50={h.get('p50', 0.0):<10.3f} p90={h.get('p90', 0.0):<10.3f} "
                f"max={h.get('max', 0.0):.3f}"
            )
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize", help="print a run dump's breakdown")
    p_sum.add_argument("run", type=Path, help="run dump (repro-obs/v1 JSON)")
    p_exp = sub.add_parser("export", help="write a Perfetto-loadable trace")
    p_exp.add_argument("run", type=Path)
    p_exp.add_argument("-o", "--out", type=Path, default=None,
                       help="output path (default: <run dir>/trace.perfetto.json)")
    args = ap.parse_args(argv)

    run = load_run(args.run)
    if args.cmd == "summarize":
        print(summarize(run))
        return 0
    out = args.out if args.out is not None else args.run.parent / "trace.perfetto.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    doc = export_run(run)
    out.write_text(json.dumps(doc))
    print(f"wrote {out} ({len(doc['traceEvents'])} events) — load at ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
