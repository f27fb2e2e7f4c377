"""Analysis + report generation: sweep JSONL artifacts -> figures -> RESULTS.md.

The port's counterpart of `repro.sweeps.report`: the same claims, verdict
rules and figures (a report over the same records gives the same verdicts
and byte-identical SVGs), written under the port's own artifact root —
``<out_root>/RESULTS.md`` beside ``<out_root>/figures/`` (default
``results_torch/``), never the reference's ``results/`` or the repo-root
``RESULTS.md``.

Every entry in `CLAIMS` binds ONE paper claim to the sweep that tests it:
which figure(s) to render from the sweep's ``cells.jsonl``, and a *verdict
rule* — a pure function of the recorded cells that returns ``PASS`` or
``DEVIATES`` plus a one-line justification. ``build_report`` renders all
figures and writes ``RESULTS.md`` with one section per claim (figure,
verdict, the producing spec inline, and cross-references into the code).

Everything here is a pure function of the artifacts: no clocks, no
environment probes, stable float formatting — so regenerating the report from
unchanged JSONL is byte-identical, which is exactly what `check_report`
asserts. Where the records name a device other than the CPU (the port's
runner records it), the texts that name the host say which device it was.
Verdict rules deliberately key on
seeded-deterministic quantities (solve rates, recurrence/assignment counts,
cache hit-rates) or on scale-free ratios of timings, so a verdict never flips
with host speed.
"""

from __future__ import annotations

import dataclasses
import difflib
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .figures import Series, line_chart
from .runner import DEFAULT_OUT_ROOT, load_cells, sweep_dir
from .spec import SPEC_DIR, SweepSpec, load_spec

RESULTS_MD_NAME = "RESULTS.md"
FIG_DIR_NAME = "figures"

Records = List[Dict[str, Any]]


# --------------------------------------------------------------------------
# record pivoting
# --------------------------------------------------------------------------


def _get(rec: Dict[str, Any], path: Sequence[str]) -> Any:
    cur: Any = rec
    for k in path:
        cur = cur[k]
    return cur


def pivot(
    records: Records,
    x: str,
    y: Sequence[str],
    series_key: Optional[str] = None,
    where: Optional[Dict[str, Any]] = None,
    series_fmt: str = "{k}={v}",
) -> List[Series]:
    """Cell records -> plot series: x from ``params[x]``, y from the nested
    ``y`` path (e.g. ``("metrics", "solve_rate")``), one series per distinct
    ``params[series_key]`` value (sorted), filtered by ``where`` equality on
    params. Points within a series sort by x."""
    rows = []
    for rec in records:
        p = rec["params"]
        if where and any(p.get(k) != v for k, v in where.items()):
            continue
        rows.append((p.get(series_key) if series_key else None, p[x], _get(rec, y)))
    keys = sorted({k for k, _, _ in rows}, key=lambda v: (str(type(v)), v))
    out = []
    for k in keys:
        pts = sorted((xx, yy) for kk, xx, yy in rows if kk == k)
        label = series_fmt.format(k=series_key, v=k) if series_key else ""
        out.append(Series(label=label, x=[p[0] for p in pts], y=[p[1] for p in pts]))
    return out


def _vals(records: Records, key: str) -> List[Any]:
    return sorted({rec["params"][key] for rec in records})


def _host(records: Records) -> str:
    """Where the records were measured, as the texts name it: "CPU host"
    for records of the CPU or of no named device (the reference's), else
    the device's name."""
    devices = sorted({rec.get("device", "cpu") for rec in records} - {"cpu"})
    return " + ".join(devices) if devices else "CPU host"


# --------------------------------------------------------------------------
# claim definitions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Figure:
    filename: str
    build: Callable[[Records, SweepSpec], str]  # -> SVG text
    caption: str


@dataclasses.dataclass(frozen=True)
class Claim:
    key: str                 # RESULTS.md anchor + summary-table row
    sweep: str               # committed spec name the claim reads
    title: str
    paper: str               # the paper's stated behavior, quoted/paraphrased
    figures: Tuple[Figure, ...]
    verdict: Callable[[Records, SweepSpec], Tuple[str, str]]
    notes: str = ""          # cross-references into the code


# --- claim 1: the recurrence count stays small ------------------------------


def _fig_recurrences(records: Records, spec: SweepSpec) -> str:
    series = pivot(
        records, "density", ("metrics", "mean_count"), "n",
        where={"engine": "einsum"}, series_fmt="n={v}",
    )
    return line_chart(
        series,
        title="Recurrence count per assignment enforcement (einsum engine)",
        subtitle=(f"random_binary, d={spec.problem['knobs'].get('d')}, "
                  f"tightness={spec.problem['knobs'].get('tightness')}; "
                  "mean over sampled assignments after AC-closing the root"),
        xlabel="constraint density p",
        ylabel="#Recurrence (mean)",
    )


def _fig_work_growth(records: Records, spec: SweepSpec) -> str:
    """AC3 revisions vs RTAC recurrences, each indexed to its own smallest-n
    value at the densest grid column — growth on one axis despite the two
    different work units."""
    dens = max(_vals(records, "density"))
    series = []
    for engine, label in (("ac3", "ac3 #Revision (indexed)"),
                          ("einsum", "einsum #Recurrence (indexed)")):
        s = pivot(records, "n", ("metrics", "mean_count"), None,
                  where={"engine": engine, "density": dens})[0]
        base = s.y[0] or 1.0
        series.append(Series(label=label, x=s.x, y=[v / base for v in s.y]))
    return line_chart(
        series,
        title="Per-assignment work growth with n (indexed to smallest n)",
        subtitle=(f"random_binary at density={_fmtv(dens)}; each curve ÷ its "
                  "own value at the smallest n — unit-free growth factors"),
        xlabel="variables n",
        ylabel="work ÷ work(smallest n)",
    )


def _verdict_recurrences(records: Records, spec: SweepSpec) -> Tuple[str, str]:
    ein = [r["metrics"]["mean_count"] for r in records
           if r["params"]["engine"] == "einsum"]
    ac3 = [(r["params"]["n"], r["metrics"]["mean_count"]) for r in records
           if r["params"]["engine"] == "ac3"]
    worst = max(ein)
    ns = sorted({n for n, _ in ac3})
    ac3_growth = (max(v for n, v in ac3 if n == ns[-1])
                  / max(max(v for n, v in ac3 if n == ns[0]), 1e-9))
    ein_by_n = [(r["params"]["n"], r["metrics"]["mean_count"]) for r in records
                if r["params"]["engine"] == "einsum"]
    ein_growth = (max(v for n, v in ein_by_n if n == ns[-1])
                  / max(max(v for n, v in ein_by_n if n == ns[0]), 1e-9))
    ok = worst <= 8.0 and ein_growth <= 2.5
    detail = (
        f"max mean #Recurrence over the whole grid is {worst:.2f} "
        f"(bound 8), growing {ein_growth:.2f}× from n={ns[0]} to n={ns[-1]} "
        f"while AC3 #Revision grows {ac3_growth:.1f}× on the same cells"
    )
    return ("PASS" if ok else "DEVIATES", detail)


# --- claim 2: per-assignment enforcement time ~flat -------------------------


def _fig_time_vs_n(records: Records, spec: SweepSpec) -> str:
    dens = max(_vals(records, "density"))
    series = [
        dataclasses.replace(
            pivot(records, "n", ("metrics", "per_assignment_ms"), None,
                  where={"engine": "ac3", "density": dens})[0],
            label="ac3 (sequential)"),
        dataclasses.replace(
            pivot(records, "n", ("metrics", "per_assignment_ms"), None,
                  where={"engine": "einsum", "density": dens})[0],
            label="einsum"),
        dataclasses.replace(
            pivot(records, "n", ("metrics", "batched_per_assignment_ms"), None,
                  where={"engine": "einsum", "density": dens})[0],
            label="einsum, batched"),
    ]
    return line_chart(
        series,
        title="Per-assignment enforcement time vs n (densest column)",
        subtitle=(f"random_binary at density={_fmtv(dens)}; batched = "
                  "enforce_batch amortized over simultaneous assignments "
                  f"({_host(records)} — the GPU gap is the paper's headline)"),
        xlabel="variables n",
        ylabel="ms per assignment (log)",
        yscale="log",
    )


def _verdict_time(records: Records, spec: SweepSpec) -> Tuple[str, str]:
    dens = max(_vals(records, "density"))
    ns = _vals(records, "n")

    def t(engine: str, n: Any) -> float:
        for r in records:
            if (r["params"]["engine"] == engine and r["params"]["n"] == n
                    and r["params"]["density"] == dens):
                return r["metrics"]["per_assignment_ms"]
        raise KeyError((engine, n))

    ein_g = t("einsum", ns[-1]) / max(t("einsum", ns[0]), 1e-9)
    ac3_g = t("ac3", ns[-1]) / max(t("ac3", ns[0]), 1e-9)
    ok = ein_g < ac3_g
    detail = (
        f"n={ns[0]}→{ns[-1]} at density={_fmtv(dens)}: einsum per-assignment "
        f"time grows {ein_g:.2f}× vs {ac3_g:.2f}× for AC3 (scale-free ratio; "
        f"absolute {_host(records).replace(' host', '-host')} times in the figure)"
    )
    return ("PASS" if ok else "DEVIATES", detail)


# --- claim 3: Model RB phase transition at hardness 1 -----------------------


def _fig_solve_rate(records: Records, spec: SweepSpec) -> str:
    series = pivot(records, "hardness", ("metrics", "solve_rate"), "n",
                   series_fmt="n={v}")
    return line_chart(
        series,
        title="Model RB solve rate through the Xu–Li phase transition",
        subtitle=("tightness p = hardness · p_cr; instances a.a.s. SAT left "
                  "of hardness 1.0, UNSAT right of it"),
        xlabel="hardness (p / p_cr)",
        ylabel="solved fraction",
        xticks=sorted({r["params"]["hardness"] for r in records}),
    )


def _verdict_phase(records: Records, spec: SweepSpec) -> Tuple[str, str]:
    bad = []
    for r in records:
        h, sr = r["params"]["hardness"], r["metrics"]["solve_rate"]
        if h <= 0.7 and sr < 0.9:
            bad.append((h, sr))
        if h >= 1.3 and sr > 0.1:
            bad.append((h, sr))
    lo = max((r["metrics"]["solve_rate"] for r in records
              if r["params"]["hardness"] >= 1.3), default=0.0)
    hi = min((r["metrics"]["solve_rate"] for r in records
              if r["params"]["hardness"] <= 0.7), default=1.0)
    detail = (
        f"solve rate ≥ {hi:.2f} at hardness ≤ 0.7 and ≤ {lo:.2f} at "
        f"hardness ≥ 1.3 across every n (verdicts are seeded-deterministic)"
    )
    return ("PASS" if not bad else "DEVIATES", detail)


# --- claim 4: search effort peaks at the transition -------------------------


def _fig_phase_latency(records: Records, spec: SweepSpec) -> str:
    series = pivot(records, "hardness", ("metrics", "median_latency_ms"), "n",
                   series_fmt="n={v}")
    return line_chart(
        series,
        title="Median solve latency through the phase transition",
        subtitle=("per-instance enforcement seconds attributed by solve_many "
                  "round accounting; medians over the cell's replicates"),
        xlabel="hardness (p / p_cr)",
        ylabel="median solve latency, ms (log)",
        yscale="log",
        xticks=sorted({r["params"]["hardness"] for r in records}),
    )


def _fig_phase_effort(records: Records, spec: SweepSpec) -> str:
    series = pivot(records, "hardness", ("metrics", "median_assignments"), "n",
                   series_fmt="n={v}")
    return line_chart(
        series,
        title="Search effort through the phase transition",
        subtitle="median MAC assignments to a verdict, per instance",
        xlabel="hardness (p / p_cr)",
        ylabel="median #assignments",
        xticks=sorted({r["params"]["hardness"] for r in records}),
    )


def _verdict_effort(records: Records, spec: SweepSpec) -> Tuple[str, str]:
    ns = _vals(records, "n")
    n_top = ns[-1]
    cells = sorted(
        (r["params"]["hardness"], r["metrics"]["median_assignments"])
        for r in records if r["params"]["n"] == n_top
    )
    peak_h, peak_v = max(cells, key=lambda kv: kv[1])
    ok = 0.8 <= peak_h <= 1.25
    detail = (
        f"median assignments at n={n_top} peaks at hardness={_fmtv(peak_h)} "
        f"({peak_v:.0f} assignments) — "
        + ("inside" if ok else "outside") + " the transition window [0.8, 1.25]"
    )
    return ("PASS" if ok else "DEVIATES", detail)


# --- claim 5: service capacity ramp -----------------------------------------


def _fig_capacity(records: Records, spec: SweepSpec) -> str:
    series = pivot(records, "rate", ("metrics", "p95_ms"), None)
    series[0] = dataclasses.replace(series[0], label="p95 latency")
    slo = records[0]["metrics"].get("slo_p95_ms")
    return line_chart(
        series,
        title="Service capacity ramp: offered rate vs p95 latency",
        subtitle=(f"{'+'.join(spec.service.get('families', []))} Poisson "
                  "arrivals replayed to completion per cell "
                  "(FastForwardClock; queueing delay is real compute)"),
        xlabel="offered rate, requests/s",
        ylabel="p95 latency, ms (log)",
        yscale="log",
        refline=(slo, f"SLO {_fmtv(slo)} ms") if slo else None,
        xticks=sorted({r["params"]["rate"] for r in records}),
    )


def _verdict_capacity(records: Records, spec: SweepSpec) -> Tuple[str, str]:
    cells = sorted((r["params"]["rate"], r["metrics"]) for r in records)
    slo = cells[0][1].get("slo_p95_ms")
    if slo is None:
        return ("DEVIATES", "no slo_p95_ms in the sweep spec")
    ok_rates = [rate for rate, m in cells if m["p95_ms"] <= slo]
    breach = [rate for rate, m in cells if m["p95_ms"] > slo]
    ok = bool(ok_rates) and bool(breach) and min(breach) > max(ok_rates)
    detail = (
        f"p95 holds the {_fmtv(slo)} ms SLO up to "
        f"{_fmtv(max(ok_rates)) if ok_rates else '—'} req/s offered and "
        f"breaches from {_fmtv(min(breach)) if breach else '—'} req/s — "
        f"a finite measured capacity on this host"
    )
    return ("PASS" if ok else "DEVIATES", detail)


# --- claim 6: cache pool ramp ------------------------------------------------


def _fig_cache_pool(records: Records, spec: SweepSpec) -> str:
    series = pivot(records, "pool_size", ("metrics", "cache_hit_rate"), None)
    series[0] = dataclasses.replace(series[0], label="cache hit rate")
    return line_chart(
        series,
        title="Prepared-network cache: instance-pool size vs hit rate",
        subtitle=("dedup trace: arrivals draw instances from a pool of K "
                  "seeds per variant; hits skip prepare entirely"),
        xlabel="distinct instances per variant (pool size K)",
        ylabel="prepared-network cache hit rate",
        xticks=sorted({r["params"]["pool_size"] for r in records}),
    )


def _verdict_cache(records: Records, spec: SweepSpec) -> Tuple[str, str]:
    cells = sorted(
        (r["params"]["pool_size"], r["metrics"]["cache_hit_rate"])
        for r in records
    )
    monotone = all(b[1] <= a[1] + 0.02 for a, b in zip(cells, cells[1:]))
    ok = monotone and cells[0][1] >= 0.5
    detail = (
        f"hit rate falls {cells[0][1]:.2f} → {cells[-1][1]:.2f} as the pool "
        f"grows {cells[0][0]} → {cells[-1][0]} (deterministic: hits depend "
        f"only on the seeded arrival sequence and the byte budget)"
    )
    return ("PASS" if ok else "DEVIATES", detail)


CLAIMS: Tuple[Claim, ...] = (
    Claim(
        key="recurrence-count",
        sweep="recurrence_density",
        title="The number of recurrence iterations is quite small",
        paper=(
            "“In each iteration of the recurrence, all involved processes can "
            "be fully parallelized with tensor operations. And the number of "
            "iterations is quite small.” Per-assignment #Recurrence should sit "
            "in the low single digits and stay ~flat as n and density grow — "
            "while AC3's #Revision grows with n·density (paper Table 1; "
            "Berkholz arXiv 1406.4679 frames the propagation-depth bound)."
        ),
        figures=(
            Figure("recurrences_vs_density.svg", _fig_recurrences,
                   "Mean #Recurrence per enforced assignment vs density, one "
                   "curve per n."),
            Figure("work_growth_indexed.svg", _fig_work_growth,
                   "Growth of per-assignment work with n at the densest "
                   "column, each unit indexed to its smallest-n value."),
        ),
        verdict=_verdict_recurrences,
        notes=(
            "Protocol: AC-close the root, sample assignments uniformly over "
            "surviving values, enforce each against the prepared network "
            "(`repro_torch.sweeps.runner` assignments mode, the port of "
            "`repro.sweeps.runner`'s). Counts come from "
            "`EnforceResult.n_recurrences`; AC3's unit is revise calls "
            "(`src/repro_torch/engines/ac3.py`, `count_unit = \"revisions\"`)."
        ),
    ),
    Claim(
        key="per-assignment-time",
        sweep="recurrence_density",
        title="Tensor enforcement time stays ~flat where AC3's grows",
        paper=(
            "“…the resulting algorithm fully leverages the power of "
            "parallelization and GPU, and therefore is extremely efficient on "
            "large and densely connected constraint networks.” (paper Fig. 3: "
            "per-assignment RTAC time ~flat in n·density, AC3 growing; the "
            "claim under test is the growth *ratio*, which holds across "
            "hosts; the figure gives the recording device's absolute times.)"
        ),
        figures=(
            Figure("per_assignment_ms.svg", _fig_time_vs_n,
                   "Per-assignment enforcement wall time vs n at the densest "
                   "grid column, plus the batched enforce_batch variant."),
        ),
        verdict=_verdict_time,
        notes=(
            "The batched curve amortizes ONE batched fixpoint over all "
            "sampled assignments (`PreparedNetwork.enforce_batch`; on the "
            "Hopper engines one single-network revise launch a recurrence) — "
            "the beyond-paper lever the engines expose (DESIGN.md §3)."
        ),
    ),
    Claim(
        key="phase-transition",
        sweep="model_rb_phase",
        title="Model RB crosses SAT→UNSAT at the predicted threshold",
        paper=(
            "The evaluation workload (Xu–Li Model RB) has *proven* exact "
            "phase transitions: instances are a.a.s. satisfiable below "
            "p_cr = 1 − e^(−α/r) and unsatisfiable above it, with the hard "
            "region hugging the threshold (`model_rb` positions tightness as "
            "hardness · p_cr)."
        ),
        figures=(
            Figure("model_rb_solve_rate.svg", _fig_solve_rate,
                   "Solved fraction per cell vs hardness, one curve per n."),
        ),
        verdict=_verdict_phase,
        notes=(
            "Generator: `repro_torch.problems.model_rb` (knobs documented on "
            "the function: d = ⌈n^α⌉, m = ⌈r·n·ln n⌉ distinct scopes, exactly "
            "round(p·d²) disallowed tuples). Solved through "
            "`repro_torch.core.solve_many` lockstep — verdicts bit-identical "
            "to sequential `mac_solve`."
        ),
    ),
    Claim(
        key="hardness-effort",
        sweep="model_rb_phase",
        title="Search effort and latency peak at the transition",
        paper=(
            "Hardness-parameterized reporting (Tardivo arXiv 1909.09213): "
            "solve cost should *peak* where instances straddle the threshold, "
            "not grow monotonically with tightness — easy-SAT below, "
            "quickly-refuted UNSAT above."
        ),
        figures=(
            Figure("model_rb_effort.svg", _fig_phase_effort,
                   "Median MAC assignments per instance vs hardness."),
            Figure("model_rb_latency.svg", _fig_phase_latency,
                   "Median per-instance solve latency vs hardness (log y)."),
        ),
        verdict=_verdict_effort,
        notes=(
            "Latency is per-instance enforcement seconds attributed by "
            "`solve_many`'s round accounting (attributions sum exactly to "
            "round wall-clock, DESIGN.md §8); assignment counts are "
            "seeded-deterministic, so the verdict never flips with host speed."
        ),
    ),
    Claim(
        key="service-capacity",
        sweep="service_capacity",
        title="The solver service has a measurable capacity knee",
        paper=(
            "Not a claim of the paper — the serving-scale corollary of its "
            "“large and densely connected networks” pitch (ROADMAP north "
            "star): offered load vs p95 must show a finite knee, found by "
            "ramping seeded Poisson traces until the SLO breaks."
        ),
        figures=(
            Figure("service_capacity.svg", _fig_capacity,
                   "Offered rate vs p95 latency with the SLO threshold."),
        ),
        verdict=_verdict_capacity,
        notes=(
            "Driver: `repro_torch.service.replay_rate_cell` — one fresh "
            "`SolverService` per cell, same seeded arrival pattern at every "
            "rate (`SolverService.submit` knobs documented on the method; "
            "continuous batching per DESIGN.md §7). Absolute capacity is "
            "host-dependent; the figure records the device the cells name."
        ),
    ),
    Claim(
        key="cache-pool",
        sweep="cache_pool",
        title="Prepared-network cache hit-rate tracks instance recurrence",
        paper=(
            "Serving corollary: real traffic repeats instances, and the "
            "byte-budgeted prepared-network LRU should convert recurrence "
            "into hits — hit-rate falling as the distinct-instance pool "
            "grows (the dedup traces make the hits real)."
        ),
        figures=(
            Figure("cache_pool_hit_rate.svg", _fig_cache_pool,
                   "Dedup-trace pool size vs measured cache hit rate."),
        ),
        verdict=_verdict_cache,
        notes=(
            "Trace: `repro_torch.service.dedup_trace` (pool of K seeds per "
            "variant). Hits/misses come from the obs registry's "
            "`cache.hits`/`cache.misses` counters, scoped per cell via "
            "`Registry.scope` — inspect any run with the `repro_torch.obs` "
            "CLI (`python -m repro_torch.obs summarize <run.json>`)."
        ),
    ),
)


# --------------------------------------------------------------------------
# report generation
# --------------------------------------------------------------------------


def _fmtv(v: Any) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def collect(out_root: Optional[Path] = None) -> Dict[str, Tuple[SweepSpec, Records]]:
    """Load (spec, records) for every sweep the claims read. A missing or
    empty artifact directory is an error naming the command that produces it."""
    out_root = Path(out_root or DEFAULT_OUT_ROOT)
    loaded: Dict[str, Tuple[SweepSpec, Records]] = {}
    for claim in CLAIMS:
        if claim.sweep in loaded:
            continue
        spec = load_spec(claim.sweep)
        path = sweep_dir(spec, out_root) / "cells.jsonl"
        if not path.exists():
            raise FileNotFoundError(
                f"no artifacts for sweep {claim.sweep!r} at {path}; run "
                f"`python -m repro_torch.sweeps run {claim.sweep}` first"
            )
        records = load_cells(path)
        missing = len(spec.cells()) - len(records)
        if missing > 0:
            raise RuntimeError(
                f"sweep {claim.sweep!r} has {missing} unrecorded cells; "
                f"resume it with `python -m repro_torch.sweeps run {claim.sweep}`"
            )
        loaded[claim.sweep] = (spec, records)
    return loaded


def render_figures(
    loaded: Dict[str, Tuple[SweepSpec, Records]],
    fig_dir: Path,
    only_claim: Optional[str] = None,
) -> List[Path]:
    fig_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for claim in CLAIMS:
        if only_claim and claim.key != only_claim:
            continue
        spec, records = loaded[claim.sweep]
        for fig in claim.figures:
            p = fig_dir / fig.filename
            p.write_text(fig.build(records, spec))
            written.append(p)
    return written


def claim_section(claim: Claim, spec: SweepSpec, records: Records,
                  index: int, fig_rel: str) -> str:
    """One RESULTS.md section: title, paper claim, verdict, figures, spec."""
    verdict, detail = claim.verdict(records, spec)
    lines = [
        f"## {index}. {claim.title}",
        "",
        f"**Paper claim.** {claim.paper}",
        "",
        f"**Verdict: {verdict}** — {detail}.",
        "",
    ]
    for fig in claim.figures:
        lines += [
            f"![{fig.caption}]({fig_rel}/{fig.filename})",
            "",
            f"*{fig.caption}*",
            "",
        ]
    if claim.notes:
        lines += [claim.notes, ""]
    lines += [
        "<details>",
        f"<summary>Sweep spec <code>src/repro_torch/sweeps/specs/{claim.sweep}"
        ".toml</code> (click to expand)</summary>",
        "",
        "```toml",
        spec.to_toml().rstrip(),
        "```",
        "",
        "</details>",
        "",
    ]
    return "\n".join(lines)


def build_results_md(
    loaded: Dict[str, Tuple[SweepSpec, Records]],
    fig_rel: str = FIG_DIR_NAME,
    spec_rel: str = "../src/repro_torch/sweeps/specs",
) -> str:
    """The report: a summary table, then one section per claim. ``fig_rel``
    and ``spec_rel`` are the figure and spec directories relative to the
    report file."""
    hosts = sorted({_host(records) for _, records in loaded.values()})
    head = [
        "# RESULTS — paper claims, measured on the PyTorch/CUDA port",
        "",
        "<!-- GENERATED FILE — edit specs/claims, then regenerate with:",
        "       python -m repro_torch.sweeps run --all && python -m repro_torch.sweeps report",
        "     `python -m repro_torch.sweeps report --check` fails if this file",
        "     drifts from its artifacts. -->",
        "",
        "Each section tests one claim of *Paralleling and Accelerating Arc",
        "Consistency Enforcement with Recurrent Tensor Computations* (or a",
        "serving-scale corollary) against the PyTorch/CUDA port, using its",
        "sweep harness in `src/repro_torch/sweeps/` (the port of",
        "`src/repro/sweeps/`). Figures are rendered from the JSONL artifacts",
        "beside this file and regenerate byte-identically; verdicts key on",
        "seeded-deterministic quantities or scale-free ratios, so they hold",
        f"across hosts. Absolute milliseconds were measured on: {', '.join(hosts)}.",
        "",
        "| # | claim | sweep | verdict |",
        "|---|-------|-------|---------|",
    ]
    sections = []
    for i, claim in enumerate(CLAIMS, 1):
        spec, records = loaded[claim.sweep]
        verdict, _ = claim.verdict(records, spec)
        head.append(
            f"| {i} | [{claim.title}](#{i}-{_slug(claim.title)}) | "
            f"[`{claim.sweep}`]({spec_rel}/{claim.sweep}.toml) | "
            f"{verdict} |"
        )
        sections.append(claim_section(claim, spec, records, i, fig_rel))
    head.append("")
    return "\n".join(head) + "\n" + "\n".join(sections)


def _slug(title: str) -> str:
    keep = [c.lower() if c.isalnum() else ("-" if c in " -" else "")
            for c in title]
    return "".join(keep).replace("--", "-").strip("-")


def _relative(path: Path, start: Path) -> str:
    return Path(os.path.relpath(path.resolve(), start.resolve())).as_posix()


def _results_md(loaded, results_md: Path, fig_dir: Path) -> str:
    return build_results_md(loaded, fig_rel=_relative(fig_dir, results_md.parent),
                            spec_rel=_relative(SPEC_DIR, results_md.parent))


def build_report(
    out_root: Optional[Path] = None,
    results_md: Optional[Path] = None,
    fig_dir: Optional[Path] = None,
) -> List[Path]:
    """Render every figure + RESULTS.md from the artifacts under
    ``out_root`` (default `DEFAULT_OUT_ROOT`), into ``out_root`` unless told
    otherwise. Returns the written paths."""
    out_root = Path(out_root or DEFAULT_OUT_ROOT)
    results_md = Path(results_md or out_root / RESULTS_MD_NAME)
    fig_dir = Path(fig_dir or out_root / FIG_DIR_NAME)
    loaded = collect(out_root)
    written = render_figures(loaded, fig_dir)
    results_md.write_text(_results_md(loaded, results_md, fig_dir))
    return [results_md] + written


def check_report(out_root: Optional[Path] = None) -> List[str]:
    """The doc-rot gate: regenerate RESULTS.md + every figure from the
    artifacts under ``out_root`` IN MEMORY and diff against the files there.
    Returns a list of human-readable drift messages (empty = clean)."""
    out_root = Path(out_root or DEFAULT_OUT_ROOT)
    fig_dir = out_root / FIG_DIR_NAME
    results_md = out_root / RESULTS_MD_NAME
    loaded = collect(out_root)
    drift: List[str] = []
    for claim in CLAIMS:
        spec, records = loaded[claim.sweep]
        for fig in claim.figures:
            p = fig_dir / fig.filename
            fresh = fig.build(records, spec)
            if not p.exists():
                drift.append(f"missing figure {p}")
            elif p.read_text() != fresh:
                drift.append(f"figure drifts from artifacts: {p}")
    fresh_md = _results_md(loaded, results_md, fig_dir)
    if not results_md.exists():
        drift.append(f"missing {results_md}")
    elif results_md.read_text() != fresh_md:
        diff = "\n".join(
            difflib.unified_diff(
                results_md.read_text().splitlines(),
                fresh_md.splitlines(),
                "RESULTS.md (on disk)", "RESULTS.md (regenerated)",
                lineterm="", n=1,
            )
        )
        drift.append(f"RESULTS.md drifts from artifacts:\n{diff}")
    return drift
