"""Deterministic SVG line charts for sweep figures — no plotting deps.

The port's own copy of `repro.sweeps.figures` (pure Python, byte for byte
the same output). Report figures are regenerated byte-identically from the
JSONL artifacts (`report.check_report` diffs them), so the renderer is deliberately dependency-free and stable: fixed float formatting,
no timestamps, no randomized ids — the SVG text is a pure function of the
data. Styling follows the repo-neutral data-viz conventions: a validated
categorical palette assigned in fixed slot order (never cycled), 2px series
lines with surface-ringed markers, recessive hairline grid, a legend for ≥ 2
series plus direct end-of-line labels, one y-axis per chart (never dual), and
a reserved status color for SLO reference lines only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

# categorical palette (light mode), validated for adjacent-pair CVD
# separation; slots are assigned to series in fixed order, never cycled
PALETTE = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100")
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
MUTED = "#898781"
GRID = "#e1e0d9"
BASELINE = "#c3c2b7"
BORDER = "#e1e0d9"
#: status color, reserved for thresholds (SLO lines) — never a series
CRITICAL = "#d03b3b"

FONT = 'font-family="system-ui, -apple-system, Segoe UI, sans-serif"'


@dataclasses.dataclass(frozen=True)
class Series:
    """One line: parallel x/y float lists plus its legend label."""

    label: str
    x: Sequence[float]
    y: Sequence[float]


def _fmt(v: float) -> str:
    """Stable tick/coordinate formatting (no trailing float noise)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def _nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    """~n 'nice' ticks covering [lo, hi] (1/2/5 steps)."""
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n, 1)
    mag = 10 ** math.floor(math.log10(raw))
    for mult in (1, 2, 2.5, 5, 10):
        step = mult * mag
        if raw <= step:
            break
    first = math.ceil(lo / step - 1e-9) * step
    ticks = []
    t = first
    while t <= hi + 1e-9 * step:
        ticks.append(0.0 if abs(t) < 1e-12 else t)
        t += step
    return ticks


def _log_ticks(lo: float, hi: float) -> List[float]:
    ticks = []
    k = math.floor(math.log10(lo))
    while 10**k <= hi * (1 + 1e-9):
        if 10**k >= lo * (1 - 1e-9):
            ticks.append(10.0**k)
        k += 1
    return ticks or [lo, hi]


def _esc(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def line_chart(
    series: List[Series],
    *,
    title: str,
    xlabel: str,
    ylabel: str,
    subtitle: str = "",
    width: int = 760,
    height: int = 420,
    yscale: str = "linear",
    include_zero: bool = True,
    refline: Optional[Tuple[float, str]] = None,
    xticks: Optional[Sequence[float]] = None,
) -> str:
    """Render one SVG line chart (returns the SVG text).

    ``yscale="log"`` switches to a log10 y-axis (decade ticks);
    ``include_zero`` anchors a linear y-axis at 0. ``refline=(value, label)``
    draws a dashed threshold line in the reserved status color.
    """
    if not series:
        raise ValueError("line_chart needs at least one series")
    if len(series) > len(PALETTE):
        raise ValueError(
            f"{len(series)} series > {len(PALETTE)} palette slots; facet or "
            "fold to 'Other' instead of generating hues"
        )
    if yscale not in ("linear", "log"):
        raise ValueError(f"yscale must be linear|log, got {yscale!r}")

    # --- scales -------------------------------------------------------------
    xs = [v for s in series for v in s.x]
    ys = [v for s in series for v in s.y]
    if refline is not None:
        ys = ys + [refline[0]]
    x_lo, x_hi = min(xs), max(xs)
    if x_hi <= x_lo:
        x_hi = x_lo + 1.0
    if yscale == "log":
        pos = [v for v in ys if v > 0]
        y_lo = min(pos) if pos else 0.1
        y_hi = max(pos) if pos else 1.0
        y_lo = 10 ** math.floor(math.log10(y_lo))
        y_hi = 10 ** math.ceil(math.log10(y_hi) - 1e-9)
        if y_hi <= y_lo:
            y_hi = y_lo * 10
        yticks = _log_ticks(y_lo, y_hi)

        def ty(v: float) -> float:
            v = max(v, y_lo)
            return (math.log10(v) - math.log10(y_lo)) / (
                math.log10(y_hi) - math.log10(y_lo)
            )
    else:
        y_lo = 0.0 if include_zero and min(ys) >= 0 else min(ys)
        y_hi = max(ys)
        yticks = _nice_ticks(y_lo, y_hi)
        y_lo, y_hi = min(y_lo, yticks[0]), max(y_hi, yticks[-1])
        if y_hi <= y_lo:
            y_hi = y_lo + 1.0

        def ty(v: float) -> float:
            return (v - y_lo) / (y_hi - y_lo)

    # --- layout -------------------------------------------------------------
    m_left, m_right, m_top, m_bottom = 56, 120, 64, 46
    if subtitle:
        m_top += 16
    pw = width - m_left - m_right  # plot width/height
    ph = height - m_top - m_bottom

    def X(v: float) -> float:
        return m_left + pw * (v - x_lo) / (x_hi - x_lo)

    def Y(v: float) -> float:
        return m_top + ph * (1.0 - ty(v))

    out: List[str] = []
    out.append(
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" role="img" '
        f'aria-label="{_esc(title)}">'
    )
    out.append(
        f'<rect width="{width}" height="{height}" fill="{SURFACE}" '
        f'stroke="{BORDER}" stroke-width="1" rx="6"/>'
    )
    out.append(
        f'<text x="16" y="26" {FONT} font-size="14" font-weight="600" '
        f'fill="{INK}">{_esc(title)}</text>'
    )
    if subtitle:
        out.append(
            f'<text x="16" y="44" {FONT} font-size="11" '
            f'fill="{INK_2}">{_esc(subtitle)}</text>'
        )

    # grid + y ticks (recessive hairlines, labels in muted ink)
    for t in yticks:
        yy = _fmt_pos(Y(t))
        out.append(
            f'<line x1="{m_left}" y1="{yy}" x2="{m_left + pw}" y2="{yy}" '
            f'stroke="{GRID}" stroke-width="1"/>'
        )
        out.append(
            f'<text x="{m_left - 8}" y="{yy}" {FONT} font-size="10" '
            f'fill="{MUTED}" text-anchor="end" dominant-baseline="middle" '
            f'style="font-variant-numeric: tabular-nums">{_fmt(t)}</text>'
        )
    # x ticks
    for t in (xticks if xticks is not None else _nice_ticks(x_lo, x_hi, 6)):
        if t < x_lo - 1e-9 or t > x_hi + 1e-9:
            continue
        xx = _fmt_pos(X(t))
        out.append(
            f'<line x1="{xx}" y1="{m_top + ph}" x2="{xx}" '
            f'y2="{m_top + ph + 4}" stroke="{BASELINE}" stroke-width="1"/>'
        )
        out.append(
            f'<text x="{xx}" y="{m_top + ph + 16}" {FONT} font-size="10" '
            f'fill="{MUTED}" text-anchor="middle" '
            f'style="font-variant-numeric: tabular-nums">{_fmt(t)}</text>'
        )
    # baseline axis
    out.append(
        f'<line x1="{m_left}" y1="{m_top + ph}" x2="{m_left + pw}" '
        f'y2="{m_top + ph}" stroke="{BASELINE}" stroke-width="1"/>'
    )
    # axis titles (secondary ink)
    out.append(
        f'<text x="{m_left + pw / 2:g}" y="{height - 12}" {FONT} '
        f'font-size="11" fill="{INK_2}" text-anchor="middle">'
        f'{_esc(xlabel)}</text>'
    )
    out.append(
        f'<text x="{m_left}" y="{m_top - 10}" {FONT} font-size="11" '
        f'fill="{INK_2}">{_esc(ylabel)}</text>'
    )

    # threshold reference line (reserved status color + explicit label,
    # never color alone)
    if refline is not None:
        rv, rlabel = refline
        yy = _fmt_pos(Y(rv))
        out.append(
            f'<line x1="{m_left}" y1="{yy}" x2="{m_left + pw}" y2="{yy}" '
            f'stroke="{CRITICAL}" stroke-width="1.5" stroke-dasharray="6 4"/>'
        )
        out.append(
            f'<text x="{m_left + pw - 4}" y="{float(yy) - 6:g}" {FONT} '
            f'font-size="10" fill="{CRITICAL}" text-anchor="end">'
            f'{_esc(rlabel)}</text>'
        )

    # series: 2px lines, markers with a 2px surface ring so overlaps read
    for i, s in enumerate(series):
        color = PALETTE[i]
        pts = sorted(zip(s.x, s.y))
        path = " ".join(
            f"{'M' if j == 0 else 'L'} {_fmt_pos(X(px))} {_fmt_pos(Y(py))}"
            for j, (px, py) in enumerate(pts)
        )
        out.append(
            f'<path d="{path}" fill="none" stroke="{color}" '
            f'stroke-width="2" stroke-linejoin="round"/>'
        )
        for px, py in pts:
            out.append(
                f'<circle cx="{_fmt_pos(X(px))}" cy="{_fmt_pos(Y(py))}" '
                f'r="4" fill="{color}" stroke="{SURFACE}" stroke-width="2"/>'
            )

    # direct end-of-line labels, nudged apart (identity never color-alone)
    ends = sorted(
        (Y(sorted(zip(s.x, s.y))[-1][1]), i, s.label)
        for i, s in enumerate(series)
    )
    placed: List[float] = []
    for yy, i, label in ends:
        for p in placed:
            if abs(yy - p) < 13:
                yy = p + 13
        placed.append(yy)
        out.append(
            f'<text x="{m_left + pw + 8}" y="{_fmt_pos(yy)}" {FONT} '
            f'font-size="11" fill="{INK_2}" dominant-baseline="middle">'
            f'<tspan fill="{PALETTE[i]}">●</tspan> {_esc(label)}</text>'
        )

    # legend row (top right) for >= 2 series
    if len(series) >= 2:
        lx = width - 16
        for i in range(len(series) - 1, -1, -1):
            label = _esc(series[i].label)
            lw = 8 + 6 * len(series[i].label) + 14
            lx -= lw
            out.append(
                f'<rect x="{lx}" y="20" width="10" height="10" rx="3" '
                f'fill="{PALETTE[i]}"/>'
            )
            out.append(
                f'<text x="{lx + 14}" y="29" {FONT} font-size="11" '
                f'fill="{INK_2}">{label}</text>'
            )
            lx -= 12
    out.append("</svg>")
    return "\n".join(out) + "\n"


def _fmt_pos(v: float) -> str:
    """Pixel coordinates rounded to 0.01 — stable across float noise."""
    return f"{v:.2f}".rstrip("0").rstrip(".")
