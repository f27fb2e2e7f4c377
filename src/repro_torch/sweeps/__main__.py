"""CLI for the port's sweep harness: ``python -m repro_torch.sweeps <command>``.

Commands:

    list                     committed study specs (name, mode, grid size)
    run <spec>... [--all]    execute specs on --device (default cuda;
                             resumable; --fresh discards stale artifacts,
                             --out redirects the root, default results_torch/)
    report [--check]         regenerate RESULTS.md + figures/ under --out
                             from its artifacts (no device work, so no
                             --device); --check diffs instead of writing
                             and exits 1 on drift

``<spec>`` is a committed name (``model_rb_phase``) or a path to any
``.toml`` spec file. The full study refresh on the card is::

    python -m repro_torch.sweeps run --all && python -m repro_torch.sweeps report
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .report import build_report, check_report
from .runner import run_spec
from .spec import available_specs, load_spec


def _cmd_list(args: argparse.Namespace) -> int:
    names = available_specs()
    if not names:
        print("no committed specs")
        return 0
    rows = []
    for name in names:
        spec = load_spec(name)
        rows.append((name, spec.mode, len(spec.cells()), spec.title))
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    for name, mode, n, title in rows:
        print(f"{name:<{w0}}  {mode:<{w1}}  {n:>3} cells  {title}")
    return 0


def _cmd_run(args: argparse.Namespace) -> int:
    names = available_specs() if args.all else args.spec
    if not names:
        print("nothing to run: name specs or pass --all", file=sys.stderr)
        return 2
    for name in names:
        spec = load_spec(name)
        run_spec(spec, out_root=args.out, fresh=args.fresh, device=args.device)
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    if args.check:
        drift = check_report(out_root=args.out)
        if drift:
            for msg in drift:
                print(f"DRIFT: {msg}", file=sys.stderr)
            print(
                f"{len(drift)} drifting file(s); regenerate with "
                "`python -m repro_torch.sweeps report`",
                file=sys.stderr,
            )
            return 1
        print("report is in sync with the artifacts")
        return 0
    for p in build_report(out_root=args.out):
        print(f"wrote {p}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweeps",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("list", help="committed study specs").set_defaults(
        fn=_cmd_list)

    p_run = sub.add_parser("run", help="execute sweep specs (resumable)")
    p_run.add_argument("spec", nargs="*",
                       help="spec names or .toml paths")
    p_run.add_argument("--all", action="store_true",
                       help="run every committed spec")
    p_run.add_argument("--fresh", action="store_true",
                       help="discard existing artifacts for these specs")
    p_run.add_argument("--out", type=Path, default=None,
                       help="artifact root (default: repo results_torch/)")
    p_run.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    p_run.set_defaults(fn=_cmd_run)

    p_rep = sub.add_parser(
        "report", help="regenerate RESULTS.md + figures from artifacts")
    p_rep.add_argument("--check", action="store_true",
                       help="diff instead of writing; exit 1 on drift")
    p_rep.add_argument("--out", type=Path, default=None,
                       help="artifact root (default: repo results_torch/)")
    p_rep.set_defaults(fn=_cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
