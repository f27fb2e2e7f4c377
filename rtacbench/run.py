"""Run one cell of the port's benchmark once.

    python3 rtacbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its inputs from ``--seed``, sets
up and warms the port (``src/repro_torch``), measures for ``--seconds``,
checks the window's answers against the plain reference
(``rtacbench/reference``), and prints one JSON object as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a traced slice of the window. The
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result. It needs a CUDA card, and exits
non-zero with no result without one, or when JAX or the JAX package
(``repro``) was loaded.

``--program control`` puts the control (the reference with one guarantee
broken, `lib.control`) in the program's place, and ``--override
part.key=JSON`` replaces a key of the cell's workload or configuration:
both serve the measurements that set the limits and the service's rate,
never the benchmark's own runs.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: build and kernel caches the port and PyTorch may write, at fixed paths
#: inside the checkout
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "cuda",
}
#: the port's switches that would change what is measured
UNSET = ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_CACHE", "REPRO_TORCH_FIXPOINT",
         "REPRO_TORCH_TRACE", "REPRO_TORCH_FAULTS")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this file ran."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if age >= time.perf_counter() - T_START:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - T_START


def prepare_environment() -> None:
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(ROOT, ".rtacbench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    for var in UNSET:
        os.environ.pop(var, None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def parse(argv):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program", choices=("port", "control"), default="port")
    ap.add_argument("--override", action="append", default=[], metavar="PART.KEY=JSON")
    args = ap.parse_args(argv)
    overrides = {"workload": {}, "config": {}}
    for item in args.override:
        key, _, value = item.partition("=")
        part, _, name = key.partition(".")
        if part not in overrides or not name:
            ap.error(f"--override {item!r}: expected workload.KEY=JSON or config.KEY=JSON")
        overrides[part][name] = json.loads(value)
    args.overrides = overrides
    return args


def main(argv=None) -> int:
    prepare_environment()
    args = parse(sys.argv[1:] if argv is None else argv)
    import json

    import torch

    from rtacbench.lib import harness, spec

    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtacbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter() - process_age_s()
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start, device="cuda", overrides=args.overrides,
                              program=args.program)
    if result is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
