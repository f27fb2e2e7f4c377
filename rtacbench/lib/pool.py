"""Jobs on a few worker processes: the instance draws of set-up and the
check's replays with the plain reference.

Each worker is a fresh interpreter that imports only the job's module (the
frozen generators, or the plain reference and its torch), touches no
device, and runs one thread. Workers take their jobs and return their
results as pickles over pipes (no shared memory, nothing left behind) and
are waited for before the caller goes on.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import List, Sequence

#: worker processes at most (the chip's machine has 8 cores)
WORKERS = 6
_WORKER = ("import importlib, pickle, sys\n"
           "mod, _, name = sys.argv[1].partition(':')\n"
           "fn = getattr(importlib.import_module(mod), name)\n"
           "jobs = pickle.load(sys.stdin.buffer)\n"
           "pickle.dump([fn(j) for j in jobs], sys.stdout.buffer)\n")
_ROOT = str(Path(__file__).resolve().parents[2])
_ONE_THREAD = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def workers() -> int:
    return min(WORKERS, max(1, (os.cpu_count() or 2) - 2))


def run(fn: str, jobs: Sequence, serial_below: int) -> List:
    """``fn(job)`` of every job, in order; ``fn`` is ``"module:function"``.
    Below ``serial_below`` jobs, or with one worker, they run here."""
    count = workers()
    if len(jobs) < serial_below or count <= 1:
        mod, _, name = fn.partition(":")
        __import__(mod)
        call = getattr(sys.modules[mod], name)
        return [call(j) for j in jobs]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.update((var, "1") for var in _ONE_THREAD)
    shares = [list(jobs[w::count]) for w in range(count)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, fn], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, env=env) for _ in shares]
    try:
        for proc, share in zip(procs, shares):
            proc.stdin.write(pickle.dumps(share))
            proc.stdin.close()
        # the workers' own pickles, written just now
        outs = [pickle.load(proc.stdout) for proc in procs]
    finally:
        for proc in procs:
            proc.stdout.close()
            if proc.wait():
                raise RuntimeError(f"a worker of {fn} exited {proc.returncode}")
    results: List = [None] * len(jobs)
    for w, out in enumerate(outs):
        results[w::count] = out
    return results
