#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OTHER_TREE/src/repro_torch/kernels/csrc
    python3 chip_smoke.py --split

``--split`` builds kernel 1 alone and times it with each row on 1, 2, 4
and 8 CTAs of a thread-block cluster (`split_sweep`), every launch bit for
bit its plain version, then stops. Phases (any failure exits non-zero):

(a) build   — compile every kernel source (`kernels/csrc/*.cu`) for sm_90a,
              all nvcc processes at once; print the seconds, ptxas' register
              and spill report, and the card's name and power limit.
(b) kernels — hold each kernel against its plain PyTorch version, bit for bit,
              on the card. The stacked kernels (packed and dense fixpoint and
              revise) run at the main path's shape (n_p=104, d_p=40, W=2;
              1,024 rows over 32 tables of model_rb n=100 networks) and at
              one W=1 dense-mask shape (random_binary n=160, d=10, density
              1.0); the single-network revise kernels (packed and dense) at
              the main shape on one network with 64 one-hot child domains,
              and on the calls `mac_solve` really makes on a stepped engine
              (a fused one launches kernel 1 or 4 below n = 2048): every call
              of one phase-e solve (instance 1) is recorded by wrapping the wrapper,
              then replayed back to back, kernel and plain, printed with its
              B histogram, beside the launch floor (an empty launch) and the
              solve's root calls alone. Time kernel and plain version with
              CUDA events and compute the least time the card could take
              (bound).
              The stacked kernels run on three row mixes (all one-hot, the
              main path's 7 one-hot : 1 root, all root), each checked and
              timed; the stacked revises also on a "late" mix (the 7:1 rows
              with the third sweep's seeds of the plain fixpoint: converged
              rows frozen, their seeds zero). Per kind, the stepped fixpoint
              (`ops.enforce_rows`, one revise launch a sweep) is timed beside
              the fused kernel on the 7:1 rows, with identical results.
              The word loop's epilogue kernel (csrc/word_epilogue.cu) is
              held against its plain version at `mac_solve`'s rows of QWH
              order 40 (B = 1, 2 of n_p = 1,600, d_p = 40), at 512 rows of
              the production CSP's shape and at the main shape, and timed.
(c) main path — `solve_many` on 32 model_rb instances (seeds 0-31, n=100,
              alpha=0.8, r=0.7, hardness=0.9, so d=40) with ``max_assignments``
              per instance, on `hopper_packed` fused, then stepped: identical
              solutions and search statistics, every solution checked, the
              fused kernel launched once per round.
(c2) dense  — the same workload on `hopper_dense` fused, then stepped:
              identical to each other and to (c), the dense fused kernel
              launched once per round, the stepped path only the dense revise.
(d) parity  — the same workload at n=30 on `einsum` and on `hopper_packed`.
(e) mac_solve — a few instances of the (c) shape solved one at a time on
              `hopper_packed` and `hopper_dense`, each fused (the fused
              kernel once a round) and stepped (the single-network revise
              once a recurrence), and on `einsum`: identical solutions and
              statistics, ms per round.
(s) service — `SolverService` on the card, three parts. (1) A seeded
              Poisson trace (8/s over 3 s) of frb100-40-shaped model_rb
              (bucket 128x64), sudoku with 32 givens (128x16) and 64-queens
              (64x64), each request capped at ``max_assignments``, replayed
              on `hopper_packed` and on `hopper_dense` (fused) through a
              fast-forward clock: every request held against `solve_many`
              on the same engine (one call a shape) and the two engines
              against each other; throughput, latency percentiles, rounds,
              rows a dispatch, slots a bucket and the fused kernel's
              launches (one a round), with no host routing. (2) The
              demotion drill: one injected kernel fault with no retries at
              the trace's default sizes, so the stepped rung runs the
              stacked revise on the service's slot table; verdicts equal
              the fault-free replay. In (1) and (2) the calls numbered 1, 4,
              16 and 64 of each stacked kernel at each table shape are
              recorded (operands copied) and each held bit for bit against
              its plain version on the card. (3) The chaos drill: `serve` with every
              fault site at 5 % on `hopper_packed`, traced; every future
              resolves, every DONE verdict equals the fault-free run's, and
              the span and counter names are the fault-free run's plus
              recovery names only.
(t) autotune — `repro_torch.kernels.autotune` on the card, its cache under
              artifacts/chip_smoke/: one run each of phase c's `solve_many`
              (both Hopper engines, fused) and of phase e's `mac_solve`
              (instance 1) with ``REPRO_TORCH_AUTOTUNE=1``, so every bucket
              they dispatch (round widths at n_p=104 d_p=40; B = 1-64 of
              `mac_solve`'s fused calls) is tuned on first dispatch, then the
              service bucket 128x64; every candidate's µs a launch and the
              winner, each candidate held bit for bit against the plain
              version on its tuning workload; then each run untuned and
              tuned in turns (untuned, tuned, tuned, untuned): identical
              solutions, search statistics and kernel counts, ms per round.
(w) sweeps  — `repro_torch.sweeps.run_spec` on the card into
              artifacts/chip_smoke/sweeps/: `smoke` on einsum and both
              Hopper engines; `recurrence_density` cut to n 40 and 160 and
              density 0.25 and 1.0 on einsum, ac3 and both Hopper engines
              (calls 1, 4, 16 and 64 of each fused fixpoint kernel at each
              shape, the single-network path's route there, held bit for
              bit against the plain version); one
              `service_capacity` cell on `hopper_packed` at rates 4 and 16
              over 2 s. The seeded columns are identical across the tensor
              engines; prints per-assignment ms and counts per engine and
              the report's verdicts over these records.
(x) sharded — the sharded path (`repro_torch.core.sharded`, the
              ``sharded`` engine) on the card. (x1) In a one-rank NCCL world,
              `ShardedEngine(impl="bitpacked")` on the reference's production
              CSP, n=4096, d=32 (a 2 GiB packed network; a seeded model-A
              network built on the card, `hashed_random_csp`), B=32
              search-node domains (the single-pod mesh's batch a data shard,
              512/16): dom, consistent and k bit for bit against the same
              fixpoint on `packed_revise_block_plain`; calls 1, 2 and 4 of
              the packed block revise (csrc/block_revise.cuh, the network in
              the reference's pair-major layout) against plain; the k
              histogram, ms a recurrence, the all-gather record, and one run
              under `torch.profiler` (device busy share, each kernel's share
              of the wall time). (x2) At n=1024, B=8 the bitpacked, u8 (the
              dense block revise) and bf16 einsum variants agree; the dense
              block revise's calls against plain. (x3) Two processes on the
              one card in a gloo world (`repro_torch.launch.distributed_ac`,
              512 variables a rank, the gather staged through host memory)
              equal x2's one-rank bitpacked run. (x4) The packed block call
              on one rank's share of the production mesh (256 of 4096
              variables, B_local 32 and 16), timed with CUDA events beside
              its bound. (x5) x1's call 1 with its rows cut to B = 1, 4, 8,
              16, 32 and x2's dense call 1 to B = 1, 2, 4, 8, the network
              the same: how the time grows with the rows. At x1, x4 and x2
              the library call, the bf16 einsum local revise on the same
              rows, is held against the kernel and timed. (x6) The entry
              point `repro_torch.launch.distributed_ac` as a one-rank NCCL
              world at x1's network and the full batch, B=512, bitpacked:
              dom, consistent and k against the single-network
              `hopper_packed` engine (kernel 3 at n=4096), the first block
              call against plain, ms a recurrence, the local revise and each
              recurrence's all-gather (CUDA events), one profiled call; the
              kernels line's packed block row carries its launches
              (``full_batch_launches``). Then `hopper_packed` and
              `hopper_dense` on the same network and batch in this process,
              each wrapper's launches counted from 0: each result equals
              x6's, each first `packed_revise` / `dense_revise` call
              (kernels 3 and 6 at n=4096: the block revise's kernel on the
              value-major network) is held against plain and against the
              block revise on the network permuted pair-major (3b, 6b at
              nx = n), timed beside its bound and the block revise, then cut
              to B = 1, 5, 64; kernels 3 and 6's rows carry them
              (``full_batch_*``), and the dense prepare's peak memory is
              printed.
(p) profile — one fused and one stepped `solve_many`, one phase-e
              `mac_solve` (instance 1) and the phase-s replay on each Hopper
              engine under `torch.profiler`: device busy share (the union
              of the device's kernel and copy intervals) and the kernels
              that take the device's time, each with its share of the wall
              time.

Prints a ``{"kernels": [...]}`` JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits 2
without printing a result when no CUDA device is present or when run outside
a checkout of the repository.

With ``--against DIR`` it runs phase a, then only a same-call comparison of
this tree's revise kernels against those built from ``DIR`` (another tree's
``csrc``, e.g. the parent commit's from ``git archive``), bit for bit and
timed in turns (other, this, this, other): the stacked revises on every
phase-b mix at both shapes; the single-network revises on the B=64 children,
the replayed `mac_solve` calls and its root calls; then stepped
`solve_many` and phase e's `mac_solve` on both Hopper engines in the same
turns; the block revises on x1's call 1, x4's cuts and x2's dense call 1,
the other tree's value-major launcher (where it has no pair-major one) on
the same network permuted into its layout; kernels 3 and 6 on x6's first
calls at B = 512, 1, 5 and 64, the other tree's single-network launcher
where it has no launcher of this tree's route from n = 2048. It prints no
result line.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the 32-bit ALU rate
#: outside the tensor cores (the fp32 figure) for the word ANDs
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

MAIN = dict(n=100, alpha=0.8, r=0.7, hardness=0.9)
N_INSTANCES = 32
N_ROWS = 1024
MAX_ASSIGNMENTS = 2000
PARITY_N = 30
MAC_INSTANCES = 3
CHILD_ROWS = 64

#: every kernel: (wrapper, kind, TPU kernel it replaces, the run whose launches
#: count, the phase-s run whose launches count or None off the service path)
KERNELS = [
    ("packed_fixpoint_stacked", "packed", "bitpack_support.py:295", "packed fused",
     "replay hopper_packed"),
    ("packed_revise_stacked", "packed", "bitpack_support.py:129", "packed stepped",
     "drill hopper_packed"),
    ("packed_revise", "packed", "bitpack_support.py:64", "mac_solve hopper_packed stepped",
     None),
    ("dense_fixpoint_stacked", "dense", "rtac_support.py:310", "dense fused",
     "replay hopper_dense"),
    ("dense_revise_stacked", "dense", "rtac_support.py:150", "dense stepped",
     "drill hopper_dense"),
    ("dense_revise", "dense", "rtac_support.py:71", "mac_solve hopper_dense stepped", None),
]

#: phase s: the full-size replay's families at the main path's shapes
SERVICE_VARIANTS = {
    "model_rb": [MAIN],  # bucket (128, 64): packed W=2, dense d/8=8
    "sudoku": [{"givens": 32}],  # 81x9 -> bucket (128, 16): W=1, d/8=2
    "nqueens": [{"n": 64}],  # bucket (64, 64)
}
SERVICE_RATE = 8.0
SERVICE_DURATION = 3.0
#: shortened retry backoffs of the fault drills (seconds of trace time)
FAST_BACKOFF = {"backoff_base_s": 0.01, "backoff_cap_s": 0.05}
#: what a chaos run may add to the fault-free run's span and counter names
#: (recovery spans and counters; the recurrences of the stepped rung's host
#: loop, which a fused service never runs)
RECOVERY_NAMES = ("faults.", "fallback.", "service.recover", "service.retries",
                  "service.failed", "service.shed", "fixpoint.recurrence")
#: phase s holds these calls (1-based, per kernel and table shape) of each
#: service run's stacked kernels against their plain versions
SERVICE_CHECKED_CALLS = (1, 4, 16, 64)
#: where phase s writes its traces (an ignored directory of the checkout)
TRACE_DIR = os.path.join(ROOT, "artifacts", "chip_smoke")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def ptxas_report(log: str):
    """(kernel, "registers; spills") of each kernel in an ``nvcc -Xptxas -v``
    log, the kernel named by its mangled name's function and template
    arguments (``revise_single_kernel<yLi5>``: u64 words, 5 an entry)."""
    import re

    kernel, spills = "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d+([A-Za-z_]+kernel)(?:I(\w+?)E)?", entry.group(1))
            kernel = f"{m.group(1)}<{m.group(2) or ''}>" if m else entry.group(1)[:60]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield kernel, f"{line.split(':', 1)[1].strip()}; {spills}"


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


_SLEEP_CYCLES_PER_MS = {}


def sleep_cycles_per_ms(device) -> float:
    """Device cycles of ``torch.cuda._sleep`` per millisecond, measured once
    per device with CUDA events (a private PyTorch function that spins one
    thread for a number of clock cycles)."""
    import torch

    if device not in _SLEEP_CYCLES_PER_MS:
        cycles = 10_000_000
        torch.cuda._sleep(cycles // 100)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS[device] = cycles / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS[device]


def timed_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up,
    timed with CUDA events. The host's time to queue the ``reps`` calls is
    measured first; the stream then sleeps on the device for twice that long
    before the timed calls, so a kernel shorter than its Python wrapper is
    timed back to back and not at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * queue_ms * sleep_cycles_per_ms(device)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# (b) kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_module(kind: str):
    from repro_torch.kernels import bitpack_support, rtac_support

    return bitpack_support if kind == "packed" else rtac_support


def kernel_kw(kind: str, d_p: int) -> dict:
    return dict(d=d_p, w=-(-d_p // 32)) if kind == "packed" else dict(d=d_p)


def entry_bytes(kind: str, d_p: int) -> int:
    """Bytes of one (x, a, y) entry of a network: W packed words, or d_p
    bytes dense."""
    return 4 * -(-d_p // 32) if kind == "packed" else d_p


def dom_rows(dom_p, kind: str):
    """Padded bool domains (R, n_p, d_p) in a kernel's row layout."""
    import torch

    from repro_torch.kernels import ref

    r = dom_p.shape[0]
    if kind == "packed":
        return ref.pack_bits_ref(dom_p).reshape(r, -1).contiguous()
    return dom_p.to(torch.uint8).reshape(r, -1).contiguous()


#: fused-fixpoint row mixes of phase b: (name, share of all-changed root rows)
MIXES = (("one-hot", 0.0), ("7:1", 0.125), ("root", 1.0))


def kernel_inputs(csps, n_rows: int, seed: int, device, kind: str, root_share: float = 0.125):
    """Rows as the main path gives them: a root domain with one assignment
    applied (one-hot seed), or for ``root_share`` of the rows (1 in 8 on the
    main path) an all-changed root row, each routed to a random table slot.
    Returns (tables, idx, rows in the kernel's layout, seed u8, the bool
    domains (R, n_p, d_p), (n_p, d_p))."""
    import numpy as np
    import torch

    from repro_torch.core.engine import pad_dom
    from repro_torch.engines import get_engine
    from repro_torch.kernels import ops

    eng = get_engine(f"hopper_{kind}", device=device)
    tables = eng.prepare_many(csps).payload
    n, d = csps[0].dom.shape
    n_p, d_p = eng._dims(n, d)[:2]
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, len(csps), n_rows), dtype=torch.int32, device=device)
    var = rng.integers(0, n, n_rows)
    var[rng.random(n_rows) < root_share] = -1
    var = torch.as_tensor(var, device=device)
    val = torch.as_tensor(rng.integers(0, d, n_rows), device=device)
    doms = torch.stack([c.dom for c in csps])[idx.long()]
    dom_p = ops.assign_padded_rows(pad_dom(doms, n_p, d_p), var, val)
    seed_u8 = ops._padded_seed(var, n, n_p).to(torch.uint8).contiguous()
    return tables, idx, dom_rows(dom_p, kind), seed_u8, dom_p, (n_p, d_p)


def work_bound(mask, idx, seeds, d: int, entry: int, out_bytes: int, idx_bytes: int = 4):
    """(bound_ms, bound_by, bytes, and32) of revise sweeps with these
    ``seeds`` over networks of ``entry`` bytes per (x, a, y): each needed
    input byte read once — the constrained (n·d) × entry column slice of
    every distinct (network, seeded y), those columns' mask entries, the row
    domains, seeds and slots — each output byte written once; one 32-bit AND
    per 4 bytes of every constrained (x, a, seeded y) entry."""
    import torch

    r, n = seeds[0].shape
    slots = idx.long()
    cols = mask.bool().sum(dim=1)  # (networks, n): the constrained x of each column y
    touched = torch.zeros((mask.shape[0], n), dtype=torch.bool, device=mask.device)
    ands = 0
    for seed in seeds:
        for s in slots.unique():
            touched[s] |= seed[slots == s].any(dim=0)
        ands += int((cols[slots] * seed).sum()) * d * entry // 4
    col_x = int((cols * touched).sum())
    nbytes = (col_x * d * entry + int(touched.sum()) * mask.shape[-2]
              + r * (n * entry + n + idx_bytes)
              + out_bytes)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ands / ALU_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ands


def report(label, name, m, phase: str = "b"):
    print(f"[{phase}] {label} {name}: bit-identical to plain; kernel_ms={m['ms']:.4f} "
          f"plain_ms={m['plain_ms']:.4f} bound_ms={m['bound'][0]:.4f} "
          f"(by {m['bound'][1]}: {m['bound'][2]} B, {m['bound'][3]} 32-bit ANDs)"
          + (f" sweeps={m['sweeps']} k_max={m['k_max']}" if "sweeps" in m else "")
          + (f" library_ms={m['library_ms']:.4f}" if "library_ms" in m else ""),
          flush=True)


def max_err(got, want) -> int:
    import torch

    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    if pairs[0][0].is_cuda:
        torch.cuda.synchronize(pairs[0][0].device)
    return max(int((g.long() - e.long()).abs().max()) for g, e in pairs)


def check_fixpoint(csps, label: str, device, kind: str, reps: int = 5):
    """The fused fixpoint of ``kind`` vs its plain version on one shape, on
    each row mix (`MIXES`); returns the main path's mix's measurements."""
    mod = kernel_module(kind)
    fix, fix_plain = (getattr(mod, f"{kind}_fixpoint_stacked{s}") for s in ("", "_plain"))
    out = None
    for mix, root_share in MIXES:
        tables, idx, rows, seed, _, (n_p, d_p) = kernel_inputs(csps, N_ROWS, 7, device, kind,
                                                               root_share)
        args = (*tables, idx, rows, seed)
        kw = kernel_kw(kind, d_p)
        seeds = []
        want = fix_plain(*args, **kw, seeds_out=seeds)
        bound = work_bound(tables[1], idx, seeds, d_p, entry_bytes(kind, d_p),
                           out_bytes=N_ROWS * (n_p * d_p + 1 + 4))
        err = max_err(fix(*args, **kw), want)
        check(err == 0, f"{label} mix={mix}: {fix.__name__} differs from its plain version "
                        f"(max abs err {err})")
        ms = timed_ms(lambda: fix(*args, **kw), reps, device)
        if root_share == 0.125:
            out = dict(max_abs_err=err, ms=ms,
                       plain_ms=timed_ms(lambda: fix_plain(*args, **kw), 2, device),
                       bound=bound, sweeps=len(seeds), k_max=int(want[2].max()))
            report(f"{label} mix={mix}", fix.__name__, out)
        else:
            print(f"[b] {label} mix={mix} {fix.__name__}: bit-identical to plain; "
                  f"kernel_ms={ms:.4f} bound_ms={bound[0]:.4f} sweeps={len(seeds)} "
                  f"k_max={int(want[2].max())}", flush=True)
    return {fix.__name__: out}


def revise_mixes(csps, device, kind: str):
    """The stacked revise's inputs on each row mix of phase b: (mix, tables,
    idx, rows, seed, (n_p, d_p)) for `MIXES`, then "late": the 7:1 rows with
    the third sweep's seeds of the plain fixpoint, as a later stepped sweep
    revises them (converged rows frozen, their seeds zero)."""
    import torch

    fix_plain = getattr(kernel_module(kind), f"{kind}_fixpoint_stacked_plain")
    for mix, root_share in MIXES:
        tables, idx, rows, seed, _, dims = kernel_inputs(csps, N_ROWS, 7, device, kind,
                                                         root_share)
        yield mix, tables, idx, rows, seed, dims
        if mix == "7:1":
            seeds = []
            fix_plain(*tables, idx, rows, seed, **kernel_kw(kind, dims[1]), seeds_out=seeds)
            seed = seeds[min(2, len(seeds) - 1)].to(torch.uint8).contiguous()
            late = (f"late (sweep {min(3, len(seeds))} of {len(seeds)}, "
                    f"{int(seed.any(dim=1).sum())} of {N_ROWS} rows seeded)",
                    tables, idx, rows, seed, dims)
    yield late


def check_revise(csps, label: str, device, kind: str, reps: int = 5):
    """The stacked revise of ``kind`` vs its plain version on each row mix of
    `revise_mixes`, bit for bit, each timed beside its bound; returns the
    main path's mix's (7:1) measurements."""
    mod = kernel_module(kind)
    rev, rev_plain = (getattr(mod, f"{kind}_revise_stacked{s}") for s in ("", "_plain"))
    out = None
    for mix, tables, idx, rows, seed, (n_p, d_p) in revise_mixes(csps, device, kind):
        args = (*tables, idx, rows, seed)
        kw = kernel_kw(kind, d_p)
        err = max_err(rev(*args, **kw), rev_plain(*args, **kw))
        check(err == 0, f"{label} mix={mix}: {rev.__name__} differs from its plain version "
                        f"(max abs err {err})")
        ms = timed_ms(lambda: rev(*args, **kw), 4 * reps, device)
        bound = work_bound(tables[1], idx, [seed.bool()], d_p, entry_bytes(kind, d_p),
                           out_bytes=N_ROWS * n_p * d_p)
        if mix == "7:1":
            out = dict(max_abs_err=err, ms=ms,
                       plain_ms=timed_ms(lambda: rev_plain(*args, **kw), 2, device),
                       bound=bound)
            report(f"{label} mix={mix}", rev.__name__, out)
        else:
            print(f"[b] {label} mix={mix} {rev.__name__}: bit-identical to plain; "
                  f"kernel_ms={ms:.4f} bound_ms={bound[0]:.4f} (by {bound[1]}: {bound[2]} B, "
                  f"{bound[3]} 32-bit ANDs)", flush=True)
    return {rev.__name__: out}


def check_stepped(csps, label: str, device, kind: str, reps: int = 3):
    """The whole stepped fixpoint of ``kind`` (`ops.enforce_rows`, one
    stacked revise launch a sweep, one host sync a sweep) beside the fused
    kernel on the 7:1 rows: identical results; both timed."""
    import torch

    from repro_torch.kernels import ops

    tables, idx, _, seed, dom_p, (n_p, d_p) = kernel_inputs(csps, N_ROWS, 7, device, kind)
    kdims = ops.dims(kind, n_p, d_p)
    ch = seed.bool()
    run = lambda fused: ops.enforce_rows(kind, fused, tables, dom_p, ch, idx, kdims)  # noqa: E731
    rev = getattr(kernel_module(kind), f"{kind}_revise_stacked")
    before = rev.launches
    stepped = run(False)
    launches = rev.launches - before
    fused = run(True)
    for a, b in zip(stepped, fused):
        check(torch.equal(a, b), f"{label}: {kind} stepped fixpoint differs from the fused one")
    ms_stepped = timed_ms(lambda: run(False), reps, device)
    ms_fused = timed_ms(lambda: run(True), reps, device)
    print(f"[b] {label} mix=7:1 {kind} stepped fixpoint (ops.enforce_rows): {ms_stepped:.4f} ms "
          f"in {int(stepped[2].max())} sweeps ({launches} {rev.__name__} launches); fused "
          f"{ms_fused:.4f} ms; identical results", flush=True)


def check_kernels(csps, label: str, device, kind: str):
    """The stacked fixpoint and revise of ``kind`` vs their plain versions on
    one shape, and the stepped fixpoint beside the fused one; returns
    per-kernel measurements at the main path's mix."""
    out = check_fixpoint(csps, label, device, kind)
    out.update(check_revise(csps, label, device, kind))
    check_stepped(csps, label, device, kind)
    return out


def child_inputs(csp, device, kind: str):
    """(args, kw) of one network and CHILD_ROWS children of its root
    (variable 0 assigned each value in turn, one-hot seeds), as `mac_solve`
    enforces a node's children."""
    import torch

    from repro_torch.core.engine import pad_dom
    from repro_torch.engines import get_engine
    from repro_torch.kernels import ops

    b = CHILD_ROWS
    n, d = csp.dom.shape
    (cons, mask), dims = get_engine(f"hopper_{kind}", device=device).prepare(csp).payload
    n_p, d_p = dims[:2]
    var = torch.zeros(b, dtype=torch.long, device=device)
    val = torch.arange(b, device=device) % d
    dom_p = ops.assign_padded_rows(pad_dom(csp.dom.expand(b, n, d), n_p, d_p), var, val)
    seed = ops._padded_seed(var, n, n_p).to(torch.uint8).contiguous()
    return (cons, mask, dom_rows(dom_p, kind), seed), kernel_kw(kind, d_p)


def single_bound(kind: str, calls, kw):
    """`work_bound` of single-network or block revise ``calls`` ((network,
    mask, rows, seed) operands each; the mask (nx, n), nx = n for a whole
    network), summed: (bound_ms, bound_by, bytes, and32). The outputs are
    B·nx·d bytes whatever the network's layout."""
    import torch

    total = [0.0, {}, 0, 0]
    for _cons, mask, _, seed in calls:
        b = seed.shape[0]
        bound = work_bound(mask[None], torch.zeros(b, dtype=torch.int32, device=mask.device),
                           [seed.bool()], kw["d"], entry_bytes(kind, kw["d"]),
                           out_bytes=b * mask.shape[0] * kw["d"], idx_bytes=0)
        total[0] += bound[0]
        total[1][bound[1]] = total[1].get(bound[1], 0) + 1
        total[2] += bound[2]
        total[3] += bound[3]
    return total[0], max(total[1], key=total[1].get), total[2], total[3]


def check_single_kernels(csp, label: str, device, reps: int = 20):
    """`packed_revise` and `dense_revise` vs their plain versions on
    CHILD_ROWS one-hot children of one network (`child_inputs`)."""
    import torch

    out = {}
    for kind in ("packed", "dense"):
        mod = kernel_module(kind)
        args, kw = child_inputs(csp, device, kind)
        fn, plain = getattr(mod, f"{kind}_revise"), getattr(mod, f"{kind}_revise_plain")
        err = max_err(fn(*args, **kw), plain(*args, **kw))
        check(err == 0, f"{label}: {fn.__name__} differs from its plain version "
                        f"(max abs err {err})")
        out[fn.__name__] = dict(
            max_abs_err=err,
            ms=timed_ms(lambda: fn(*args, **kw), reps, device),
            plain_ms=timed_ms(lambda: plain(*args, **kw), 2, device),
            bound=single_bound(kind, [args], kw),
        )
        report(label, fn.__name__, out[fn.__name__])
    return out


# ---------------------------------------------------------------------------
# (b) the single-network revise calls of one mac_solve, replayed
# ---------------------------------------------------------------------------

#: phase b's shapes of the word loop's epilogue (rows, n_p, d_p):
#: `mac_solve` at QWH order 40 (1-2 rows of n_p = 1,600, d_p = 40), an
#: `enforce_batch` of 512 search nodes on the production CSP (n_p = 4,096,
#: d_p = 32), and the main path's padded shape
EPILOGUE_SHAPES = [(1, 1600, 40), (2, 1600, 40), (512, 4096, 32), (64, 104, 40)]


def epilogue_operands(b: int, n: int, d: int, device, seed: int = 0):
    """The word loop's epilogue operands (`packed_word_epilogue`): domain
    words with half the bits of the d values set, 2 % of the values
    violated, seeds on two rows in three (the third seedless), row 1 (if
    any) with an empty domain and seeds, row 0 wiping out its variable 1,
    zero counts."""
    import torch

    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed)
    w = -(-d // 32)
    bits = torch.rand((b, n, 32 * w), generator=g, device=device) < 0.5
    bits[..., d:] = False
    if b > 1:
        bits[1, 2] = False
    words = ref.pack_bits_ref(bits).reshape(b, n * w).contiguous()
    viol = (torch.rand((b, n * d), generator=g, device=device) < 0.02).to(torch.uint8)
    viol.view(b, n, d)[0, 1] = 1
    seeded = torch.arange(b, device=device) % 3 != 2
    seed_ = ((torch.rand((b, n), generator=g, device=device) < 0.3)
             & seeded[:, None]).to(torch.uint8)
    return [words, viol, seed_, torch.zeros(b, dtype=torch.uint8, device=device),
            torch.zeros(b, dtype=torch.int32, device=device),
            torch.zeros(2, dtype=torch.int32, device=device)]


def check_word_epilogue(device, reps: int = 50):
    """The word loop's epilogue kernel (csrc/word_epilogue.cu) against its
    plain version on the card at `EPILOGUE_SHAPES`, every operand bit for
    bit after the call; device µs a call of each (CUDA events around each
    call, queued behind a device sleep, the operands restored between
    calls) beside the kernel's byte bound at `HBM_BYTES_PER_S`: the seeds
    and words of every row read, the violations of the active rows read,
    their words and seeds written, and the seeds of a seeded row that is
    not active cleared."""
    import torch

    from repro_torch.kernels import bitpack_support

    def device_us(fn, operands, pristine):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        total, wait = 0.0, int(2 * sleep_cycles_per_ms(device))
        for _ in range(reps):
            for t, p in zip(operands, pristine):
                t.copy_(p)
            torch.cuda._sleep(wait)  # the call is queued before the device reaches it
            start.record()
            fn(*operands, d=d, w=w)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return 1e3 * total / reps

    for b, n, d in EPILOGUE_SHAPES:
        w = -(-d // 32)
        pristine = epilogue_operands(b, n, d, device, seed=b + n)
        got, want = [t.clone() for t in pristine], [t.clone() for t in pristine]
        bitpack_support.packed_word_epilogue(*got, d=d, w=w)
        bitpack_support.packed_word_epilogue_plain(*want, d=d, w=w)
        err = max_err(tuple(got), tuple(want))
        check(err == 0, f"word epilogue B={b} n_p={n} d_p={d}: max_abs_err={err}")
        kernel_us = device_us(bitpack_support.packed_word_epilogue, got, pristine)
        plain_us = device_us(bitpack_support.packed_word_epilogue_plain, want, pristine)
        seeded = pristine[2].bool().any(dim=1)
        alive = (pristine[0].view(b, n, w) != 0).any(dim=-1).all(dim=-1)
        active, idle = int((seeded & alive).sum()), int((seeded & ~alive).sum())
        # every row: seeds and words read; an active row: its violations
        # read, its words and seeds written; a seeded row that is not
        # active: its seeds cleared
        nbytes = n * (b * (1 + 4 * w) + active * (d + 4 * w + 1) + idle)
        print(f"[b] word epilogue B={b} n_p={n} d_p={d} W={w}: bit-identical to plain; "
              f"kernel_us={kernel_us:.2f} plain_us={plain_us:.2f} "
              f"bound_us={1e6 * nbytes / HBM_BYTES_PER_S:.3f} ({nbytes} B)", flush=True)


#: the phase-e instance whose single-network revise calls phase b replays
REPLAY_INSTANCE = 1
#: calls a replay queues behind one device sleep (`timed_ms`), well under the
#: launch queue's depth
REPLAY_CHUNK = 256


def record_single_calls(device, kind: str, max_assignments: int = MAX_ASSIGNMENTS,
                        spec=MAIN):
    """The operands of every `packed_revise` or `dense_revise` call of one
    phase-e `mac_solve` (instance `REPLAY_INSTANCE`) on the stepped engine
    (the fused one runs the fused kernel at this shape), recorded by wrapping
    the wrapper in its module for that solve (the wrapper counts its
    launches on the module's name, so the recorder carries the count):
    (calls, kw), each call a (network, mask, rows, seed) tuple with rows and
    seed copied."""
    from repro_torch.core import mac_solve
    from repro_torch.engines import get_engine
    from repro_torch.problems import generate

    mod, name = kernel_module(kind), f"{kind}_revise"
    wrapper, calls, kws = getattr(mod, name), [], set()

    def record(cons, mask, rows, seed, **kw):
        calls.append((cons, mask, rows.clone(), seed.clone()))
        kws.add(tuple(sorted(kw.items())))
        return wrapper(cons, mask, rows, seed, **kw)

    csp = generate("model_rb", seed=REPLAY_INSTANCE, device=device, **spec)
    record.launches = wrapper.launches
    setattr(mod, name, record)
    try:
        mac_solve(csp, engine=get_engine(f"hopper_{kind}", fixpoint="stepped", device=device),
                  max_assignments=max_assignments)
    finally:
        setattr(mod, name, wrapper)
        wrapper.launches = record.launches
    check(len(kws) == 1 and len({(id(c[0]), id(c[1])) for c in calls}) == 1,
          f"{name}: a mac_solve called it on more than one network or shape")
    return calls, dict(kws.pop())


def root_calls(calls, n: int):
    """The calls that revise one row with every real variable seeded."""
    return [c for c in calls if c[3].shape[0] == 1 and int(c[3].sum()) == n]


def replay_ms(fn, calls, kw, device) -> float:
    """Device ms per launch of ``fn`` over ``calls``, back to back: chunks of
    `REPLAY_CHUNK` calls, each timed by `timed_ms` (so the device runs them
    at its own pace behind one sleep), summed."""
    total = 0.0
    for i in range(0, len(calls), REPLAY_CHUNK):
        chunk = calls[i:i + REPLAY_CHUNK]
        total += timed_ms(lambda: [fn(*c, **kw) for c in chunk], 1, device)
    return total / len(calls)


def launch_floor_ms(device) -> float:
    """Device ms of an empty launch on the same stream, timed as a replay
    chunk is: `torch.cuda._sleep(0)`, REPLAY_CHUNK times behind one sleep."""
    import torch

    return timed_ms(lambda: torch.cuda._sleep(0), REPLAY_CHUNK, device)


def describe_calls(calls, n: int) -> str:
    """The B histogram and seeds per row of recorded calls."""
    import collections

    import torch

    hist = collections.Counter(c[3].shape[0] for c in calls)
    per_row = torch.cat([c[3].sum(dim=1) for c in calls])
    seeded = per_row[per_row > 0].float()
    return (f"{len(calls)} calls, B histogram "
            f"{dict(sorted(hist.items()))}; {per_row.numel()} rows, "
            f"{int((per_row == 0).sum())} seedless; seeded rows: mean "
            f"{float(seeded.mean()):.2f} seeds, median {float(seeded.median()):.0f}, "
            f"max {int(seeded.max())}; {len(root_calls(calls, n))} root calls")


def check_replay(device, kind: str, floor_ms: float, n: int):
    """``kind``'s single-network revise over the recorded calls of one
    phase-e `mac_solve`: the kernel and its plain version bit for bit on
    every call; the kernel timed back to back (device ms per launch), the
    plain version once (ms per call, its host time included); the summed
    bound per launch; the same for the root calls alone."""
    import torch

    mod = kernel_module(kind)
    fn, plain = getattr(mod, f"{kind}_revise"), getattr(mod, f"{kind}_revise_plain")
    calls, kw = record_single_calls(device, kind)
    err = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    want = [plain(*c, **kw) for c in calls]
    torch.cuda.synchronize(device)
    plain_ms = 1e3 * (time.perf_counter() - t0) / len(calls)
    for c, w in zip(calls, want):
        err = max(err, max_err(fn(*c, **kw), w))
    check(err == 0, f"replay: {fn.__name__} differs from its plain version (max abs err {err})")
    ms = replay_ms(fn, calls, kw, device)
    bound = single_bound(kind, calls, kw)
    print(f"[b] replay {fn.__name__} (mac_solve instance {REPLAY_INSTANCE}, "
          f"max_assignments={MAX_ASSIGNMENTS}): {describe_calls(calls, n)}", flush=True)
    print(f"[b] replay {fn.__name__}: bit-identical to plain on every call; kernel "
          f"{1e3 * ms:.3f} us/launch ({1e3 * (ms - floor_ms):.3f} above the launch floor), "
          f"plain {1e3 * plain_ms:.1f} us/call, bound {1e3 * bound[0] / len(calls):.4f} "
          f"us/launch (by {bound[1]}: {bound[2]} B, {bound[3]} 32-bit ANDs in all)", flush=True)
    roots = root_calls(calls, n)
    if roots:
        root_ms = replay_ms(fn, roots * (REPLAY_CHUNK // len(roots)), kw, device)
        root_bound = single_bound(kind, roots, kw)
        print(f"[b] replay {fn.__name__} root calls (B=1, all {n} variables seeded): kernel "
              f"{1e3 * root_ms:.3f} us/launch, bound {1e3 * root_bound[0] / len(roots):.4f} "
              f"us/launch (by {root_bound[1]})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound=(bound[0] / len(calls), *bound[1:]))


# ---------------------------------------------------------------------------
# (c)/(d) the main path
# ---------------------------------------------------------------------------


def stats_key(st):
    """Every SearchStats field except the timings and the launch bill."""
    return (st.n_assignments, st.n_backtracks, st.recurrences, st.revisions,
            st.exhausted, st.rounds, st.rows, st.members, st.cancelled_members,
            st.quarantined)


def reset_launches() -> None:
    for kind in ("packed", "dense"):
        kernel_module(kind).reset_launches()


def launch_counts() -> dict:
    return {name: getattr(kernel_module(kind), name).launches for name, kind, *_ in KERNELS}


def run_solve(csps, engine, max_assignments: int, device):
    """`solve_many` with every launch count set to 0 just before and read
    just after."""
    import torch

    from repro_torch.core import solve_many

    reset_launches()
    tel = {}
    t0 = time.perf_counter()
    sols, stats = solve_many(csps, engine=engine, max_assignments=max_assignments,
                             telemetry=tel)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return sols, stats, tel, seconds, launch_counts()


def launched(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def compare_runs(label, csps, a, b):
    from repro_torch.core import check_solution

    sols_a, st_a = a[0], a[1]
    sols_b, st_b = b[0], b[1]
    check(sols_a == sols_b, f"{label}: solutions differ")
    check([stats_key(s) for s in st_a] == [stats_key(s) for s in st_b],
          f"{label}: search statistics differ")
    for i, (csp, sol) in enumerate(zip(csps, sols_a)):
        if sol is not None:
            check(check_solution(csp, sol), f"{label}: instance {i} solution is wrong")


def describe(name, run):
    sols, stats, tel, seconds, launches = run
    solved = sum(s is not None for s in sols)
    exhausted = sum(s.exhausted for s in stats)
    print(f"    {name}: {seconds:.3f} s, rounds={tel['rounds']} rows={tel['rows_dispatched']} "
          f"rows_padded={tel['rows_padded']} ms/round={1e3 * seconds / max(tel['rounds'], 1):.3f} "
          f"launches={tel['launches']} kernel counts={launched(launches)} solved={solved} "
          f"exhausted={exhausted} assignments={sum(s.n_assignments for s in stats)} "
          f"host_bytes_per_round={tel['host_bytes_per_round']:.1f}", flush=True)


def main_path(device, max_assignments: int = MAX_ASSIGNMENTS, n_instances: int = N_INSTANCES,
              spec=MAIN):
    from repro_torch.core.engine import frontier_capacity
    from repro_torch.engines import get_engine
    from repro_torch.problems import generate

    csps = [generate("model_rb", seed=i, device=device, **spec) for i in range(n_instances)]
    n, d = csps[0].dom.shape
    fused = get_engine("hopper_packed", fixpoint="fused", device=device)
    cap = frontier_capacity(n_instances, n, d)
    print(f"[c] solve_many on {n_instances} model_rb instances n={n} d={d} "
          f"max_assignments={max_assignments}; packed tables "
          f"{n_instances * fused.network_nbytes(n, d)} B, FrontierTable "
          f"{cap * (n * d + n)} B", flush=True)
    run_f = run_solve(csps, fused, max_assignments, device)
    describe("hopper_packed fused", run_f)
    run_s = run_solve(csps, get_engine("hopper_packed", fixpoint="stepped", device=device),
                      max_assignments, device)
    describe("hopper_packed stepped", run_s)
    compare_runs("fused vs stepped", csps, run_f, run_s)
    check_launches("packed", run_f, run_s)
    print("[c] fused == stepped: solutions and search statistics identical; every "
          "solution checks; fused launches == rounds", flush=True)
    return run_f, run_s


def check_launches(kind: str, run_f, run_s):
    """The fused run launched only the fused kernel of ``kind``, once per
    round; the stepped run only the stacked revise of ``kind``."""
    fused, stepped = f"{kind}_fixpoint_stacked", f"{kind}_revise_stacked"
    rounds = run_f[2]["rounds"]
    check(launched(run_f[4]) == {fused: rounds},
          f"{kind} fused run launched {launched(run_f[4])} in {rounds} rounds")
    check(set(launched(run_s[4])) == {stepped},
          f"{kind} stepped run launched {launched(run_s[4])}")


def dense_path(device, run_packed, max_assignments: int = MAX_ASSIGNMENTS,
               n_instances: int = N_INSTANCES, spec=MAIN):
    """(c2): the main path's workload on `hopper_dense`, fused then stepped,
    held against each other and against the `hopper_packed` fused run."""
    from repro_torch.engines import get_engine
    from repro_torch.problems import generate

    csps = [generate("model_rb", seed=i, device=device, **spec) for i in range(n_instances)]
    n, d = csps[0].dom.shape
    fused = get_engine("hopper_dense", fixpoint="fused", device=device)
    print(f"[c2] solve_many on hopper_dense, the same {n_instances} instances; dense tables "
          f"{n_instances * fused.network_nbytes(n, d)} B", flush=True)
    run_f = run_solve(csps, fused, max_assignments, device)
    describe("hopper_dense fused", run_f)
    run_s = run_solve(csps, get_engine("hopper_dense", fixpoint="stepped", device=device),
                      max_assignments, device)
    describe("hopper_dense stepped", run_s)
    compare_runs("dense fused vs dense stepped", csps, run_f, run_s)
    compare_runs("dense fused vs packed fused", csps, run_f, run_packed)
    check_launches("dense", run_f, run_s)
    print("[c2] hopper_dense fused == stepped == hopper_packed: solutions and search "
          "statistics identical; fused launches == rounds", flush=True)
    return run_f, run_s


def mac_instances(device, n_instances: int = MAC_INSTANCES, spec=MAIN):
    from repro_torch.problems import generate

    return [generate("model_rb", seed=i, device=device, **spec) for i in range(n_instances)]


def run_mac(csps, engine: str, max_assignments: int, device):
    """`mac_solve` of each of ``csps`` on ``engine``, one at a time, with
    every launch count set to 0 just before and read just after: (results,
    seconds, rounds, launch counts)."""
    import torch

    from repro_torch.core import mac_solve

    reset_launches()
    t0 = time.perf_counter()
    out = [mac_solve(csp, engine=engine, device=device, max_assignments=max_assignments)
           for csp in csps]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return out, seconds, sum(st.rounds for _, st in out), launch_counts()


def mac_path(device, max_assignments: int = MAX_ASSIGNMENTS, n_instances: int = MAC_INSTANCES,
             spec=MAIN):
    """(e): `mac_solve` on a few instances of the main shape, one at a time,
    on the two Hopper engines, fused (the fused kernel once a round) and
    stepped (the single-network revise once a recurrence), and on `einsum`."""
    from repro_torch.core import check_solution
    from repro_torch.engines import get_engine

    csps = mac_instances(device, n_instances, spec)
    n, d = csps[0].dom.shape
    print(f"[e] mac_solve on {n_instances} model_rb instances n={n} d={d} "
          f"max_assignments={max_assignments}", flush=True)
    runs = {}
    engines = {f"{name} {fixpoint}": get_engine(name, fixpoint=fixpoint, device=device)
               for name in ("hopper_packed", "hopper_dense") for fixpoint in ("fused", "stepped")}
    labels = list(engines)
    engines["einsum"] = get_engine("einsum", device=device)
    for name, eng in engines.items():
        out, seconds, rounds, counts = run_mac(csps, eng, max_assignments, device)
        runs[name] = (out, counts, rounds)
        print(f"    {name}: {seconds:.3f} s, rounds={rounds} "
              f"ms/round={1e3 * seconds / max(rounds, 1):.3f} "
              f"rows={sum(st.rows for _, st in out)} "
              f"assignments={sum(st.n_assignments for _, st in out)} "
              f"solved={sum(sol is not None for sol, _ in out)} "
              f"exhausted={sum(st.exhausted for _, st in out)} "
              f"kernel counts={launched(counts)}", flush=True)
    want = [(sol, stats_key(st)) for sol, st in runs["einsum"][0]]
    for name in labels:
        check([(sol, stats_key(st)) for sol, st in runs[name][0]] == want,
              f"mac_solve on {name} differs from einsum")
    for csp, (sol, _) in zip(csps, runs["einsum"][0]):
        if sol is not None:
            check(check_solution(csp, sol), "a mac_solve solution is wrong")
    for kind in ("packed", "dense"):
        fused = launched(runs[f"hopper_{kind} fused"][1])
        check(fused == {f"{kind}_fixpoint_stacked": runs[f"hopper_{kind} fused"][2]},
              f"hopper_{kind} fused mac_solve launched {fused}, not its fused kernel once a "
              f"round")
        stepped = launched(runs[f"hopper_{kind} stepped"][1])
        check(set(stepped) == {f"{kind}_revise"},
              f"hopper_{kind} stepped mac_solve launched {stepped}")
    check(not launched(runs["einsum"][1]), "einsum launched a kernel")
    print("[e] mac_solve hopper_packed == hopper_dense == einsum, fused and stepped: solutions "
          "and search statistics identical; every solution checks; the fused engines launch "
          "their fused kernel once a round", flush=True)
    return runs


def profiled(label: str, run):
    """Where a round's time goes: `torch.profiler` over ``run()``, which
    returns (wall seconds, rounds). Prints the wall time, the device busy
    time (`device_busy_ms`: the union of the kernels' and copies' device
    intervals) and share beside their device times summed, and the kernels
    that take the most device time, each with its share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.distributed_ac import device_busy_ms

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seconds, rounds = run()
    wall_ms = 1e3 * seconds
    device_time = lambda e: e.self_device_time_total / 1e3  # us -> ms
    # device-side events only (kernels, copies): a CPU op's entry repeats the
    # device time of the kernels it launched, a user annotation's those inside it
    on_device = sorted((e for e in prof.key_averages()
                        if e.device_type != torch.autograd.DeviceType.CPU
                        and not e.is_user_annotation and device_time(e) > 0),
                       key=device_time, reverse=True)
    if not on_device:
        print(f"[p] {label}: profiler recorded no device time: device busy share not measured")
        return
    busy_ms, summed_ms = device_busy_ms(prof), sum(device_time(e) for e in on_device)
    print(f"[p] profiled {label}: "
          f"wall {wall_ms:.1f} ms over {rounds} rounds ({wall_ms / rounds:.3f} ms/round, "
          f"profiler on); device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of wall "
          f"(kernels and copies summed: {summed_ms:.1f} ms)")
    for e in on_device[:8]:
        print(f"[p]   {device_time(e):9.2f} ms ({100 * device_time(e) / wall_ms:5.1f}% of wall) "
              f"{e.count:6d} calls  {e.key[:90]}")


def profile_main_path(device, engine: str, fixpoint: str, max_assignments: int = 500,
                      n_instances: int = N_INSTANCES, spec=MAIN):
    """`profiled` over one `solve_many` on ``engine`` with its ``fixpoint``
    ("fused" or "stepped"; a smaller budget keeps the trace short)."""
    from repro_torch.engines import get_engine
    from repro_torch.problems import generate

    csps = [generate("model_rb", seed=i, device=device, **spec) for i in range(n_instances)]
    eng = get_engine(engine, fixpoint=fixpoint, device=device)

    def run():
        out = run_solve(csps, eng, max_assignments, device)
        return out[3], out[2]["rounds"]

    profiled(f"{engine} {fixpoint} solve_many (max_assignments={max_assignments})", run)


def profile_mac(device, engine: str, max_assignments: int = 500):
    """`profiled` over one phase-e `mac_solve` (instance `REPLAY_INSTANCE`)
    on ``engine``, the single-network kernels' path (a smaller budget keeps
    the trace short)."""
    csp = mac_instances(device, REPLAY_INSTANCE + 1)[REPLAY_INSTANCE]

    def run():
        _, seconds, rounds, _ = run_mac([csp], engine, max_assignments, device)
        return seconds, rounds

    profiled(f"{engine} mac_solve (instance {REPLAY_INSTANCE}, "
             f"max_assignments={max_assignments})", run)


def profile_service(device, engine: str, max_assignments: int = 300):
    """`profiled` over phase s's full-size replay on ``engine`` (fused; a
    smaller budget keeps the trace, whose reduction takes most of phase p's
    time, short)."""
    from repro_torch.engines import get_engine
    from repro_torch.service import poisson_trace

    events = poisson_trace(list(SERVICE_VARIANTS), rate=SERVICE_RATE,
                           duration=SERVICE_DURATION, seed=0, variants=SERVICE_VARIANTS)

    def run():
        _, snap, seconds, *_ = run_service(get_engine(engine, device=device), events, device,
                                           max_assignments, record=False)
        return seconds, snap["rounds"]

    profiled(f"{engine} service replay (phase s1, max_assignments={max_assignments})", run)


def parity_einsum(device, max_assignments: int = MAX_ASSIGNMENTS,
                  n_instances: int = N_INSTANCES, n: int = PARITY_N):
    from repro_torch.engines import get_engine
    from repro_torch.problems import generate

    spec = dict(MAIN, n=n)
    csps = [generate("model_rb", seed=i, device=device, **spec) for i in range(n_instances)]
    print(f"[d] parity at n={n} d={csps[0].dom.shape[1]}", flush=True)
    run_e = run_solve(csps, get_engine("einsum", device=device), max_assignments, device)
    describe("einsum", run_e)
    run_h = run_solve(csps, get_engine("hopper_packed", device=device), max_assignments, device)
    describe("hopper_packed fused", run_h)
    compare_runs("hopper_packed vs einsum", csps, run_h, run_e)
    print("[d] hopper_packed == einsum: solutions and search statistics identical", flush=True)


# ---------------------------------------------------------------------------
# (s) the solver service on the card
# ---------------------------------------------------------------------------


def verdict(req):
    """A request's result as the fields phase s compares."""
    st = req.stats
    return (req.status.value, req.solution, st and (st.n_assignments, st.n_backtracks,
                                                    st.recurrences, st.revisions, st.exhausted))


class HostRouting:
    """Counts `route_rows_on_host` calls while active (the service on the
    Hopper engines must make none: every round reads the slot tables)."""

    def __enter__(self):
        from repro_torch.core import engine as engine_mod

        self.mod, self.real, self.calls = engine_mod, engine_mod.route_rows_on_host, 0

        def counting(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)

        engine_mod.route_rows_on_host = counting
        return self

    def __exit__(self, *exc):
        self.mod.route_rows_on_host = self.real


class StackedCalls:
    """Records kernel calls while active, by wrapping each wrapper in its
    module (the wrapper counts its launches on the module's name, so the
    recorder carries the count): for each (kernel, table shape, widths), the
    calls numbered in ``numbers`` (default `SERVICE_CHECKED_CALLS`), their
    operands copied, since an install rewrites the slot tables in place,
    but for the positions in ``shared``, kept as they are (the sharded
    path's network and mask, placed once and never written). ``names``
    defaults to the stacked kernels."""

    NAMES = [(name, kind) for name, kind, *_ in KERNELS if name.endswith("_stacked")]

    def __init__(self, names=None, numbers=SERVICE_CHECKED_CALLS, shared=()):
        self.names = self.NAMES if names is None else names
        self.numbers = numbers
        self.shared = shared

    def __enter__(self):
        self.calls, self.seen, self.real = [], collections.Counter(), {}
        for name, kind in self.names:
            real = self.real[name] = getattr(kernel_module(kind), name)
            setattr(kernel_module(kind), name, self._recorder(name, real))
        return self

    def _recorder(self, name, real):
        def record(*args, **kw):
            key = (name, tuple(args[0].shape), tuple(sorted(kw.items())))
            self.seen[key] += 1
            if self.seen[key] in self.numbers:
                self.calls.append((key, self.seen[key], tuple(
                    a if i in self.shared else a.clone() for i, a in enumerate(args)), kw))
            return real(*args, **kw)

        record.launches = real.launches
        return record

    def __exit__(self, *exc):
        for name, kind in self.names:
            mod = kernel_module(kind)
            self.real[name].launches = getattr(mod, name).launches
            setattr(mod, name, self.real[name])


def run_service(engine, events, device, max_assignments=None, record=True, **service_kwargs):
    """Replay ``events`` through a fresh `SolverService` on ``engine`` with
    every launch count set to 0 just before and read just after: (requests,
    snapshot, wall seconds, launch counts, host-routing calls, the recorded
    `StackedCalls` or None)."""
    import torch

    from repro_torch.service import FastForwardClock, SolverService, replay

    clock = FastForwardClock()
    svc = SolverService(engine=engine, device=device, clock=clock, **service_kwargs)
    reset_launches()
    with HostRouting() as routing, StackedCalls() if record else contextlib.nullcontext() as calls:
        t0 = time.perf_counter()
        reqs = replay(svc, events, clock, max_assignments=max_assignments)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    return reqs, svc.snapshot(), seconds, launch_counts(), routing.calls, calls


def check_recorded_calls(phase: str, label: str, recorder: "StackedCalls"):
    """Every call ``recorder`` recorded: the kernel against its plain version
    on the copied operands, bit for bit; one line per kernel and table
    shape. Then drops the copies."""
    from repro_torch.kernels import ops

    checked, n_of = collections.defaultdict(list), {}
    for key, i, args, kw in recorder.calls:
        name = key[0]
        mod = kernel_module(name.split("_")[0])
        err = max_err(getattr(mod, name)(*args, **kw), getattr(mod, f"{name}_plain")(*args, **kw))
        check(err == 0, f"{label}: {name} call {i} at {key[1:]} differs from its plain version "
                        f"(max abs err {err})")
        checked[key].append(f"{i} ({args[-1].shape[0]} rows)")
        n_of[key] = args[-1].shape[-1]  # the seeds' width
    for key, calls in checked.items():
        name, shape, kw = key[0], key[1], dict(key[2])
        n_p = n_of[key]
        widths = f"W={kw['w']}" if "w" in kw else f"d/8={kw['d'] // ops.D_MULT}"
        print(f"[{phase}] {label} {name} at n_p={n_p} d_p={kw['d']} ({widths}, table "
              f"{'x'.join(map(str, shape))}): calls {', '.join(calls)} of {recorder.seen[key]} bit-identical to plain",
              flush=True)
    recorder.calls.clear()


def describe_service(label, run):
    reqs, snap, seconds, counts, routing, _ = run
    slots = {b: (info["capacity"], info["resident_nbytes"]) for b, info in snap["buckets"].items()}
    print(f"    {label}: {len(reqs)} requests in {seconds:.3f} s wall; completed "
          f"{snap['completed']}/{snap['submitted']}; throughput {snap['throughput_rps']:.3f} "
          f"inst/s over {snap['span_s']:.3f} s of service time; latency p50 "
          f"{snap['p50_ms']:.1f} ms p95 {snap['p95_ms']:.1f} ms p99 {snap['p99_ms']:.1f} ms; "
          f"rounds={snap['rounds']} ms/round={1e3 * seconds / max(snap['rounds'], 1):.3f} "
          f"rows/dispatch={snap['mean_rows_per_dispatch']:.2f} "
          f"demotions={snap['demotions']} host routing calls={routing}; "
          f"kernel counts={launched(counts)}; buckets (slots, table bytes) {slots}",
          flush=True)


def service_replay(device, max_assignments: int = MAX_ASSIGNMENTS):
    """(s1): the full-size replay on both Hopper engines, each request held
    against `solve_many` on the same engine, the engines against each other;
    returns {engine: run}."""
    import collections

    from repro_torch.core import check_solution, solve_many
    from repro_torch.engines import get_engine
    from repro_torch.service import bucket_for, poisson_trace

    events = poisson_trace(list(SERVICE_VARIANTS), rate=SERVICE_RATE,
                           duration=SERVICE_DURATION, seed=0, variants=SERVICE_VARIANTS)
    csps = [ev.build(device) for ev in events]
    shapes = collections.Counter(tuple(c.dom.shape) for c in csps)
    print(f"[s] replay: poisson_trace {SERVICE_RATE:g}/s over {SERVICE_DURATION:g} s -> "
          f"{len(events)} requests, max_assignments={max_assignments}; shapes -> buckets "
          + ", ".join(f"{n}x{d} ({k}) -> {bucket_for(n, d)}" for (n, d), k in shapes.items()),
          flush=True)
    runs = {}
    for name in ("hopper_packed", "hopper_dense"):
        run = runs[name] = run_service(get_engine(name, device=device), events, device,
                                       max_assignments)
        reqs, snap, _, counts, routing, _ = run
        describe_service(name, run)
        check_recorded_calls("s", name, run[5])
        kind = name.split("_")[1]
        check(all(r.done() and r.status.value == "done" for r in reqs),
              f"{name} service: not every request finished DONE")
        check(routing == 0, f"{name} service routed {routing} calls on the host")
        check(launched(counts) == {f"{kind}_fixpoint_stacked": snap["rounds"]},
              f"{name} service launched {launched(counts)} in {snap['rounds']} rounds")
        # the oracle: solve_many on the same engine, one call a shape
        want = {}
        for shape in shapes:
            idx = [i for i, c in enumerate(csps) if tuple(c.dom.shape) == shape]
            sols, stats = solve_many([csps[i] for i in idx], engine=get_engine(name, device=device),
                                     max_assignments=max_assignments)
            for i, sol, st in zip(idx, sols, stats):
                want[i] = ("done", sol, (st.n_assignments, st.n_backtracks, st.recurrences,
                                         st.revisions, st.exhausted))
        for i, req in enumerate(reqs):
            check(verdict(req) == want[i], f"{name} service request {i} differs from solve_many")
            if req.solution is not None:
                check(check_solution(csps[i], req.solution), f"{name}: request {i} is wrong")
    check([verdict(r) for r in runs["hopper_packed"][0]]
          == [verdict(r) for r in runs["hopper_dense"][0]],
          "the service on hopper_packed and on hopper_dense differ")
    print("[s] replay: every request == solve_many on its engine; hopper_packed == "
          "hopper_dense; one fused launch a round; no host routing", flush=True)
    return runs


def service_drill(device):
    """(s2): the demotion drill at the trace's default sizes: one injected
    kernel fault, no retries; the demoted requests run the stacked revise on
    the stepped rung's slot table. Verdicts equal the fault-free replay."""
    from repro_torch import faults
    from repro_torch.engines import get_engine
    from repro_torch.service import DEFAULT_VARIANTS, poisson_trace

    events = poisson_trace(list(DEFAULT_VARIANTS), rate=SERVICE_RATE,
                           duration=SERVICE_DURATION, seed=0)
    print(f"[s] demotion drill: {len(events)} requests at the default sizes, "
          f"kernel.launch:1.0:oom:1, retry_cap=0", flush=True)
    runs = {}
    for name in ("hopper_packed", "hopper_dense"):
        kind = name.split("_")[1]
        clean = run_service(get_engine(name, device=device), events, device)
        with faults.injected("kernel.launch:1.0:oom:1", seed=1):
            run = runs[name] = run_service(get_engine(name, device=device), events, device,
                                           retry_cap=0, **FAST_BACKOFF)
        describe_service(f"{name} fault-free", clean)
        describe_service(f"{name} drill", run)
        check_recorded_calls("s", f"{name} fault-free", clean[5])
        check_recorded_calls("s", f"{name} drill", run[5])
        reqs, snap, _, counts, routing, _ = run
        check(snap["demotions"] > 0 and snap["failed"] == 0,
              f"{name} drill: {snap['demotions']} demotions, {snap['failed']} failed")
        check(counts[f"{kind}_revise_stacked"] > 0,
              f"{name} drill: the stepped rung launched {launched(counts)}")
        check(routing == 0 and clean[4] == 0, f"{name} drill routed rows on the host")
        check([verdict(r) for r in reqs] == [verdict(r) for r in clean[0]],
              f"{name} drill: verdicts differ from the fault-free replay")
    print("[s] demotion drill: demoted requests ran the stacked revise on the stepped rung's "
          "slot table; verdicts == the fault-free replay", flush=True)
    return runs


def service_chaos(device):
    """(s3): `serve` with every fault site at 5 % on `hopper_packed` at the
    default sizes, traced, beside the same replay without faults."""
    from repro_torch import faults, obs
    from repro_torch.launch.serve import serve
    from repro_torch.service import DEFAULT_VARIANTS

    kw = dict(families=list(DEFAULT_VARIANTS), rate=SERVICE_RATE, duration=SERVICE_DURATION,
              engine="hopper_packed", device=str(device),
              service_kwargs=dict(retry_cap=3, **FAST_BACKOFF))
    names = {}
    for label, recipe in (("fault-free", None), ("chaos", "all:0.05")):
        obs.REGISTRY.reset()
        run_path = os.path.join(TRACE_DIR, label, "run.json")
        try:
            svc, reqs = serve(faults_recipe=recipe, faults_seed=0, trace_out=run_path,
                              quiet=recipe is None, **kw)
        finally:
            faults.clear()
            obs.disable()
        run = obs.load_run(run_path)
        names[label] = ({s["name"] for s in run["spans"]},
                        set(run["snapshot"]["counters"]), reqs, svc.snapshot())
    _, _, clean, _ = names["fault-free"]
    spans, counters, reqs, snap = names["chaos"]
    check(all(r.done() for r in reqs), "chaos: a future was left unresolved")
    check(snap["completed"] + snap["failed"] + snap["shed"] == snap["submitted"] == len(reqs),
          f"chaos: {snap['completed']} + {snap['failed']} + {snap['shed']} != "
          f"{snap['submitted']}")
    for r, c in zip(reqs, clean):
        if r.status.value == "done":
            check(verdict(r) == verdict(c), f"chaos: request {r.id} differs from fault-free")
    for kind, got, want in (("span", spans, names["fault-free"][0]),
                            ("counter", counters, names["fault-free"][1])):
        extra = {n for n in got - want if not n.startswith(RECOVERY_NAMES)}
        check(want <= got and not extra,
              f"chaos: {kind} names missing {sorted(want - got)} or extra {sorted(extra)}")
    print(f"[s] chaos: {snap['completed']} done, {snap['failed']} failed, {snap['shed']} shed "
          f"of {snap['submitted']}; every DONE verdict == fault-free; span and counter names "
          f"== fault-free + recovery names; traces in {TRACE_DIR}", flush=True)


# ---------------------------------------------------------------------------
# (t) autotune: tuned launch schedules, and the driven paths on them
# ---------------------------------------------------------------------------

#: where phase t keeps its autotune cache (an ignored directory of the checkout)
AUTOTUNE_CACHE = os.path.join(TRACE_DIR, "autotune.json")
#: the service bucket phase t tunes besides the driven paths' buckets: the
#: frb100-40 requests' (128x64), at phase s's rows a dispatch (about 9-12)
SERVICE_BUCKET = (128, 64, 16)


def set_autotune_gate(on: bool) -> None:
    """``REPRO_TORCH_AUTOTUNE`` on or off, with the in-memory tables dropped:
    a gated run reloads phase t's cache and activates its buckets on first
    dispatch; an ungated run launches every kernel with its default."""
    from repro_torch.kernels import autotune

    autotune.reset()
    if on:
        os.environ[autotune.TUNE_ENV] = "1"
    else:
        os.environ.pop(autotune.TUNE_ENV, None)


def check_searches(device) -> None:
    """Every search phase t ran: each candidate's µs a launch and the winner
    beside the default; each candidate held bit for bit against the plain
    version on the search's workload."""
    import torch

    from repro_torch.kernels import autotune

    for key, times in sorted(autotune.SEARCHES.items()):
        kind, n_p, d_p, _, r = key.split("/")
        n_p, d_p, r = int(n_p[1:]), int(d_p[1:]), int(r[1:])
        wl = autotune._tune_workload(kind, n_p, d_p, r, device)
        want = autotune.run_candidate(kind, wl, None)
        for cfg, _ in times:
            got = autotune.run_candidate(kind, wl, cfg)
            pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
            check(all(torch.equal(g, w) for g, w in pairs),
                  f"[t] {key} {cfg.to_dict()} differs from the plain version")
        best = min(times, key=lambda ct: ct[1])
        default = autotune.default_config(kind, n_p, d_p, r)
        t_default = dict((c, t) for c, t in times).get(default)
        print(f"[t] {key}: " + ", ".join(f"{c.to_dict()} {1e6 * t:.3f} us" for c, t in times)
              + f"; winner {best[0].to_dict()} {1e6 * best[1]:.3f} us, default "
              f"{default.to_dict()}"
              + (f" {1e6 * t_default:.3f} us ({t_default / best[1]:.3f}x)" if t_default else "")
              + "; every candidate bit-identical to plain", flush=True)


def phase_autotune(device):
    """(t): tune into `AUTOTUNE_CACHE` the buckets the driven paths dispatch —
    one gated run each of phase c's `solve_many` on both Hopper engines and
    of phase e's `mac_solve` (instance `REPLAY_INSTANCE`), each bucket tuned
    on first dispatch — and the service bucket; check every search; then
    each run ungated and gated in turns (untuned, tuned, tuned, untuned):
    identical solutions and search statistics, ms per round each."""
    import torch

    from repro_torch.engines import get_engine
    from repro_torch.kernels import autotune
    from repro_torch.problems import generate

    if os.path.exists(AUTOTUNE_CACHE):
        os.remove(AUTOTUNE_CACHE)
    os.makedirs(TRACE_DIR, exist_ok=True)
    os.environ[autotune.CACHE_ENV] = AUTOTUNE_CACHE
    csps = [generate("model_rb", seed=i, device=device, **MAIN) for i in range(N_INSTANCES)]

    def solve(engine):
        sols, stats, tel, seconds, counts = run_solve(
            csps, get_engine(engine, fixpoint="fused", device=device), MAX_ASSIGNMENTS, device)
        return sols, stats, counts, seconds, tel["rounds"]

    def mac(engine):
        res, seconds, rounds, counts = run_mac([csps[REPLAY_INSTANCE]], engine, MAX_ASSIGNMENTS,
                                               device)
        return [s for s, _ in res], [st for _, st in res], counts, seconds, rounds

    runs = {f"{engine} {path}": (lambda fn=fn, engine=engine: summary(fn(engine)))
            for path, fn in (("solve_many", solve), ("mac_solve", mac))
            for engine in ("hopper_packed", "hopper_dense")}
    try:
        set_autotune_gate(True)
        t0 = time.perf_counter()
        first = {label: run() for label, run in runs.items()}
        n_first = len(autotune.SEARCHES)
        autotune.tune("packed", *SERVICE_BUCKET, device=device)
        autotune.tune("dense", *SERVICE_BUCKET, device=device)
        torch.cuda.synchronize(device)
        print(f"[t] tuned {len(autotune.SEARCHES)} buckets into {AUTOTUNE_CACHE} in "
              f"{time.perf_counter() - t0:.1f} s ({n_first} on first dispatch of the gated "
              f"runs, then the service bucket {SERVICE_BUCKET[0]}x{SERVICE_BUCKET[1]} "
              f"r{SERVICE_BUCKET[2]})", flush=True)
        check_searches(device)
        fmt = lambda xs: f"{sum(xs) / len(xs):.3f} ({', '.join(f'{x:.3f}' for x in xs)})"  # noqa: E731
        for label, run in runs.items():
            per_round = {"untuned": [], "tuned": []}
            for side in ("untuned", "tuned", "tuned", "untuned"):
                set_autotune_gate(side == "tuned")
                result, ms, rounds = run()
                check(result == first[label][0],
                      f"[t] {label}: the {side} run differs from the gated first run")
                per_round[side].append(ms)
            print(f"[t] {label} ({rounds} rounds, kernel counts {result[2]}): ms/round "
                  f"untuned {fmt(per_round['untuned'])}, tuned {fmt(per_round['tuned'])}; "
                  f"solutions and search statistics identical in every turn", flush=True)
    finally:
        set_autotune_gate(False)
        os.environ.pop(autotune.CACHE_ENV, None)


def summary(out):
    """(solutions, every `SearchStats` field but the timings, kernel counts),
    ms per round and rounds of one phase-t run."""
    sols, stats, counts, seconds, rounds = out
    result = (sols, [(stats_key(st), st.launches) for st in stats], launched(counts))
    return result, 1e3 * seconds / rounds, rounds


# ---------------------------------------------------------------------------
# (w) the sweep harness on the card
# ---------------------------------------------------------------------------

#: where phase w writes its sweep artifacts (an ignored directory)
SWEEP_DIR = os.path.join(TRACE_DIR, "sweeps")
TENSOR_ENGINES = ("einsum", "hopper_packed", "hopper_dense")
#: the seeded-deterministic columns of each mode, equal across the tensor engines
DETERMINISTIC = {
    "solve_many": ("n_instances", "n_solved", "solve_rate", "exhausted", "median_assignments",
                   "p90_assignments", "median_rounds", "median_recurrences"),
    "assignments": ("count_unit", "roots_consistent", "n_assignments", "mean_count",
                    "max_count"),
}


def sweep_specs():
    """Phase w's three specs: `smoke` on the tensor engines; a reduced
    `recurrence_density` (n 40 and 160, density 0.25 and 1.0) on the tensor
    engines and `ac3`; one `service_capacity` cell on `hopper_packed` at
    rates 4 and 16 over 2 s with 200 assignments a request."""
    from repro_torch.sweeps import SweepSpec, load_spec

    smoke = load_spec("smoke").to_doc()
    smoke["solver"]["engine"] = list(TENSOR_ENGINES)
    density = load_spec("recurrence_density").to_doc()
    density["problem"]["knobs"].update(n=[40, 160], density=[0.25, 1.0])
    density["solver"]["engine"] = ["einsum", "ac3", "hopper_packed", "hopper_dense"]
    capacity = load_spec("service_capacity").to_doc()
    capacity["service"].update(rate=[4.0, 16.0], duration=2.0, max_assignments=200)
    capacity["solver"]["engine"] = "hopper_packed"
    return [SweepSpec.from_doc(doc) for doc in (smoke, density, capacity)]


def same_across_engines(records, columns, engines=TENSOR_ENGINES):
    """Whether every cell's ``columns`` are equal across ``engines``."""
    cells = collections.defaultdict(dict)
    for rec in records:
        params = {k: v for k, v in rec["params"].items() if k != "engine"}
        cells[json.dumps(params, sort_keys=True)][rec["params"]["engine"]] = tuple(
            rec["metrics"][c] for c in columns)
    return all(len({row[e] for e in engines}) == 1 for row in cells.values()), len(cells)


def phase_sweeps(device):
    """(w): the three `sweep_specs` through `repro_torch.sweeps.run_spec` on
    the card into `SWEEP_DIR`; the single-network kernels' calls 1, 4, 16
    and 64 of the assignments cells at each shape held against their plain
    versions; the deterministic columns equal across the tensor engines;
    the report's verdicts over these records."""
    import shutil

    from repro_torch.sweeps import load_cells, report, run_spec

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    fused = [(name, kind) for name, kind, *_ in KERNELS if "_fixpoint" in name]
    records = {}
    for spec in sweep_specs():
        t0 = time.perf_counter()
        recorder = StackedCalls(fused)
        with recorder if spec.mode == "assignments" else contextlib.nullcontext():
            d = run_spec(spec, out_root=SWEEP_DIR, progress=None, device=device)
        records[spec.name] = (spec, load_cells(d / "cells.jsonl"))
        print(f"[w] {spec.name} ({spec.mode}): {len(spec.cells())} cells on "
              f"{records[spec.name][1][0]['device']} in {time.perf_counter() - t0:.1f} s -> {d}",
              flush=True)
        if spec.mode == "assignments":
            shapes = {key[:2] for key, *_ in recorder.calls}
            check(len(shapes) == 4, f"[w] recorded fused single-network calls at "
                                    f"{sorted(shapes)}")
            check_recorded_calls("w", spec.name, recorder)
        if spec.mode in DETERMINISTIC:
            same, cells = same_across_engines(records[spec.name][1], DETERMINISTIC[spec.mode])
            check(same, f"[w] {spec.name}: a deterministic column differs across "
                        f"{TENSOR_ENGINES}")
            print(f"[w] {spec.name}: {', '.join(DETERMINISTIC[spec.mode])} identical across "
                  f"{', '.join(TENSOR_ENGINES)} in all {cells} cells", flush=True)

    spec, recs = records["smoke"]
    for rec in recs:
        if rec["params"]["engine"] != "einsum":
            check(rec["metrics"]["launches_per_round"] == 1.0,
                  f"[w] smoke {rec['cell']}: {rec['metrics']['launches_per_round']} "
                  f"launches a round on a fused Hopper engine")
    spec, recs = records["recurrence_density"]
    for rec in sorted(recs, key=lambda r: (r["params"]["n"], r["params"]["density"])):
        m, p = rec["metrics"], rec["params"]
        print(f"[w] recurrence_density n={p['n']} density={p['density']} {p['engine']}: "
              f"mean {m['count_unit']} {m['mean_count']} (max {m['max_count']}), "
              f"per_assignment_ms {m['per_assignment_ms']}"
              + (f", batched {m['batched_per_assignment_ms']}"
                 if "batched_per_assignment_ms" in m else ""), flush=True)
    ac3 = [r for r in recs if r["params"]["engine"] == "ac3"]
    for engine in TENSOR_ENGINES:
        as_einsum = ac3 + [dict(r, params=dict(r["params"], engine="einsum"))
                           for r in recs if r["params"]["engine"] == engine]
        for key in ("recurrence-count", "per-assignment-time"):
            claim = next(c for c in report.CLAIMS if c.key == key)
            verdict, detail = claim.verdict(as_einsum, spec)
            print(f"[w] claim {key} on {engine}: {verdict}: {detail}", flush=True)
    spec, recs = records["service_capacity"]
    for rec in recs:
        m = rec["metrics"]
        check(m["completed"] == m["requests"] and m["unresolved"] == 0 and m["failed"] == 0,
              f"[w] service_capacity {rec['cell']}: {m['completed']}/{m['requests']} completed")
        check(m["launches"] == m["rounds"],
              f"[w] service_capacity: {m['launches']} launches in {m['rounds']} rounds")
        print(f"[w] service_capacity rate={rec['params']['rate']} hopper_packed: "
              f"{m['requests']} requests, {m['n_solved']} solved, throughput "
              f"{m['throughput_rps']} /s, p50 {m['p50_ms']} ms p95 {m['p95_ms']} ms p99 "
              f"{m['p99_ms']} ms, {m['rounds']} rounds, prepared-network cache "
              f"{m['cache']['bytes_in_use']} B", flush=True)
    claim = next(c for c in report.CLAIMS if c.key == "service-capacity")
    verdict, detail = claim.verdict(recs, spec)
    print(f"[w] claim service-capacity on hopper_packed: {verdict}: {detail}", flush=True)


# ---------------------------------------------------------------------------
# (x) the sharded path
# ---------------------------------------------------------------------------

#: x1: the reference's production CSP (n=4096, d=32; a 2 GiB packed network)
#: as a seeded model-A network built on the card (`hashed_random_csp`), 41
#: constrained neighbours a variable, 0.6 of a constraint's tuples
#: disallowed, so a search node's propagation runs 3-7 recurrences; B=32
#: search-node domains, the single-pod mesh's batch a data shard (512/16)
X_FULL = dict(n=4096, d=32, density=0.01, tightness=0.6, seed=0, batch=32)
#: x2/x3: the three variants and the two-rank run at n=1024, the same degree
X_SMALL = dict(n=1024, d=32, density=0.04, tightness=0.6, seed=0, batch=8)
#: block-kernel calls of a sharded run held against their plain versions
#: (`StackedCalls` copies their operands)
X_CHECKED_CALLS = (1, 2, 4)
#: x4: one rank's share of the production mesh: 256 of 4096 variables (16
#: model ranks), B_local 32 (single pod, 512/16) or 16 (multi-pod, 512/32)
X_RANK_ROWS = 256
X_RANK_BATCH = {"single pod": 32, "multi-pod": 16}
#: x5: a block call's rows cut to these counts, its network the same (x1's
#: call 1 for the packed block revise, x2's for the dense one)
X_ROW_COUNTS = {"packed": (1, 4, 8, 16, 32), "dense": (1, 2, 4, 8)}
X_DIR = os.path.join(TRACE_DIR, "sharded")
#: x6: the production CSP's full batch (`launch/dryrun_rtac.py`'s B=512)
X_FULL_BATCH = 512
#: x6's oracle: its first single-network calls cut to these row counts
#: (`mac_solve`'s 1-64 rows a call), each timed beside the block revise
X_ORACLE_ROWS = (1, 5, 64)
#: `distributed_ac`'s names of the X specs' sizes (torchrun refuses ``--n``, ``--d``)
DAC_OPTIONS = {"n": "n-vars", "d": "dom-size"}


def dac_args(spec) -> list:
    """``spec`` as `repro_torch.launch.distributed_ac` options."""
    return [f"--{DAC_OPTIONS.get(k, k)}={v}" for k, v in spec.items()]


def time_block(kind: str, args, kw, reps: int = 20) -> dict:
    """A block call against its plain version on the card: the largest
    difference, kernel and plain ms (CUDA events) and the bound."""
    mod = kernel_module(kind)
    fn, plain = getattr(mod, f"{kind}_revise_block"), getattr(mod, f"{kind}_revise_block_plain")
    err = max_err(fn(*args, **kw), plain(*args, **kw))
    check(err == 0, f"[x] {fn.__name__} differs from its plain version (max abs err {err})")
    return dict(max_abs_err=err, ms=timed_ms(lambda: fn(*args, **kw), reps, args[0].device),
                plain_ms=timed_ms(lambda: plain(*args, **kw), 1, args[0].device),
                bound=single_bound(kind, [args], kw))


def sharded_run(prepared, doms, kind: str):
    """One engine call with the block wrapper's count at 0 just before and
    read just after, its calls `X_CHECKED_CALLS` recorded (the network
    and mask not copied) and its collectives logged: (result, seconds,
    launches, recorder, log)."""
    import torch

    from repro_torch.parallel import comm_stats

    reset_launches()
    name = f"{kind}_revise_block"
    with StackedCalls([(name, kind)], X_CHECKED_CALLS, shared=(0, 1)) as rec, \
            comm_stats.recording() as log:
        t0 = time.perf_counter()
        res = prepared.enforce_batch(doms)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return res, seconds, getattr(kernel_module(kind), name).launches, rec, log


def check_block_calls(label: str, kind: str, rec) -> dict:
    """The recorded block calls against plain (`check_recorded_calls`),
    the first one timed first."""
    check(rec.calls, f"[x] {label}: no {kind}_revise_block call was made")
    _key, _i, args, kw = rec.calls[0]
    first = time_block(kind, args, kw)
    check_recorded_calls("x", label, rec)
    return first


def describe_gathers(log) -> str:
    """The collectives of a run, grouped by kind, result bytes and group."""
    from repro_torch.parallel import comm_stats

    counts = collections.Counter(log)
    wire = comm_stats.total_wire_bytes(comm_stats.collective_stats(log))
    return (", ".join(f"{n} {c.kind} of {c.result_bytes} B over {c.group_size} rank(s)"
                      for c, n in counts.items()) + f"; wire {wire:.0f} B in all")


def same_result(a, b) -> bool:
    import torch

    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def x_network(spec, device):
    from repro_torch.core.csp import hashed_random_csp
    from repro_torch.launch.distributed_ac import search_nodes

    csp = hashed_random_csp(spec["n"], spec["d"], spec["density"], spec["tightness"],
                            seed=spec["seed"], device=device)
    return csp, search_nodes(csp.dom.cpu().numpy(), spec["batch"], spec["seed"])


def phase_x_full(device):
    """(x1) `ShardedEngine(impl="bitpacked")` in a one-rank NCCL world on the
    production CSP; the same fixpoint on the plain block revise as oracle."""
    import torch

    from repro_torch.core.sharded import block_layout, enforce_blocks, local_revise, mask_layout
    from repro_torch.engines import get_engine
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import axis_group

    spec = X_FULL
    t0 = time.perf_counter()
    csp, doms = x_network(spec, device)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    eng = get_engine("sharded", impl="bitpacked", device=device)
    t0 = time.perf_counter()
    prepared = eng.prepare(csp)
    torch.cuda.synchronize()
    placed = time.perf_counter() - t0
    cons, mask = prepared.payload
    print(f"[x1] production CSP n={spec['n']} d={spec['d']} density={spec['density']} "
          f"tightness={spec['tightness']} seed={spec['seed']}: "
          f"{int(csp.mask.sum()) // 2} constraints, dense network "
          f"{csp.cons.numel()} B built on the card in {built:.2f} s; packed x-block "
          f"{cons.numel() * cons.element_size()} B placed in {placed:.2f} s; mesh "
          f"{dict(zip(eng.mesh.mesh_dim_names, eng.mesh.mesh.shape))} ("
          f"{torch.distributed.get_backend()}); B={spec['batch']} search nodes", flush=True)
    # the library call's operands: the float einsum variant's block (bf16,
    # 32 GiB at x1) and mask
    library = (block_layout(csp.cons, "einsum", torch.bfloat16),
               mask_layout(csp.mask, "einsum", torch.bfloat16))
    del csp
    res, seconds, launches, rec, log = sharded_run(prepared, doms, "packed")
    k = res.n_recurrences.cpu()
    print(f"[x1] k histogram {dict(sorted(collections.Counter(k.tolist()).items()))}, "
          f"{int(res.consistent.sum())} of {spec['batch']} consistent; first run "
          f"{seconds:.3f} s, packed_revise_block launches {launches}; {describe_gathers(log)}",
          flush=True)
    check(int(k.max()) >= 3, f"[x1] no domain took 3 recurrences (k max {int(k.max())})")
    check(launches == int(k.max()), f"[x1] {launches} block launches for {int(k.max())} "
                                    "recurrences")
    check(len(log) == int(k.max()) + 3, f"[x1] {len(log)} collectives")
    t0 = time.perf_counter()
    again = prepared.enforce_batch(doms)
    torch.cuda.synchronize()
    ms_rec = 1e3 * (time.perf_counter() - t0) / int(k.max())
    check(same_result(again, res), "[x1] a second run differs")

    def run():
        t0 = time.perf_counter()
        prepared.enforce_batch(doms)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(k.max())

    profiled(f"sharded bitpacked enforce_batch (x1, n={spec['n']} d={spec['d']} "
             f"B={spec['batch']}; a round is a recurrence)", run)
    group, _size, index = axis_group(eng.mesh, ("model",))
    dom = torch.as_tensor(doms, device=device)
    t0 = time.perf_counter()
    want = enforce_blocks(cons, mask, dom, torch.ones(dom.shape[:2], dtype=torch.bool,
                                                      device=device),
                          revise=local_revise("bitpacked", torch.bfloat16, plain=True),
                          group=group, x_index=index)
    torch.cuda.synchronize()
    check(same_result(res, want), "[x1] the sharded run differs from the same fixpoint on "
                                  "packed_revise_block_plain")
    print(f"[x1] dom, consistent and k bit-identical to the fixpoint on the plain block "
          f"revise ({time.perf_counter() - t0:.2f} s); {ms_rec:.3f} ms a recurrence "
          "(wall, host included)", flush=True)
    _key, _i, call, call_kw = rec.calls[0]
    x4 = phase_x_rank_share(cons, mask, call, tuple(t[:X_RANK_ROWS] for t in library))
    phase_x_rows("x1 call 1 (n=4096, d=32)", "packed", call, call_kw)
    first = check_block_calls("x1", "packed", rec)
    dom = ref.unpack_bits_ref(call[2].view(spec["batch"], spec["n"], call_kw["w"]), spec["d"])
    first["library_ms"] = check_library(
        "[x1]", library, dom, call[3].bool(),
        kernel_module("packed").packed_revise_block(*call, **call_kw))
    report("full width", "packed_revise_block call 1", first, "x1")
    del prepared, cons, mask, rec, want, call, library
    torch.cuda.empty_cache()
    return dict(launches=launches, ms_per_recurrence=ms_rec, k=k, first=first, x4=x4)


def check_library(label: str, library, dom, seed, want) -> float:
    """ms of the library call for a block revise (CUDA events): the float
    einsum variant's local revise (`core.sharded`'s ``_revise_einsum``, the
    reference's ``_local_revise``: bf16 support counts ``> 0``) on
    ``library`` (its bf16 block and bool mask), bool domains (B, n, d) and
    seeds (B, n), after holding its result against the block kernel's
    ``want`` (B, nx·d). Used nowhere on the kernel's path."""
    import torch

    from repro_torch.core.sharded import local_revise

    revise = local_revise("einsum", torch.bfloat16)
    got = revise(*library, dom, seed)
    check(torch.equal(got.reshape(want.shape), want.bool()),
          f"{label}: the einsum local revise differs from the block kernel")
    return timed_ms(lambda: revise(*library, dom, seed), 1, dom.device)


def phase_x_rank_share(cons, mask, call, library):
    """(x4) kernel 3's block call on one rank's share of the production
    mesh: the first `X_RANK_ROWS` variables' rows of x1's network against
    x1's first call's domains and seeds, cut to B_local; beside it the
    library call (the bf16 einsum local revise on the same rows)."""
    from repro_torch.kernels import ref

    d = X_FULL["d"]
    nx = X_RANK_ROWS
    out = {}
    for label, b in X_RANK_BATCH.items():
        args = (cons[:nx], mask[:nx].contiguous(), call[2][:b].contiguous(),
                call[3][:b].contiguous())
        kw = dict(d=d, w=-(-d // 32))
        out[label] = m = time_block("packed", args, kw)
        dom = ref.unpack_bits_ref(args[2].view(b, X_FULL["n"], kw["w"]), d)
        m["library_ms"] = check_library(f"[x4] {label}", library, dom, args[3].bool(),
                                        kernel_module("packed").packed_revise_block(*args, **kw))
        report(f"one rank of the {label} mesh (nx={nx} of n={X_FULL['n']}, d={d}, "
               f"B_local={b})", "packed_revise_block", m, "x4")
    return out


def phase_x_rows(label: str, kind: str, args, kw) -> dict:
    """(x5) One block call with its rows cut to each of `X_ROW_COUNTS`
    and the network the same, each against plain and timed: time that grows
    in proportion to B means each row pays for its own tests (the rows do
    not share the network entries they read); time that stays flat, that
    latency and the count of requests set it. Returns {B: ms}."""
    out = {}
    for b in X_ROW_COUNTS[kind]:
        m = time_block(kind, cut_rows(args, b), kw)
        out[b] = m["ms"]
        print(f"[x5] {label} {kind}_revise_block B={b}: kernel_ms={m['ms']:.4f} "
              f"({m['ms'] / b:.4f} a row) bound_ms={m['bound'][0]:.4f}; bit-identical to plain",
              flush=True)
    lo, hi = min(out), max(out)
    print(f"[x5] {label} {kind}_revise_block: B {lo} -> {hi} ({hi // lo}x the rows) takes "
          f"{out[hi] / out[lo]:.2f}x the time", flush=True)
    return out


def phase_x_variants(device):
    """(x2) bitpacked, u8 (kernel 6's block form) and bf16 einsum at n=1024
    on the one-rank world: identical results; kernel 6's calls against
    plain."""
    import torch

    from repro_torch.engines import get_engine

    spec = X_SMALL
    csp, doms = x_network(spec, device)
    runs, payloads = {}, {}
    for label, impl, dtype, kind in (("bitpacked", "bitpacked", torch.bfloat16, "packed"),
                                     ("einsum u8", "einsum", torch.uint8, "dense"),
                                     ("einsum bf16", "einsum", torch.bfloat16, "dense")):
        prepared = get_engine("sharded", impl=impl, dtype=dtype, device=device).prepare(csp)
        payloads[label] = prepared.payload
        res, seconds, launches, rec, log = sharded_run(prepared, doms, kind)
        k_max = int(res.n_recurrences.max())
        print(f"[x2] {label} n={spec['n']} d={spec['d']} B={spec['batch']}: k "
              f"{res.n_recurrences.tolist()}, {seconds:.3f} s ({1e3 * seconds / k_max:.3f} ms a "
              f"recurrence, first run), {kind}_revise_block launches {launches}; "
              f"{describe_gathers(log)}", flush=True)
        runs[label] = (res, launches, rec)
        del prepared
    check(runs["bitpacked"][1] > 0 and runs["einsum u8"][1] > 0 and runs["einsum bf16"][1] == 0,
          "[x2] block launches: " + str({k: v[1] for k, v in runs.items()}))
    for label in ("einsum u8", "einsum bf16"):
        check(same_result(runs[label][0], runs["bitpacked"][0]),
              f"[x2] {label} differs from bitpacked")
    print("[x2] bitpacked == einsum u8 == einsum bf16 (dom, consistent, k)", flush=True)
    check_recorded_calls("x", "x2 bitpacked", runs["bitpacked"][2])
    _key, _i, call, call_kw = runs["einsum u8"][2].calls[0]
    phase_x_rows(f"x2 call 1 (n={spec['n']}, d={spec['d']})", "dense", call, call_kw)
    b, n, d = len(call[3]), spec["n"], spec["d"]
    dom = call[2].view(b, n, call_kw["d"])[..., :d].bool()
    want = kernel_module("dense").dense_revise_block(*call, **call_kw).view(b, n, -1)[..., :d]
    lib_ms = check_library("[x2]", payloads["einsum bf16"], dom, call[3].bool(),
                           want.reshape(b, -1))
    first = check_block_calls("x2 einsum u8", "dense", runs["einsum u8"][2])
    first["library_ms"] = lib_ms
    report(f"n={spec['n']} d={spec['d']} B={spec['batch']}", "dense_revise_block call 1",
           first, "x2")
    del csp, payloads
    torch.cuda.empty_cache()
    return dict(reference=runs["bitpacked"][0], dense_launches=runs["einsum u8"][1],
                dense_first=first)


def phase_x_two_ranks(reference):
    """(x3) two processes on cuda:0 in a gloo world (a FileStore under
    `X_DIR`), n=1024 with 512 variables a rank, through
    `repro_torch.launch.distributed_ac`: results equal x2's one-rank
    bitpacked run."""
    import shutil

    import numpy as np

    shutil.rmtree(X_DIR, ignore_errors=True)
    os.makedirs(X_DIR)
    spec = X_SMALL
    out = os.path.join(X_DIR, "two_ranks.npz")
    args = [sys.executable, "-m", "repro_torch.launch.distributed_ac", "--device", "cuda",
            "--backend", "gloo", "--mesh", "1,2", "--network", "hashed", "--impl",
            "bitpacked", "--check", "none", "--store", os.path.join(X_DIR, "store"),
            "--world", "2", "--out", out, *dac_args(spec)]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen([*args, "--rank", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"[x3] rank {r} exited {p.returncode}:\n{log[-3000:]}")
    for line in logs[0].splitlines():
        if not line.startswith("[W"):
            print(f"[x3] {line}", flush=True)
    got = np.load(out)
    want = [t.cpu().numpy() for t in reference]
    check(all(np.array_equal(got[name], w) for name, w in zip(("dom", "consistent", "k"), want)),
          "[x3] the two-rank run differs from x2's one-rank bitpacked run")
    check(int(got["packed_revise_block"]) > 0, "[x3] the ranks did not launch the block kernel")
    model = [int(b) for b, g in got["gathers"] if g == 2]  # the model axis' gathers
    k_max = int(got["k"].max())
    check(len(model) == k_max, f"[x3] {len(model)} model-axis gathers in {k_max} recurrences")
    print(f"[x3] two ranks (gloo, cuda:0, 512 variables a rank) == one rank: dom, consistent "
          f"and k bit-identical; {1e3 * float(got['seconds']) / k_max:.3f} ms a recurrence "
          f"(wall); {len(model)} model-axis all-gathers of {model[0]} result B over 2 ranks; "
          f"staged through host memory: {bool(got['staged'])}", flush=True)


def phase_x_full_batch():
    """(x6) `repro_torch.launch.distributed_ac` as a one-rank NCCL world on
    the production CSP at its full batch (n=4096, d=32, B=512, bitpacked),
    held against the single-network `hopper_packed` engine (kernel 3) and
    its first block call against plain, with one profiled call; its
    ``--out`` record checked here. Returns the block kernel's launches and
    the record."""
    import numpy as np

    os.makedirs(X_DIR, exist_ok=True)
    out = os.path.join(X_DIR, "full_batch.npz")
    spec = {**X_FULL, "batch": X_FULL_BATCH}
    args = [sys.executable, "-m", "repro_torch.launch.distributed_ac", "--device", "cuda",
            "--mesh", "1,1", "--network", "hashed", "--impl", "bitpacked", "--check",
            "hopper_packed", "--check", "plain", "--out", out, *dac_args(spec)]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    run = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(run.returncode == 0, f"[x6] distributed_ac exited {run.returncode}:\n"
                               f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    for line in run.stdout.splitlines():
        print(f"[x6] {line}", flush=True)
    check("single-device results (hopper_packed) ✓" in run.stdout,
          "[x6] no hopper_packed verdict")
    check("first block call bit-identical to plain" in run.stdout, "[x6] no plain verdict")
    got = np.load(out)
    k_max = int(got["k"].max())
    launches = int(got["packed_revise_block"])
    check(k_max >= 3 and launches == k_max, f"[x6] {launches} block launches, k max {k_max}")
    check(len(got["gathers"]) == k_max + 3 and not bool(got["staged"]),
          f"[x6] {len(got['gathers'])} gathers for {k_max} recurrences, staged {got['staged']}")
    print(f"[x6] full batch B={spec['batch']} == hopper_packed, first call == plain; "
          f"{1e3 * float(got['seconds']) / k_max:.3f} ms a recurrence (wall); "
          f"{launches} packed_revise_block launches; {seconds:.1f} s with start-up", flush=True)
    return launches, got


def x6_first_calls(device, kinds=("packed", "dense")):
    """Yield, for each of ``kinds``, `hopper_{kind}` on x6's network and
    batch (x1's network at B=512) in this process: (kind, result of its
    `enforce_batch`, the single-network wrapper's launches, counted from 0
    just before and read just after, the route's numbers over the same call
    (``word_loop`` and ``spec``: the ticks of ``fixpoint.word_loop`` and
    ``fixpoint.spec_recurrences``; ``epilogue``: the word loop's epilogue
    launches), the operands and keywords of its first call, and the
    prepare's bytes: allocated before it and at its peak).
    The CSP (its 16 GiB dense network) is dropped once the last engine is
    prepared; each engine is dropped before the next is prepared, its
    first call's network kept."""
    import torch

    from repro_torch import obs
    from repro_torch.engines import get_engine
    from repro_torch.kernels import bitpack_support

    csp, doms = x_network({**X_FULL, "batch": X_FULL_BATCH}, device)
    counters = ("fixpoint.word_loop", "fixpoint.spec_recurrences")
    for i, kind in enumerate(kinds):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        prepared = get_engine(f"hopper_{kind}", device=device).prepare(csp)
        torch.cuda.synchronize()
        memory = dict(before=before, peak=torch.cuda.max_memory_allocated(device))
        if i == len(kinds) - 1:
            del csp
        name = f"{kind}_revise"
        reset_launches()
        before = [obs.REGISTRY.counter(c) for c in counters]
        with StackedCalls([(name, kind)], (1,), shared=(0, 1)) as rec:
            res = prepared.enforce_batch(doms)
            torch.cuda.synchronize()
        launches = getattr(kernel_module(kind), name).launches
        route = dict(zip(("word_loop", "spec"),
                         (obs.REGISTRY.counter(c) - v for c, v in zip(counters, before))),
                     epilogue=bitpack_support.packed_word_epilogue.launches)
        del prepared
        _key, _i, args, kw = rec.calls[0]
        del rec
        yield kind, res, launches, route, args, kw, memory
        del res, args


def cut_rows(args, b: int):
    """A single-network or block call's operands with its rows cut to ``b``."""
    return (*args[:2], args[2][:b].contiguous(), args[3][:b].contiguous())


def pair_major(args, kw):
    """A single-network call's operands with its network (n·d, n·K) permuted
    into the block revise's pair-major layout (n, n, d, K): the same call of
    kernel 3b or 6b at nx = n."""
    cons, mask, dom, seed = args
    n = mask.shape[0]
    return (cons.view(n, kw["d"], n, -1).permute(0, 2, 1, 3).contiguous(), mask, dom, seed)


def once_ms(fn, device):
    """(result, ms) of one call of ``fn`` timed with CUDA events: for plain
    versions that take seconds, far longer than their host time."""
    import torch

    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_x_oracle(device, want) -> dict:
    """(x6) Kernels 3 and 6 at the full batch, from n = 2048 the block
    revise's row groups on the single-network layout: `hopper_packed` and
    `hopper_dense` on x6's network and batch in this process
    (`x6_first_calls`), each result against x6's record ``want``, each
    wrapper launched once a billed recurrence (the packed engine takes the
    word loop: kernel 3 and its epilogue once a recurrence, in chunks, those
    launched past the fixpoint not billed; the dense one the host loop);
    each first call against its plain version and against the block revise
    on the same call in the pair-major layout (3b, 6b at nx = n), bit for
    bit, timed beside its bound; then the
    call cut to `X_ORACLE_ROWS` rows, timed beside the block revise.
    Returns {wrapper: numbers}."""
    import numpy as np
    import torch

    k_max = int(want["k"].max())
    out = {}
    for kind, res, launches, route, args, kw, memory in x6_first_calls(device):
        t0 = time.perf_counter()
        name = f"{kind}_revise"
        check(all(np.array_equal(t.cpu().numpy(), want[f])
                  for t, f in zip(res, ("dom", "consistent", "k"))),
              f"[x6] hopper_{kind} in this process differs from x6's sharded run")
        word = kind == "packed"
        check(route["word_loop"] == word and launches - route["spec"] == k_max
              and route["epilogue"] == (launches if word else 0),
              f"[x6] {launches} {name} launches ({route['spec']} past the fixpoint, "
              f"{route['epilogue']} epilogues, word loop {route['word_loop']}) for {k_max} "
              f"recurrences")
        mod = kernel_module(kind)
        fn, plain, block = (getattr(mod, name), getattr(mod, f"{name}_plain"),
                            getattr(mod, f"{name}_block"))
        got = fn(*args, **kw)
        expect, plain_ms = once_ms(lambda: plain(*args, **kw), device)
        err = max_err(got, expect)
        check(err == 0, f"[x6] {name} at B={X_FULL_BATCH}, n={X_FULL['n']} differs from its "
                        f"plain version (max abs err {err})")
        del expect
        blocked = pair_major(args, kw)
        check(torch.equal(block(*blocked, **kw), got),
              f"[x6] {name} differs from {name}_block on the pair-major network")
        m = dict(max_abs_err=err, ms=timed_ms(lambda: fn(*args, **kw), 20, device),
                 plain_ms=plain_ms, bound=single_bound(kind, [args], kw), launches=launches,
                 block_ms=timed_ms(lambda: block(*blocked, **kw), 20, device))
        report(f"hopper_{kind} oracle, call 1 of {launches} (n_p={args[3].shape[1]}, "
               f"B={X_FULL_BATCH}; {name}_block on the pair-major network: "
               f"{m['block_ms']:.4f} ms)", name, m, "x6")
        for b in X_ORACLE_ROWS:
            cut, cut_block = cut_rows(args, b), cut_rows(blocked, b)
            check(torch.equal(fn(*cut, **kw), block(*cut_block, **kw)),
                  f"[x6] {name} at B={b} differs from {name}_block")
            ms = timed_ms(lambda: fn(*cut, **kw), 20, device)
            block_ms = timed_ms(lambda: block(*cut_block, **kw), 20, device)
            m[f"ms_b{b}"], m[f"block_ms_b{b}"] = ms, block_ms
            print(f"[x6] {name} call 1 cut to B={b}: kernel_ms={ms:.4f} {name}_block "
                  f"(pair-major) {block_ms:.4f} bound_ms={single_bound(kind, [cut], kw)[0]:.4f}; "
                  f"== {name}_block", flush=True)
        print(f"[x6] hopper_{kind} == x6's sharded run: dom, consistent and k bit-identical; "
              f"{launches} {name} launches; prepare's peak {memory['peak'] / 2**30:.2f} GiB "
              f"allocated ({memory['before'] / 2**30:.2f} GiB before it); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[name] = m
        del res, args, blocked, got
    torch.cuda.empty_cache()
    return out


def phase_x(device):
    """(x): x1 and x4 at full width, x2, x3 at n=1024, in a one-rank world
    made for the phase, then x6 at the full batch in a process of its own
    and its `hopper_packed` oracle here. Returns the block routes' rows of
    the kernels line and kernel 3's numbers at the full batch."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    init_world(device)
    try:
        full = phase_x_full(device)
        small = phase_x_variants(device)
    finally:
        dist.destroy_process_group()
    phase_x_two_ranks(small["reference"])
    torch.cuda.empty_cache()
    full_batch, record = phase_x_full_batch()
    oracle = phase_x_oracle(device, record)
    rows = []
    for name, kind, line, launches, m in (
            ("packed_revise_block", "packed", "bitpack_support.py:64", full["launches"],
             full["first"]),
            ("dense_revise_block", "dense", "rtac_support.py:71", small["dense_launches"],
             small["dense_first"])):
        check(launches > 0, f"{name} was not launched on the sharded path")
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/block_revise.cuh",
            replaces=f"src/repro/kernels/{line}", launches=launches,
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound"][0], bound_by=m["bound"][1], library_ms=m["library_ms"],
            service_launches=0))
    rows[0]["full_batch_launches"] = full_batch
    return rows, oracle


# ---------------------------------------------------------------------------
# --against: this tree's stacked revises beside another tree's, in one call
# ---------------------------------------------------------------------------

#: the libraries `compare_against` loads from the other tree
COMPARED = ("packed_revise", "dense_revise")
#: turns of a same-call comparison
TURNS = ("other", "this", "this", "other")


def build_other(csrc: str) -> dict:
    """`COMPARED` built from ``csrc`` (another tree's kernel sources) with
    this tree's nvcc flags, one nvcc per source, all at once, into the
    ignored build directory; returns {library: ctypes.CDLL}."""
    import ctypes

    from repro_torch.kernels import build

    tree = hashlib.sha256(os.path.abspath(csrc).encode()).hexdigest()[:16]
    out_dir = build.BUILD_DIR / "against" / tree  # one directory a tree: a loaded
    out_dir.mkdir(parents=True, exist_ok=True)   # library is never overwritten
    procs = {}
    for name in COMPARED:
        out = out_dir / f"lib{name}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"{csrc}/{name}.cu did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def previous_block_span(rows: int, nx: int, n: int, d: int, sms: int) -> int:
    """The span the value-major block launchers (``{kind}_revise_block_launch``,
    which take it from their caller) were given: 8 from n = 2048 on, else
    the single-network rule over nx variables narrowed by 8 until a CTA's
    shared memory fits."""
    from repro_torch.kernels.autotune import single_span
    from repro_torch.kernels.launch import CTA_WARPS, SMEM_OPT_IN_LIMIT

    def smem(span):
        lanes, nwn, w = min(32, -(-span // CTA_WARPS)), -(-n // 32), -(-d // 32)
        return (4 * nwn * span + 4 * CTA_WARPS * (nwn + lanes * (nwn + w))
                + 2 * CTA_WARPS * lanes * n)

    if n >= 2048:
        return CTA_WARPS
    span = single_span(rows, nx, sms)
    while span > CTA_WARPS and smem(span) > SMEM_OPT_IN_LIMIT:
        span -= CTA_WARPS
    return span


def other_block_call(lib, kind: str, args, kw):
    """A function that runs another tree's block revise (library ``lib``) on
    ``args``, this tree's pair-major operands: through this tree's wrapper
    where ``lib`` exports this tree's block launcher (the caller routes the
    wrappers to ``lib``); else through the value-major launcher
    (``{kind}_revise_block_launch``) on the network permuted into its
    (nx·d, n·K) layout, with `previous_block_span`'s span."""
    import torch

    from repro_torch.kernels import launch

    wrapper = getattr(kernel_module(kind), f"{kind}_revise_block")
    if hasattr(lib, next(iter(launch.BLOCK[f"{kind}_revise"]))):
        return lambda: wrapper(*args, **kw)
    cons, mask, dom, seed = args
    (nx, n), d, b = mask.shape, kw["d"], dom.shape[0]
    value_major = cons.permute(0, 2, 1, 3).reshape(nx * d, -1).contiguous()
    sms = torch.cuda.get_device_properties(dom.device).multi_processor_count
    ints = [b, nx, n, d, *([kw["w"]] if kind == "packed" else []),
            previous_block_span(b, nx, n, d, sms)]
    return other_launch(lib, f"{kind}_revise_block_launch", (value_major, mask, dom, seed), ints,
                        torch.empty((b, nx * d), dtype=torch.uint8, device=dom.device))


def other_wide_call(lib, kind: str, args, kw):
    """A function that runs another tree's single-network revise (library
    ``lib``) from n = 2048 on ``args``: through this tree's wrapper where
    ``lib`` exports this tree's launcher of that route (the caller routes
    the wrappers to ``lib``); else through its single-network launcher
    (``{kind}_revise_launch``), the route it takes there."""
    import torch

    wrapper = getattr(kernel_module(kind), f"{kind}_revise")
    if hasattr(lib, f"{kind}_revise_wide_launch"):
        return lambda: wrapper(*args, **kw)
    b, n, d = args[2].shape[0], args[1].shape[0], kw["d"]
    return other_launch(lib, f"{kind}_revise_launch", args,
                        [b, n, d, *([kw["w"]] if kind == "packed" else [])],
                        torch.empty((b, n * d), dtype=torch.uint8, device=args[2].device))


def other_launch(lib, launcher: str, tensors, ints, out):
    """A function that runs ``launcher`` of another tree's library ``lib``
    (a plain C launcher: pointers, ints, the stream) on ``tensors``, then
    ``out``, and ``ints``, and returns ``out``."""
    import ctypes

    import torch

    fn = getattr(lib, launcher)
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call():
        rc = fn(*(t.data_ptr() for t in (*tensors, out)), *ints,
                torch.cuda.current_stream(out.device).cuda_stream)
        check(rc == 0, f"the other tree's {launcher} failed: cudaError {rc}")
        return out

    return call


def compare_turns(label: str, this, other, use, fmt, device) -> None:
    """``this`` and ``other`` (functions returning a tensor, the wrappers
    routed to each side's libraries by ``use``) bit for bit and timed in
    `TURNS`: one ``[vs]`` line."""
    import torch

    got, ms = {}, {"other": [], "this": []}
    for side in TURNS:
        use(side)
        fn = this if side == "this" else other
        got[side] = fn().clone()
        ms[side].append(timed_ms(fn, 20, device))
    check(torch.equal(got["this"], got["other"]), f"[vs] {label}: the two trees differ")
    ratio = sum(ms["other"]) / sum(ms["this"])
    print(f"[vs] {label}: other {fmt(ms['other'])} -> this {fmt(ms['this'])}; {ratio:.2f}x; "
          "bit-identical", flush=True)


def compare_wide(libs, use, fmt, device):
    """This tree's single-network revises from n = 2048 beside ``libs``'
    (`other_wide_call`) on x6's first calls (`x6_first_calls`: x1's network
    at B=512, every variable seeded) and on those calls cut to
    `X_ORACLE_ROWS` rows, bit for bit, in `TURNS`."""
    import torch

    use("this")
    for kind, _res, _launches, _route, args, kw, _memory in x6_first_calls(device):
        fn = getattr(kernel_module(kind), f"{kind}_revise")
        for b in (X_FULL_BATCH, *X_ORACLE_ROWS):
            cut = cut_rows(args, b)
            compare_turns(f"x6 call 1 (n={X_FULL['n']}, d={X_FULL['d']}, B={b}) {fn.__name__}",
                          lambda: fn(*cut, **kw), other_wide_call(libs[f"{kind}_revise"], kind,
                                                                  cut, kw), use, fmt, device)
        use("this")
        del args, cut
    torch.cuda.empty_cache()


def block_cases(device):
    """The block calls `compare_against` times: x1's call 1 (its network in
    the pair-major layout, its search nodes, every variable seeded), x4's
    cuts of it, and x2's dense call 1: (label, kind, args, kw) each."""
    import torch

    from repro_torch.core.sharded import block_layout, mask_layout
    from repro_torch.kernels import ref

    cases = []
    for spec, kind, impl, dtype in ((X_FULL, "packed", "bitpacked", torch.bfloat16),
                                    (X_SMALL, "dense", "einsum", torch.uint8)):
        csp, doms = x_network(spec, device)
        cons, mask = block_layout(csp.cons, impl, dtype), mask_layout(csp.mask, impl, dtype)
        del csp
        dom = torch.as_tensor(doms, device=device)
        b, n, d = dom.shape
        seed = torch.ones((b, n), dtype=torch.uint8, device=device)
        if kind == "packed":
            rows, kw = ref.pack_bits_ref(dom).reshape(b, -1).contiguous(), dict(d=d, w=-(-d // 32))
        else:
            d_p = cons.shape[-1]
            padded = torch.zeros((b, n, d_p), dtype=torch.uint8, device=device)
            padded[..., :d] = dom
            rows, kw = padded.view(b, -1), dict(d=d_p)
        label = "x1" if spec is X_FULL else "x2"
        cases.append((f"{label} call 1 (n={n}, d={d}, B={b})", kind, (cons, mask, rows, seed), kw))
        if spec is X_FULL:
            nx = X_RANK_ROWS
            for mesh, bl in X_RANK_BATCH.items():
                cases.append((f"x4 {mesh} (nx={nx}, B_local={bl})", kind,
                              (cons[:nx], mask[:nx].contiguous(), rows[:bl].contiguous(),
                               seed[:bl].contiguous()), kw))
    return cases


def compare_blocks(libs, use, fmt, device):
    """This tree's block revises beside ``libs``' (the other tree's
    libraries) on `block_cases`, bit for bit, in `TURNS`."""
    import torch

    for label, kind, args, kw in block_cases(device):
        this = lambda: getattr(kernel_module(kind), f"{kind}_revise_block")(*args, **kw)  # noqa: E731
        compare_turns(f"{label} {kind}_revise_block", this,
                      other_block_call(libs[f"{kind}_revise"], kind, args, kw), use, fmt, device)
    use("this")
    torch.cuda.empty_cache()


def compare_against(csrc: str, shapes, device, max_assignments: int = 500):
    """This tree's revise kernels against those built from ``csrc``, on one
    card in one process, the wrappers routed to either side's library, bit
    for bit and timed in `TURNS`: the stacked revises on every row mix of
    phase b at each of ``shapes`` ((label, csps)); the single-network
    revises on phase b's B=64 one-hot children, on the recorded calls of one
    phase-e `mac_solve` and on its root calls; the block revises on
    `block_cases` (`compare_blocks`). Then, in the same turns,
    stepped `solve_many` and phase e's `mac_solve` on both Hopper engines
    (identical solutions and statistics)."""
    import torch

    from repro_torch.engines import get_engine
    from repro_torch.kernels import build

    sides = {"this": {name: build.load(name) for name in COMPARED}, "other": build_other(csrc)}
    use = lambda side: build._LIBS.update(sides[side])  # noqa: E731  (what launch.launch loads)
    fmt = lambda ms: f"{sum(ms) / len(ms):.4f} ({', '.join(f'{m:.4f}' for m in ms)})"  # noqa: E731
    print(f"[vs] other = {csrc}; turns {', '.join(TURNS)}; kernel ms, mean (turns)", flush=True)
    for label, csps in shapes:
        for kind in ("packed", "dense"):
            rev = getattr(kernel_module(kind), f"{kind}_revise_stacked")
            for mix, tables, idx, rows, seed, (_, d_p) in revise_mixes(csps, device, kind):
                args, kw = (*tables, idx, rows, seed), kernel_kw(kind, d_p)
                got, ms = {}, {"other": [], "this": []}
                for side in TURNS:
                    use(side)
                    got[side] = rev(*args, **kw)
                    ms[side].append(timed_ms(lambda: rev(*args, **kw), 20, device))
                err = max_err(got["this"], got["other"])
                check(err == 0, f"[vs] {label} {kind} mix={mix}: the two trees differ")
                ratio = sum(ms["other"]) / sum(ms["this"])
                print(f"[vs] {label} {rev.__name__} mix={mix}: other {fmt(ms['other'])} -> "
                      f"this {fmt(ms['this'])}; {ratio:.2f}x; bit-identical", flush=True)
    csps = shapes[0][1]
    n = csps[0].dom.shape[0]
    for kind in ("packed", "dense"):
        fn = getattr(kernel_module(kind), f"{kind}_revise")
        use("this")
        calls, kw = record_single_calls(device, kind)
        roots = root_calls(calls, n)
        cases = {f"B={CHILD_ROWS} one-hot": [child_inputs(csps[0], device, kind)[0]] * REPLAY_CHUNK,
                 f"replay ({len(calls)} calls)": calls}
        if roots:
            cases[f"root calls ({len(roots)})"] = roots * (REPLAY_CHUNK // len(roots))
        for case, case_calls in cases.items():
            got, ms = {}, {"other": [], "this": []}
            for side in TURNS:
                use(side)
                got[side] = [fn(*c, **kw) for c in case_calls]
                ms[side].append(1e3 * replay_ms(fn, case_calls, kw, device))
            check(all(torch.equal(a, b) for a, b in zip(got["this"], got["other"])),
                  f"[vs] {fn.__name__} {case}: the two trees differ")
            ratio = sum(ms["other"]) / sum(ms["this"])
            print(f"[vs] {fn.__name__} {case}: us/launch other {fmt(ms['other'])} -> this "
                  f"{fmt(ms['this'])}; {ratio:.2f}x; bit-identical", flush=True)
    compare_blocks(sides["other"], use, fmt, device)
    compare_wide(sides["other"], use, fmt, device)
    for engine in ("hopper_packed", "hopper_dense"):
        runs, per_round = {}, {"other": [], "this": []}
        for side in TURNS:
            use(side)
            runs[side] = run_solve(csps, get_engine(engine, fixpoint="stepped", device=device),
                                   max_assignments, device)
            per_round[side].append(1e3 * runs[side][3] / runs[side][2]["rounds"])
        compare_runs(f"[vs] {engine} stepped", csps, runs["this"], runs["other"])
        print(f"[vs] {engine} stepped solve_many (max_assignments={max_assignments}, "
              f"{runs['this'][2]['rounds']} rounds, {runs['this'][2]['launches']} launches) "
              f"ms/round: other {fmt(per_round['other'])} -> this {fmt(per_round['this'])}; "
              f"identical solutions and statistics", flush=True)
    mac_csps = mac_instances(device)
    for engine in ("hopper_packed", "hopper_dense"):
        runs, per_round = {}, {"other": [], "this": []}
        for side in TURNS:
            use(side)
            out, seconds, rounds, counts = run_mac(mac_csps, engine, MAX_ASSIGNMENTS, device)
            runs[side] = [(sol, stats_key(st)) for sol, st in out]
            per_round[side].append(1e3 * seconds / rounds)
        check(runs["this"] == runs["other"], f"[vs] {engine} mac_solve: the two trees differ")
        print(f"[vs] {engine} mac_solve ({len(mac_csps)} instances, max_assignments="
              f"{MAX_ASSIGNMENTS}, {rounds} rounds, kernel counts {launched(counts)}) ms/round: "
              f"other {fmt(per_round['other'])} -> this {fmt(per_round['this'])}; identical "
              f"solutions and statistics", flush=True)
    use("this")


# ---------------------------------------------------------------------------
# --split: kernel 1 with its rows split over thread-block clusters
# ---------------------------------------------------------------------------

#: the split sweep's shapes: (label, graph order, colours, rows a launch);
#: the colouring cell's shape last, two smaller dense colourings between it
#: and rb100-40 (`MAIN`, n_p = 104, timed at `SPLIT_RB_ROWS`)
SPLIT_COLOURINGS = (("G(250, 0.5) k=28", 250, 28, (1, 2, 32)),
                    ("G(500, 0.5) k=48", 500, 48, (1, 2, 32)),
                    ("dsjc G(1000, 0.5) k=83", 1000, 83, (1, 2, 8, 32)))
SPLIT_RB_ROWS = (1, 2, 32, 1024)
#: the CTAs a row the sweep times (1: unsplit)
SPLIT_CTAS = (1, 2, 4, 8)


def colouring_rows(n: int, k: int, rows: int, device):
    """Kernel 1's operands at a colouring shape: ``rows`` search nodes
    (`_search_row` of tests/test_torch_coloring_gpu.py) of ``rows`` graphs
    G(n, 0.5) with ``k`` colours, one slot each, the slots in reverse."""
    import importlib.util

    import numpy as np
    import torch

    from repro_torch.core import coloring_csp
    from repro_torch.core.engine import pad_changed, pad_dom
    from repro_torch.engines import get_engine
    from repro_torch.kernels import ops

    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "coloring_gpu_rows", os.path.join(ROOT, "tests", "test_torch_coloring_gpu.py"))
    rows_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rows_mod)
    adjs = [rows_mod._adjacency(100 + s, n, 0.5) for s in range(rows)]
    eng = get_engine("hopper_packed", device=device)
    cons, mask = eng.prepare_many([lambda a=a: coloring_csp(a, k, device=device)
                                   for a in adjs]).payload
    n_p, d_p, w = eng._dims(n, k)
    rng = np.random.default_rng(5)
    doms, seeds = zip(*(rows_mod._search_row(a, rng, k) for a in reversed(adjs)))
    dom_p = pad_dom(torch.stack(doms).to(device), n_p, d_p)
    words = ops.pack_words(dom_p).view(rows, -1).contiguous()
    seed = pad_changed(torch.stack(seeds).to(device), n, n_p).to(torch.uint8).contiguous()
    idx = torch.arange(rows - 1, -1, -1, dtype=torch.int32, device=device)
    return (cons, mask, idx, words, seed), dict(d=d_p, w=w)


def split_case(label: str, args, kw, device) -> dict:
    """Kernel 1 on one launch's operands at every count of CTAs a row
    (`SPLIT_CTAS`) and as `launch.fixpoint_split` picks, each bit for bit
    its plain version, timed; prints one ``[split]`` line."""
    from repro_torch.kernels import bitpack_support as bs, launch

    r, n = args[4].shape
    want = bs.packed_fixpoint_stacked_plain(*args, **kw)
    pick = launch.fixpoint_split(r, n, launch.sm_count(device))
    ms = {}
    for c in SPLIT_CTAS:
        err = max_err(bs.packed_fixpoint_stacked(*args, **kw, split=c), want)
        check(err == 0, f"[split] {label} R={r} c={c}: kernel 1 differs from plain ({err})")
        ms[c] = timed_ms(lambda: bs.packed_fixpoint_stacked(*args, **kw, split=c), 10, device)
    err = max_err(bs.packed_fixpoint_stacked(*args, **kw), want)
    check(err == 0, f"[split] {label} R={r}: kernel 1 as the rule picks differs from plain")
    best = min(ms, key=ms.get)
    print(f"[split] {label} n_p={n} d_p={kw['d']} W={kw['w']} R={r}: kernel ms "
          + ", ".join(f"c={c} {m:.4f}" for c, m in ms.items())
          + f"; fastest c={best} (x{ms[1] / ms[best]:.2f} over c=1); the rule picks c={pick}; "
          f"k max {int(want[2].max())}, {int(want[1].sum())} of {r} consistent; "
          "bit-identical to plain", flush=True)
    return dict(label=label, n=n, d=kw["d"], w=kw["w"], rows=r, ms=ms, rule=pick)


def split_sweep(device) -> list:
    """Kernel 1 alone, a CTA a row and each row over a cluster of 2, 4 and 8
    CTAs (`split_case`): rb100-40's phase b rows (7 one-hot : 1 root, 32
    tables) at `SPLIT_RB_ROWS` rows, then `SPLIT_COLOURINGS`' search nodes.
    The data behind `launch.SPLIT_MIN_N` and the rule's cap."""
    import torch

    from repro_torch.kernels import build, launch
    from repro_torch.problems import generate

    build.build(["packed_fixpoint"], force=True)
    for kernel, report in ptxas_report(build.LOGS["packed_fixpoint"]):
        print(f"[split] ptxas {kernel}: {report}", flush=True)
    sms = launch.sm_count(device)
    print(f"[split] {sms} SMs; SPLIT_MIN_N={launch.SPLIT_MIN_N}", flush=True)
    out = []
    csps = [generate("model_rb", seed=i, device=device, **MAIN) for i in range(N_INSTANCES)]
    for rows in SPLIT_RB_ROWS:
        tables, idx, words, seed, _, (_, d_p) = kernel_inputs(csps, rows, 7, device, "packed")
        out.append(split_case("rb100-40", (*tables, idx, words, seed), kernel_kw("packed", d_p),
                              device))
    del csps, tables
    for label, n, k, cuts in SPLIT_COLOURINGS:
        args, kw = colouring_rows(n, k, max(cuts), device)
        for rows in cuts:
            cut = (*args[:2], args[2][-rows:].contiguous(), args[3][-rows:].contiguous(),
                   args[4][-rows:].contiguous())
            out.append(split_case(label, cut, kw, device))
        del args, cut
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    against, split = None, False
    if argv == ["--split"]:
        split = True
    elif argv:
        if len(argv) != 2 or argv[0] != "--against":
            print("usage: chip_smoke.py [--against OTHER_CSRC_DIR | --split]", file=sys.stderr)
            return 2
        against = argv[1]
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    device = torch.device("cuda")
    t_start = time.perf_counter()
    try:
        from repro_torch.kernels import build
        from repro_torch.problems import generate

        card = gpu_name_and_limit()
        print(f"[a] device {torch.cuda.get_device_name(0)} ({card}); torch "
              f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
        if split:
            print(json.dumps({"split": split_sweep(device), "card": card}), flush=True)
            print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
            return 0
        t0 = time.perf_counter()
        per_source = build.build(force=True)
        print(f"[a] built {sorted(per_source)} in {time.perf_counter() - t0:.2f} s "
              f"(per source: {', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")
        for name, log in build.LOGS.items():
            for kernel, report in ptxas_report(log):
                print(f"[a] {name} {kernel}: {report}")

        shapes = [
            ("main n_p=104 d_p=40 W=2",
             [generate("model_rb", seed=i, device=device, **MAIN) for i in range(N_INSTANCES)]),
            ("density-1 n_p=160 d_p=16 W=1",
             [generate("random_binary", seed=i, device=device, n=160, d=10, density=1.0)
              for i in range(N_INSTANCES)]),
        ]
        if against is not None:
            compare_against(against, shapes, device)
            print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
            return 0
        stamp = lambda phase: print(f"[t] {time.perf_counter() - t_start:.1f} s: {phase}",  # noqa: E731
                                    flush=True)
        main_csps = shapes[0][1]
        measured = {}
        for kind in ("packed", "dense"):
            stamp(f"phase b, {kind} stacked kernels")
            measured.update(check_kernels(main_csps, shapes[0][0], device, kind))
            check_kernels(shapes[1][1], shapes[1][0], device, kind)
        stamp("phase b, single-network kernels")
        check_single_kernels(main_csps[0], f"main n_p=104 d_p=40 B={CHILD_ROWS} one network",
                             device)
        stamp("phase b, the word loop's epilogue")
        check_word_epilogue(device)
        floor_ms = launch_floor_ms(device)
        print(f"[b] launch floor: {1e3 * floor_ms:.3f} us a launch (torch.cuda._sleep(0), "
              f"{REPLAY_CHUNK} back to back on the same stream)", flush=True)
        for kind in ("packed", "dense"):
            stamp(f"phase b, {kind} replay")
            measured[f"{kind}_revise"] = check_replay(device, kind, floor_ms,
                                                      main_csps[0].dom.shape[0])
        del main_csps, shapes

        stamp("phases c-e")
        run_f, run_s = main_path(device)
        run_df, run_ds = dense_path(device, run_f)
        parity_einsum(device)
        macs = mac_path(device)
        stamp("phase s, the service")
        service = {"replay": service_replay(device), "drill": service_drill(device)}
        service_chaos(device)
        stamp("phase t, autotune")
        phase_autotune(device)
        stamp("phase w, sweeps")
        phase_sweeps(device)
        stamp("phase x, the sharded path")
        t_x = time.perf_counter()
        sharded_rows, oracle = phase_x(device)
        print(f"[x] phase x took {time.perf_counter() - t_x:.1f} s", flush=True)
        for name in ("hopper_packed", "hopper_dense"):
            stamp(f"phase p, {name}")
            for fixpoint in ("fused", "stepped"):
                profile_main_path(device, name, fixpoint)
            profile_mac(device, name)
            profile_service(device, name)

        counts = {"packed fused": run_f[4], "packed stepped": run_s[4],
                  "dense fused": run_df[4], "dense stepped": run_ds[4],
                  "mac_solve hopper_packed stepped": macs["hopper_packed stepped"][1],
                  "mac_solve hopper_dense stepped": macs["hopper_dense stepped"][1]}
        service_counts = {f"{part} {name}": run[3]
                          for part, runs in service.items() for name, run in runs.items()}
        kernels = []
        for name, kind, line, run, service_run in KERNELS:
            m = measured[name]
            kernels.append(dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{name.replace('_stacked', '')}.cu",
                replaces=f"src/repro/kernels/{line}",
                launches=counts[run][name], max_abs_err=m["max_abs_err"], ms=m["ms"],
                mac_solve_launches=macs[f"hopper_{kind} fused"][1][name],
                plain_ms=m["plain_ms"], bound_ms=m["bound"][0], bound_by=m["bound"][1],
                library_ms=None,
                service_launches=service_counts[service_run][name] if service_run else 0,
            ))
            check(kernels[-1]["launches"] > 0, f"{name} was not launched on its path ({run})")
            check(service_run is None or kernels[-1]["service_launches"] > 0,
                  f"{name} was not launched on the service path ({service_run})")
            if name in oracle:  # x6: the oracle's call 1 at n=4096, B=512
                m = oracle[name]
                kernels[-1].update(
                    full_batch_launches=m["launches"], full_batch_max_abs_err=m["max_abs_err"],
                    full_batch_ms=m["ms"], full_batch_plain_ms=m["plain_ms"],
                    full_batch_bound_ms=m["bound"][0], full_batch_block_ms=m["block_ms"])
        kernels += sharded_rows
        print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
