#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

(a) build   — compile every kernel source (`kernels/csrc/*.cu`) for sm_90a,
              all nvcc processes at once; print the seconds, ptxas' register
              and spill report, and the card's name and power limit.
(b) kernels — hold each kernel against its plain PyTorch version, bit for bit,
              on the card: at the main path's shape (n_p=104, d_p=40, W=2;
              1,024 rows over 32 packed tables of model_rb n=100 networks) and
              at one W=1 dense-mask shape (random_binary n=160, d=10,
              density 1.0). Time kernel and plain version with CUDA events
              and compute the least time the card could take (bound).
(c) main path — `solve_many` on 32 model_rb instances (seeds 0-31, n=100,
              alpha=0.8, r=0.7, hardness=0.9, so d=40) with ``max_assignments``
              per instance, on `hopper_packed` fused, then stepped: identical
              solutions and search statistics, every solution checked, the
              fused kernel launched once per round.
(d) parity  — the same workload at n=30 on `einsum` and on `hopper_packed`.
(p) profile — one fused `solve_many` under `torch.profiler`: device busy
              share and the kernels that take the device's time.

Prints a ``{"kernels": [...]}`` JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits 2
without printing a result when no CUDA device is present or when run outside
a checkout of the repository.
"""

from __future__ import annotations

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


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def timed_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# (b) kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(csps, n_rows: int, seed: int, device):
    """Rows as the main path gives them: a root domain with one assignment
    applied (one-hot seed) for 7 rows in 8, an all-changed root row for the
    rest, each routed to a random table slot."""
    import numpy as np
    import torch

    from repro_torch.core.engine import pad_dom
    from repro_torch.engines import get_engine
    from repro_torch.kernels import ops, ref

    eng = get_engine("hopper_packed", device=device)
    tables, (n_p, d_p, w) = eng.prepare_many(csps).payload
    n, d = csps[0].dom.shape
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, len(csps), n_rows), dtype=torch.int32, device=device)
    var = rng.integers(0, n, n_rows)
    var[rng.random(n_rows) < 0.125] = -1
    var = torch.as_tensor(var, device=device)
    val = torch.as_tensor(rng.integers(0, d, n_rows), device=device)
    doms = torch.stack([c.dom for c in csps])[idx.long()]
    dom_p = ops.assign_padded_rows(pad_dom(doms, n_p, d_p), var, val)
    words = ref.pack_bits_ref(dom_p).reshape(n_rows, n_p * w).contiguous()
    seed_u8 = ops._padded_seed(var, n, n_p).to(torch.uint8).contiguous()
    return tables, idx, words, seed_u8, (n_p, d_p, w)


def work_bound(mask, idx, seeds, d: int, w: int, out_bytes: int):
    """(bound_ms, bound_by, bytes, word_ands) of revise sweeps with these
    ``seeds``: each needed input byte read once — the constrained (n·d, W)
    column slice of every distinct (network, seeded y), those columns' mask
    entries, the row domains, seeds and slots — each output byte written
    once; one word AND per constrained (x, a, seeded y, word)."""
    import torch

    r, n = seeds[0].shape
    slots = idx.long()
    mask_g = mask[slots].bool()
    touched = torch.zeros((mask.shape[0], n), dtype=torch.bool, device=mask.device)
    ands = 0
    for seed in seeds:
        for s in slots.unique():
            touched[s] |= seed[slots == s].any(dim=0)
        ands += int((mask_g & seed[:, None, :]).sum()) * d * w
    col_x = int((mask.bool().sum(dim=1) * touched).sum())
    nbytes = col_x * d * w * 4 + int(touched.sum()) * n + r * (n * w * 4 + n + 4) + out_bytes
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ands / ALU_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ands


def check_kernels(csps, label: str, device, reps: int = 5):
    """Both kernels vs their plain versions on one shape; returns per-kernel
    measurements."""
    import torch

    from repro_torch.kernels import bitpack_support as bs

    tables, idx, words, seed, (n_p, d_p, w) = kernel_inputs(csps, N_ROWS, 7, device)
    cons_t, mask_t = tables
    args = (cons_t, mask_t, idx, words, seed)
    out = {}

    got = bs.packed_fixpoint_stacked(*args, d=d_p, w=w)
    seeds = []
    want = bs.packed_fixpoint_stacked_plain(*args, d=d_p, w=w, seeds_out=seeds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = max(int((g.long() - e.long()).abs().max()) for g, e in zip(got, want))
    check(err == 0, f"{label}: packed_fixpoint_stacked differs from its plain version "
                    f"(max abs err {err})")
    r = N_ROWS
    bound = work_bound(mask_t, idx, seeds, d_p, w, out_bytes=r * (n_p * d_p + 1 + 4))
    out["packed_fixpoint_stacked"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: bs.packed_fixpoint_stacked(*args, d=d_p, w=w), reps, device),
        plain_ms=timed_ms(lambda: bs.packed_fixpoint_stacked_plain(*args, d=d_p, w=w), 2, device),
        bound=bound, sweeps=len(seeds), k_max=int(want[2].max()),
    )

    got = bs.packed_revise_stacked(*args, d=d_p, w=w)
    want = bs.packed_revise_stacked_plain(*args, d=d_p, w=w)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"{label}: packed_revise_stacked differs from its plain version "
                    f"(max abs err {err})")
    bound = work_bound(mask_t, idx, [seed.bool()], d_p, w, out_bytes=r * n_p * d_p)
    out["packed_revise_stacked"] = dict(
        max_abs_err=err,
        ms=timed_ms(lambda: bs.packed_revise_stacked(*args, d=d_p, w=w), 4 * reps, device),
        plain_ms=timed_ms(lambda: bs.packed_revise_stacked_plain(*args, d=d_p, w=w), 2, device),
        bound=bound,
    )
    for name, m in out.items():
        print(f"[b] {label} {name}: bit-identical to plain; kernel_ms={m['ms']:.4f} "
              f"plain_ms={m['plain_ms']:.4f} bound_ms={m['bound'][0]:.4f} "
              f"(by {m['bound'][1]}: {m['bound'][2]} B, {m['bound'][3]} word ANDs)"
              + (f" sweeps={m['sweeps']} k_max={m['k_max']}" if "sweeps" in m else ""),
              flush=True)
    return out


# ---------------------------------------------------------------------------
# (c)/(d) the main path
# ---------------------------------------------------------------------------


def stats_key(st):
    """Every SearchStats field except the timings and the launch bill."""
    return (st.n_assignments, st.n_backtracks, st.recurrences, st.revisions,
            st.exhausted, st.rounds, st.rows, st.members, st.cancelled_members,
            st.quarantined)


def run_solve(csps, engine, max_assignments: int, device):
    import torch

    from repro_torch.core import solve_many
    from repro_torch.kernels import bitpack_support as bs

    bs.reset_launches()
    tel = {}
    t0 = time.perf_counter()
    sols, stats = solve_many(csps, engine=engine, max_assignments=max_assignments,
                             telemetry=tel)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {"packed_fixpoint_stacked": bs.packed_fixpoint_stacked.launches,
                "packed_revise_stacked": bs.packed_revise_stacked.launches}
    return sols, stats, tel, seconds, launches


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
          f"launches={tel['launches']} kernel counts={launches} solved={solved} "
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
    tel_f, launches_f = run_f[2], run_f[4]
    check(launches_f["packed_fixpoint_stacked"] == tel_f["rounds"],
          f"fused kernel launched {launches_f['packed_fixpoint_stacked']} times in "
          f"{tel_f['rounds']} rounds")
    check(launches_f["packed_revise_stacked"] == 0, "the fused path launched the revise kernel")
    check(run_s[4]["packed_revise_stacked"] > 0, "the stepped path never launched its kernel")
    check(run_s[4]["packed_fixpoint_stacked"] == 0, "the stepped path launched the fused kernel")
    print("[c] fused == stepped: solutions and search statistics identical; every "
          "solution checks; fused launches == rounds", flush=True)
    return run_f, run_s


def profile_main_path(device, max_assignments: int = 500, n_instances: int = N_INSTANCES,
                      spec=MAIN):
    """Where a fused round's time goes: `torch.profiler` over one fused
    `solve_many` (a smaller budget keeps the trace short). Prints the wall
    time, the summed device time of every kernel and copy, the device busy
    share, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engines import get_engine
    from repro_torch.problems import generate

    csps = [generate("model_rb", seed=i, device=device, **spec) for i in range(n_instances)]
    eng = get_engine("hopper_packed", fixpoint="fused", device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = run_solve(csps, eng, max_assignments, device)
    wall_ms = 1e3 * run[3]
    device_time = lambda e: e.self_device_time_total / 1e3  # us -> ms
    # device-side events only (kernels, copies): a CPU op's entry repeats the
    # device time of the kernels it launched
    on_device = sorted((e for e in prof.key_averages()
                        if e.device_type != torch.autograd.DeviceType.CPU and device_time(e) > 0),
                       key=device_time, reverse=True)
    busy_ms = sum(device_time(e) for e in on_device)
    rounds = run[2]["rounds"]
    if not on_device:
        print("[p] profiler recorded no device time: device busy share not measured")
        return
    print(f"[p] profiled fused solve_many (max_assignments={max_assignments}): wall "
          f"{wall_ms:.1f} ms over {rounds} rounds ({wall_ms / rounds:.3f} ms/round, profiler "
          f"on); device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of wall")
    for e in on_device[:8]:
        print(f"[p]   {device_time(e):9.2f} ms  {e.count:6d} calls  {e.key[:90]}")


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


def main() -> int:
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
        t0 = time.perf_counter()
        per_source = build.build(force=True)
        print(f"[a] built {sorted(per_source)} in {time.perf_counter() - t0:.2f} s "
              f"(per source: {', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")
        for name, log in build.LOGS.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[a] {name}: {line.strip()}")

        main_csps = [generate("model_rb", seed=i, device=device, **MAIN)
                     for i in range(N_INSTANCES)]
        dense_csps = [generate("random_binary", seed=i, device=device, n=160, d=10,
                               density=1.0) for i in range(N_INSTANCES)]
        measured = check_kernels(main_csps, "main n_p=104 d_p=40 W=2", device)
        check_kernels(dense_csps, "dense n_p=160 d_p=16 W=1", device)
        del main_csps, dense_csps

        run_f, run_s = main_path(device)
        parity_einsum(device)
        profile_main_path(device)

        sources = {"packed_fixpoint_stacked": ("packed_fixpoint", "295", run_f),
                   "packed_revise_stacked": ("packed_revise", "129", run_s)}
        kernels = []
        for name, (src_name, line, run) in sources.items():
            m = measured[name]
            kernels.append(dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{src_name}.cu",
                replaces=f"src/repro/kernels/bitpack_support.py:{line}",
                launches=run[4][name], max_abs_err=m["max_abs_err"], ms=m["ms"],
                plain_ms=m["plain_ms"], bound_ms=m["bound"][0], bound_by=m["bound"][1],
                library_ms=None,
            ))
            check(kernels[-1]["launches"] > 0, f"{name} was not launched on the main path")
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
    sys.exit(main())
