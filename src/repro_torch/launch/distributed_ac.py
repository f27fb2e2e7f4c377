"""Distributed RTAC: shard the constraint tensor over a (data, model) mesh.

The counterpart of ``examples/distributed_ac.py``. Every rank runs this
program: the network's x-rows are sharded over ``model``, a batch of
candidate domains (search nodes, each with one variable assigned) over
``data``. Every rank gets the whole batch back and holds it against the
oracles named below; a mismatch on any rank makes that rank exit non-zero.

    torchrun --nproc-per-node 8 -m repro_torch.launch.distributed_ac --device cpu

The reference's production CSP at its full batch on four cards (one card a
rank, NCCL), held against one card's run of the same command:

    torchrun --nproc-per-node 1 -m repro_torch.launch.distributed_ac \\
        --network hashed --n-vars 4096 --dom-size 32 --density 0.01 \\
        --tightness 0.6 --batch 512 --impl bitpacked --mesh 1,1 --check none \\
        --out one.npz
    torchrun --nproc-per-node 4 -m repro_torch.launch.distributed_ac \\
        --network hashed --n-vars 4096 --dom-size 32 --density 0.01 \\
        --tightness 0.6 --batch 512 --impl bitpacked --mesh 1,4 \\
        --check hopper_packed --check plain --against one.npz

(``--mesh 2,2`` for two data shards of two model ranks; ``--impl einsum
--dtype uint8`` for the dense block revise.)

Oracles: ``--check`` (repeatable) ``einsum`` (the default: rank 0 against
the single-device einsum engine, which holds the network in float, so for
small n), ``hopper_packed`` (rank 0 against the single-network packed
engine, kernel 3, which does not go through the block route), ``plain``
(every rank's first block call against its plain version), or ``none``;
``--against FILE`` holds every rank's results against a saved ``--out``.

Without torchrun, ``--store FILE --rank R --world W`` joins a world through
a `FileStore` (no port); with neither, the world is one rank. ``--network
hashed`` builds the network on the device block by block
(`hashed_random_csp`), for sizes whose numpy draws would not fit the host.
``--out FILE`` has rank 0 save the results (dom, consistent, k), the
slowest rank's seconds (also with the batch already on the device),
whether any gather was staged through host memory, the per-recurrence
collective record and the block launches as an .npz.

Rank 0 prints the slowest rank's wall time and ms a recurrence beside every
rank's, from host domains and again with the batch already on the device
(the same call without its upload); each rank's local revise on its first
call's operands (the block kernel with the domains' packing before it and
the unpacking after it; CUDA events) and all-gather times (CUDA events, each
recurrence) on a card; the collectives against `dryrun_rtac.plan` on this
mesh; and whether the gathers of each axis were staged through host
memory, which a CUDA world of several NCCL ranks must not. On a card, one
more call runs with rank 0 under `torch.profiler`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.csp import hashed_random_csp, random_csp
from repro_torch.core.sharded import batch_shard, local_revise, variant
from repro_torch.device import resolve_device
from repro_torch.engines import get_engine
from repro_torch.kernels import bitpack_support, rtac_support
from repro_torch.launch import dryrun_rtac
from repro_torch.launch.mesh import axis_group, init_world, make_mesh
from repro_torch.parallel import comm_stats

DTYPES = {"bfloat16": torch.bfloat16, "uint8": torch.uint8}
#: variant -> `dryrun_rtac.VARIANTS` key
PLAN_VARIANTS = {"bitpacked": "bitpacked", "u8": "einsum-u8", "float": "einsum-bf16"}
CHECKS = ("einsum", "hopper_packed", "plain", "none")


def search_nodes(dom: np.ndarray, batch: int, seed: int = 0) -> np.ndarray:
    """``batch`` copies of the root domain (n, d), each with one random
    variable assigned one random value — B search nodes, as the reference's
    example makes them."""
    n, d = dom.shape
    rng = np.random.default_rng(seed)
    doms = np.repeat(dom[None], batch, axis=0)
    for i in range(batch):
        var, keep = rng.integers(n), rng.integers(d)
        doms[i, var, :] = False
        doms[i, var, keep] = True
    return doms


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--mesh", default="2,4", help="data,model extents")
    # torchrun (torch 2.11) reads ``--n`` and ``--d`` after the module as
    # abbreviations of its own options and refuses them: these two are named in full
    ap.add_argument("--n-vars", dest="n", type=int, default=64)
    ap.add_argument("--dom-size", dest="d", type=int, default=16)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--tightness", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--network", choices=("random", "hashed"), default="random")
    ap.add_argument("--impl", choices=("einsum", "bitpacked"), default="einsum")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16",
                    help="the einsum variant's block type (uint8: the dense block revise)")
    ap.add_argument("--check", choices=CHECKS, action="append",
                    help="an oracle (repeatable; default einsum)")
    ap.add_argument("--against", default=None, help="an --out .npz to hold every rank against")
    ap.add_argument("--store", default=None, help="a FileStore path (with --rank, --world)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    args.check = set(args.check or ["einsum"]) - {"none"}
    return args


def block_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn()`` (CUDA events, after one warm-up call)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_busy_ms(prof) -> float:
    """ms in which the device ran a kernel or a copy on any stream: the union
    of the device events' intervals, so work that overlaps (a compute
    stream beside the NCCL stream) counts once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type != torch.autograd.DeviceType.CPU and not e.is_user_annotation)
    busy_us, reached = 0.0, float("-inf")
    for start, end in spans:
        if end > reached:
            busy_us += end - max(start, reached)
            reached = end
    return busy_us / 1e3


def profile_call(run, say) -> None:
    """One ``run()`` under `torch.profiler`: the wall time, the device busy
    share (`device_busy_ms` over the wall) beside the kernels' and copies'
    device times summed, the block kernel's and the NCCL kernels' shares,
    and the kernels that take the most device time. User annotations
    (``nccl:_all_gather_base`` on the device's timeline repeats its NCCL
    kernel) are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device_ms = lambda e: e.self_device_time_total / 1e3  # us -> ms
    on_device = sorted((e for e in prof.key_averages()
                        if e.device_type != torch.autograd.DeviceType.CPU
                        and not e.is_user_annotation and device_ms(e) > 0),
                       key=device_ms, reverse=True)
    if not on_device:
        say(f"profile: wall {wall_ms:.3f} ms; no device time recorded: busy share not measured")
        return
    share = lambda word: sum(device_ms(e) for e in on_device if word in e.key)
    busy, summed = device_busy_ms(prof), sum(device_ms(e) for e in on_device)
    block, nccl = share("block_revise"), share("ncclDevKernel")
    say(f"profile (rank 0, one enforce_batch): wall {wall_ms:.3f} ms; device busy "
        f"{busy:.3f} ms = {100 * busy / wall_ms:.1f}% of wall (kernels and copies summed: "
        f"{summed:.3f} ms = {100 * summed / wall_ms:.1f}%); block kernel {block:.3f} ms = "
        f"{100 * block / wall_ms:.1f}%; NCCL kernels {nccl:.3f} ms = "
        f"{100 * nccl / wall_ms:.1f}%", flush=True)
    for e in on_device[:8]:
        say(f"profile:   {device_ms(e):9.3f} ms ({100 * device_ms(e) / wall_ms:5.1f}% of wall) "
            f"{e.count:6d} calls  {e.key[:90]}", flush=True)


def check_collectives(log, k_local: int, plan: dict, n_data: int) -> list:
    """Problems with this rank's collectives: ``k_local`` model-axis
    all-gathers (one a recurrence of its data shard), each what ``plan``
    (`dryrun_rtac.plan`'s collectives on this mesh) counts for a
    recurrence, then the engine's three data-axis gathers (dom,
    consistent, k) over ``n_data`` ranks."""
    per_rec, tail = log[:k_local], log[k_local:]
    bad = []
    if any(comm_stats.collective_stats([c]) != plan for c in per_rec):
        bad.append(f"a recurrence's collectives {comm_stats.collective_stats(per_rec[:1])} "
                   f"!= the plan's {plan}")
    if len(tail) != 3 or any(c.group_size != n_data for c in tail):
        bad.append(f"{len(log)} collectives for {k_local} recurrences and 3 data gathers")
    return bad


def same(res, want) -> bool:
    return all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(res, want))


def main(argv=None) -> int:
    args = parse(argv)
    device = resolve_device(args.device)
    store = None if args.store is None else dist.FileStore(args.store, args.world)
    backend = init_world(device, store, rank=args.rank, world_size=args.world,
                         backend=args.backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    shape = tuple(int(s) for s in args.mesh.split(","))
    mesh = make_mesh(shape, ("data", "model"), device)
    mesh_shape = dict(zip(mesh.mesh_dim_names, shape))
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {mesh_shape} on {world} {backend} ranks ({device.type})", flush=True)
    dtype = DTYPES[args.dtype]
    kind = variant(args.impl, dtype)

    build = hashed_random_csp if args.network == "hashed" else random_csp
    csp = build(args.n, args.d, args.density, args.tightness, seed=args.seed, device=device)
    doms = search_nodes(csp.dom.cpu().numpy(), args.batch, args.seed)

    # prepare once: places this rank's x-rows; the hot path ships only domains
    eng = get_engine("sharded", device=device, mesh=mesh, impl=args.impl, dtype=dtype)
    prepared = eng.prepare(csp)
    prepared.enforce_batch(doms)  # warm-up: kernels built and loaded
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    dist.barrier()
    bitpack_support.reset_launches()
    rtac_support.reset_launches()
    t0 = time.perf_counter()
    with comm_stats.recording() as log, comm_stats.timing() as pairs:
        res = prepared.enforce_batch(doms)
        sync()
    dt = time.perf_counter() - t0
    launches = {"packed_revise_block": bitpack_support.packed_revise_block.launches,
                "dense_revise_block": rtac_support.dense_revise_block.launches}
    res = [t.cpu().numpy() for t in res]
    k = res[2]
    # the same call with the batch already on the device: without its upload
    doms_dev = torch.as_tensor(doms, device=device)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    again = prepared.enforce_batch(doms_dev)
    sync()
    dt_dev = time.perf_counter() - t0
    _, extent, index = axis_group(mesh, ("data",))
    b_l = args.batch // extent
    k_local = int(k[index * b_l:(index + 1) * b_l].max())
    gather_ms = [s.elapsed_time(e) for s, e in pairs]
    # the engine's gathers: one over `model` a recurrence, then three over `data`
    staged = {"data": any(c.staged for c in log[k_local:]),
              "model": any(c.staged for c in log[:k_local])}
    plan = dryrun_rtac.plan(PLAN_VARIANTS[kind], mesh_shape, ("data",), n=args.n, d=args.d,
                            batch=args.batch)["collectives"]
    problems = check_collectives(log, k_local, plan, mesh_shape["data"])
    if on_card and args.backend != "gloo" and any(staged.values()):
        problems.append("a gather was staged through host memory in a CUDA world")

    if not same(res, [t.cpu().numpy() for t in again]):
        problems.append("the call on the device-resident batch differs")
    mine = {"rank": rank, "seconds": dt, "seconds_dev": dt_dev, "k_local": k_local,
            "gather_ms": gather_ms[:k_local]}
    # this rank's first block call: its shard of the batch, each domain's
    # variables all seeded while none is empty (`rtac._fixpoint_rows`)
    dom = batch_shard(mesh, ("data",), doms_dev)
    seed = (dom.sum(-1) > 0).all(-1)[:, None].expand(-1, args.n).contiguous()
    first = lambda plain=False: local_revise(args.impl, dtype, plain)(*prepared.payload, dom,
                                                                      seed)
    if "plain" in args.check and kind != "float":  # the float einsum is its own plain version
        mine["plain"] = "bit-identical" if torch.equal(first(), first(plain=True)) else "different"
        if mine["plain"] != "bit-identical":
            problems.append("the first block call differs from its plain version")
    if on_card:
        mine["block_ms"] = block_ms(first, reps=3 if kind == "float" else 20)
    if args.against:
        want = np.load(args.against)
        if not same(res, [want[f] for f in ("dom", "consistent", "k")]):
            problems.append(f"the results differ from {args.against}")
    for name in sorted(args.check - {"plain"}) if rank == 0 else ():
        ref = get_engine(name, device=device).prepare(csp).enforce_batch(doms)
        if not same(res, [t.cpu().numpy() for t in ref]):
            problems.append(f"the results differ from the single-device {name} engine")
        else:
            say(f"sharded results == single-device results ({name}) ✓", flush=True)
        del ref
    mine["problems"] = problems
    everyone = [None] * world
    dist.all_gather_object(everyone, mine)
    slowest = max(m["seconds"] for m in everyone)
    slowest_dev = max(m["seconds_dev"] for m in everyone)
    k_max = int(k.max())
    say(f"batch of {args.batch} enforcements: {1e3 * slowest:.3f} ms on the slowest rank, "
        f"{1e3 * slowest / max(k_max, 1):.3f} ms a recurrence; with the batch already on the "
        f"device {1e3 * slowest_dev:.3f} ms, {1e3 * slowest_dev / max(k_max, 1):.3f} ms a "
        f"recurrence (ranks: {[round(1e3 * m['seconds'], 3) for m in everyone]} ms, "
        f"{[round(1e3 * m['seconds_dev'], 3) for m in everyone]} ms; consistent "
        f"{int(res[1].sum())} of {args.batch}; k histogram "
        f"{dict(zip(*(a.tolist() for a in np.unique(k, return_counts=True))))})",
        flush=True)
    for m in everyone:
        say(f"rank {m['rank']}: {m['k_local']} recurrences; local revise "
            f"{m.get('block_ms', float('nan')):.4f} ms (CUDA events, its first call's operands, "
            "packing included); "
            f"all-gather ms a recurrence {[round(x, 4) for x in m['gather_ms']]}"
            + (f"; first block call {m['plain']} to plain" if "plain" in m else ""), flush=True)
    say(f"collectives: {json.dumps(comm_stats.collective_stats(log))} (rank 0; a recurrence: "
        f"{json.dumps(comm_stats.collective_stats(log[:1]))}, the plan's: {json.dumps(plan)}); "
        f"staged through host memory: {staged}; kernel launches: {launches}", flush=True)
    if on_card:
        if rank == 0:
            profile_call(lambda: (prepared.enforce_batch(doms), sync()), say)
        else:
            prepared.enforce_batch(doms)
            sync()

    if rank == 0 and args.out:
        np.savez(args.out, dom=res[0], consistent=res[1], k=k, seconds=slowest,
                 seconds_on_device=slowest_dev,
                 staged=any(staged.values()), gathers=np.asarray(
                     [(c.result_bytes, c.group_size) for c in log if c.kind == "all-gather"]),
                 **launches)
    for m in everyone:
        for p in m["problems"]:
            say(f"rank {m['rank']}: {p}", flush=True)
    if problems:
        print(f"rank {rank}: " + "; ".join(problems), file=sys.stderr, flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
