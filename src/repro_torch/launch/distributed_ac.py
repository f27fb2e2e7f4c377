"""Distributed RTAC: shard the constraint tensor over a (data, model) mesh.

The counterpart of ``examples/distributed_ac.py``. Every rank runs this
program: the network's x-rows are sharded over ``model``, a batch of
candidate domains (search nodes, each with one variable assigned) over
``data``; rank 0 checks the gathered results against the single-device
``einsum`` engine.

    torchrun --nproc-per-node 8 -m repro_torch.launch.distributed_ac --device cpu

Without torchrun, ``--store FILE --rank R --world W`` joins a world through
a `FileStore` (no port); with neither, the world is one rank. ``--network
hashed`` builds the network on the device block by block
(`hashed_random_csp`), for sizes whose numpy draws would not fit the host;
``--out FILE`` has rank 0 save the results (dom, consistent, k) and the
per-recurrence collective record as an .npz.
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
from repro_torch.device import resolve_device
from repro_torch.engines import get_engine
from repro_torch.kernels import bitpack_support, rtac_support
from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.parallel import comm_stats

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
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--tightness", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--network", choices=("random", "hashed"), default="random")
    ap.add_argument("--impl", choices=("einsum", "bitpacked"), default="einsum")
    ap.add_argument("--check", choices=("einsum", "none"), default="einsum")
    ap.add_argument("--store", default=None, help="a FileStore path (with --rank, --world)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    device = resolve_device(args.device)
    store = None if args.store is None else dist.FileStore(args.store, args.world)
    backend = init_world(device, store, rank=args.rank, world_size=args.world,
                         backend=args.backend)
    rank = dist.get_rank()
    shape = tuple(int(s) for s in args.mesh.split(","))
    mesh = make_mesh(shape, ("data", "model"), device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, shape))} on {dist.get_world_size()} "
        f"{backend} ranks ({device.type})", flush=True)

    build = hashed_random_csp if args.network == "hashed" else random_csp
    csp = build(args.n, args.d, args.density, args.tightness, seed=args.seed, device=device)
    doms = search_nodes(csp.dom.cpu().numpy(), args.batch, args.seed)

    # prepare once: places this rank's x-rows; the hot path ships only domains
    eng = get_engine("sharded", device=device, mesh=mesh, impl=args.impl)
    prepared = eng.prepare(csp)
    prepared.enforce_batch(doms)  # warm-up: kernels built and loaded
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    dist.barrier()
    bitpack_support.reset_launches()
    rtac_support.reset_launches()
    t0 = time.perf_counter()
    with comm_stats.recording() as log:
        res = prepared.enforce_batch(doms)
        sync()
    dt = time.perf_counter() - t0
    launches = {"packed_revise_block": bitpack_support.packed_revise_block.launches,
                "dense_revise_block": rtac_support.dense_revise_block.launches}
    staged = comm_stats.staged(mesh.get_group("model"), res.dom)
    k = res.n_recurrences.cpu().numpy()
    say(f"batch of {args.batch} enforcements: {1e3 * dt:.1f} ms, "
        f"{1e3 * dt / max(int(k.max()), 1):.2f} ms a recurrence "
        f"(consistent: {res.consistent.cpu().numpy().tolist()}, k: {k.tolist()})", flush=True)
    gathers = [c for c in log if c.kind == "all-gather"]
    say(f"collectives: {json.dumps(comm_stats.collective_stats(log))}; staged through "
        f"host memory: {staged}; kernel launches: {launches}", flush=True)

    if rank == 0 and args.out:
        np.savez(args.out, dom=res.dom.cpu().numpy(), consistent=res.consistent.cpu().numpy(),
                 k=k, seconds=dt, staged=staged, gathers=np.asarray(
                     [(c.result_bytes, c.group_size) for c in gathers]), **launches)
    ok = True
    if rank == 0 and args.check == "einsum":
        ref = get_engine("einsum", device=device).prepare(csp).enforce_batch(doms)
        ok = (torch.equal(ref.consistent, res.consistent) and torch.equal(ref.dom, res.dom)
              and torch.equal(ref.n_recurrences, res.n_recurrences))
        if ok:
            say("sharded results == single-device results ✓", flush=True)
        else:
            print("sharded results differ from the single-device einsum engine",
                  file=sys.stderr)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
