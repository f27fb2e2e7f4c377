"""Closed loop of `enforce_batch` calls on one large network: users of large
networks, many search nodes at a time.

Set-up builds the configuration's hashed model-A network on the device with
the frozen generator, prepares it once (`Engine.prepare`), and draws
``pool`` batches of ``batch`` search nodes (`generators.search_nodes`: the
root domain with one random variable assigned one random value) as numpy
bool arrays on the host. The window calls ``enforce_batch`` back to back
(no seed: every variable is revised first, as the reference's example
calls it),
each call on the next batch of a seeded order, handed over as the host
array, so the upload is part of the call; a call ends when its verdicts and
recurrence counts are on the host. The call running when the window ends
finishes and counts.

End to end: ``node_rate``, search nodes enforced to their fixpoint per
second: ``batch`` times the calls, over the window. The check recomputes a
seeded sample of the window's calls with the plain fixpoint from the
network's hash (never from the program's tensors) and compares every row's
verdict, recurrence count and, where consistent, closure; in a traced run
the same plain fixpoints give the revise kernel's byte bound of the traced
calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtacbench.lib import control, instances, roofline
from rtacbench.lib.harness import Check, Outcome
from rtacbench.reference import fixpoint as fx
from rtacbench.reference import generators as gen
from rtacbench.reference import hashed


def _net_args(cfg, seed):
    return dict(n_vars=cfg["n"], dom_size=cfg["d"], density=cfg["density"],
                tightness=cfg["tightness"], seed=seed)


class Port:
    def __init__(self, cfg, csp, device):
        from repro_torch.core.csp import CSP
        from repro_torch.engines import get_engine

        engine = get_engine(cfg["engine"], fixpoint=cfg["fixpoint"], device=device)
        self.prepared = engine.prepare(CSP(*csp))

    def enforce_batch(self, doms: np.ndarray):
        res = self.prepared.enforce_batch(doms)
        return res.dom, res.consistent.cpu(), res.n_recurrences.cpu()


class Control:
    """The reference with a broken guarantee in the program's place; reads
    the network it was handed, as the program does."""

    def __init__(self, cfg, csp, device):
        cons, mask, _ = csp
        xs, ys = mask.nonzero(as_tuple=True)
        self.d = cons.shape[-1]
        self.net = fx.network(xs, ys, cons[xs, ys], mask.shape[0], device)

    def enforce_batch(self, doms: np.ndarray):
        rows = fx.pack(torch.as_tensor(doms, device=self.net.device))
        out = control.enforce_batch(self.net, rows, torch.ones_like(rows, dtype=torch.bool))
        return fx.unpack(out.dom, self.d), out.consistent.cpu(), out.k.cpu()


def setup(ctx):
    cfg, wl = ctx.config, ctx.workload
    net_seed = instances.seed_of(ctx.seed)[0] & 0xFFFFFFFF
    csp = hashed.hashed_random_csp(**_net_args(cfg, net_seed), device=ctx.device)
    ctx.phase("network")
    root = np.ones((cfg["n"], cfg["d"]), dtype=bool)
    pool = [gen.search_nodes(root, wl["batch"], seed=instances.seed_of(ctx.seed, p))
            for p in range(wl["pool"] + 1)]
    ctx.phase("nodes")
    program = (Port if ctx.program == "port" else Control)(cfg, csp, ctx.device)
    ctx.phase("prepare")
    program.enforce_batch(pool[-1])  # warm up on a batch the window never sees
    ctx.sync()
    order = np.random.default_rng(instances.seed_of(ctx.seed, 1)).permutation(wl["pool"])
    return {"program": program, "csp": csp, "pool": pool[:-1], "order": order,
            "net_seed": net_seed}


def window(ctx, state) -> Outcome:
    wl = ctx.workload
    program, pool, order = state["program"], state["pool"], state["order"]
    tracer = ctx.tracer
    keep_rng = np.random.default_rng(instances.seed_of(ctx.seed, 2))
    kept, traced_calls = [], []
    t0 = time.perf_counter()
    end, calls = t0, 0
    while time.perf_counter() - t0 < ctx.seconds:
        p = int(order[calls % len(order)])
        with tracer.unit() as traced:
            with tracer.span("rtacbench.enforce_batch"):
                dom, consistent, k = program.enforce_batch(pool[p])
        end = time.perf_counter()
        if traced:
            traced_calls.append(p)
        # a seeded reservoir of the window's calls for the check
        if len(kept) < wl["check_calls"]:
            kept.append((p, dom, consistent, k))
        else:
            slot = int(keep_rng.integers(calls + 1))
            if slot < wl["check_calls"]:
                kept[slot] = (p, dom, consistent, k)
        del dom
        calls += 1
    wall = end - t0
    state.update(kept=kept, traced_calls=traced_calls)
    return Outcome({"node_rate": wl["batch"] * calls / wall}, attempted=calls, failed=0,
                   counts={"calls": calls, "window_s": wall,
                           "traced_calls": len(traced_calls)},
                   info={"calls": calls, "wall_s": wall})


def release(ctx, state) -> None:
    state.pop("program", None)
    state.pop("csp", None)


def check(ctx, state, outcome):
    cfg = ctx.config
    dev = ctx.device
    xs, ys, blocks = hashed.hashed_pairs(**_net_args(cfg, state["net_seed"]), device=dev)
    net = fx.network(xs, ys, blocks, cfg["n"], dev)
    del xs, ys, blocks
    n_p, d_p, entry = roofline.padded(cfg["n"], cfg["d"])
    cols = (net.ptr[1:] - net.ptr[:-1])[None]
    bounds = {}
    mismatched, rows = 0, 0
    for p in sorted({p for p, *_ in state["kept"]} | set(state["traced_calls"])):
        doms = state["pool"][p]
        bound = roofline.Bound()

        def observe(seed):
            b = seed.shape[0]
            bound.add(len(bound.parts), *roofline.call_bytes(
                cols, torch.zeros(b, dtype=torch.long), [seed], n_p, d_p, entry,
                out_bytes=b * n_p * d_p, idx_bytes=0))

        rows_in = fx.pack(torch.as_tensor(doms, device=dev))
        # enforce_batch without a seed revises every variable first
        want = fx.fixpoint(net, rows_in, torch.ones_like(rows_in, dtype=torch.bool),
                           on_step=observe)
        bounds[p] = bound.seconds()
        for q, dom, consistent, k in state["kept"]:
            if q != p:
                continue
            ok = want.consistent.cpu()
            same = (ok == consistent) & (want.k.cpu() == k)
            closure = fx.pack(dom.to(dev)) == want.dom
            same &= (closure.all(dim=-1) | ~want.consistent).cpu()
            mismatched += int((~same).sum())
            rows += same.shape[0]
    if state["traced_calls"]:
        outcome.counts["revise_bound_s"] = sum(bounds[p] for p in state["traced_calls"])
    return [Check("rows_mismatched", mismatched, 0),
            Check("rows_unchecked", 0 if rows else 1, 0)]
