"""Production-scale dry run of distributed RTAC — what one rank of the
reference's 512-device mesh holds and sends, from the port's own layouts.

The counterpart of `repro.launch.dryrun_rtac`, which AOT-compiles the
shard_map fixpoint for 512 forced host devices and reads XLA's memory and
cost analyses and the HLO's collectives. PyTorch has no AOT compile of a
distributed program, so this module computes the same quantities for the
production CSP (n=4096 vars, d=32 values, a batch of 512 search-node
domains over (pod ×) data), allocating nothing:

- per-rank argument bytes: this rank's network block in the variant's
  layout and its mask rows (`core.sharded.block_layout` and `mask_layout`
  on "meta" tensors), and its shard of the
  domain batch and seeds (``memory_analysis.argument_size_in_bytes``), and
  its results (``output_size_in_bytes``);
- per-recurrence collectives: one all-gather over ``model`` of the local
  batch's domains, B_local·n·d bool, through `parallel.comm_stats`'s
  formulas (``collectives``, ``collective_wire_bytes``);
- the einsum variants' flops per recurrence (``cost_analysis.flops``): the
  contraction's multiply-adds, 2·B_local·nx·n·d², as XLA counts a dot.

Variants: einsum-bf16 (paper-faithful contraction, torch.einsum),
einsum-u8 (dense u8 support test, kernel 6's block form), bitpacked (uint32
words, kernel 3's block form). Keys with no counterpart are left out:
``compile_s`` (nothing is compiled), and of XLA's analyses every field but
the argument and output sizes and, for einsum, the flops.

    python -m repro_torch.launch.dryrun_rtac [--mesh both]

writes ``artifacts/dryrun_torch/rtac__{variant}__{mesh}.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Dict, Sequence

import torch

from repro_torch.core.sharded import block_layout, mask_layout
from repro_torch.parallel.comm_stats import Collective, collective_stats, total_wire_bytes

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

N_VARS = 4096
DOM = 32
BATCH = 512
VARIANTS = {"einsum-bf16": ("einsum", torch.bfloat16), "einsum-u8": ("einsum", torch.uint8),
            "bitpacked": ("bitpacked", torch.bfloat16)}
MESHES = {"single": ({"data": 16, "model": 16}, ("data",)),
          "multi": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}


def layout_nbytes(nx: int, n: int, d: int, impl: str, dtype: torch.dtype) -> Dict[str, int]:
    """Bytes of a rank's network block and mask rows: `block_layout` and
    `mask_layout` of ``impl``/``dtype`` run on "meta" tensors, which
    carry shapes and dtypes and allocate nothing."""
    meta = torch.device("meta")
    cons = block_layout(torch.empty((nx, n, d, d), dtype=torch.bool, device=meta), impl, dtype)
    mask = mask_layout(torch.empty((nx, n), dtype=torch.uint8, device=meta), impl, dtype)
    return {name: t.numel() * t.element_size() for name, t in (("cons", cons), ("mask", mask))}


def recurrence_collectives(b_local: int, n: int, d: int, model: int) -> list:
    """The collectives of one recurrence on one rank: the all-gather over
    ``model`` of the local batch's domains (bool)."""
    return [Collective("all-gather", b_local * n * d, model)]


def plan(variant: str, mesh_shape: Dict[str, int], batch_axes: Sequence[str],
         n: int = N_VARS, d: int = DOM, batch: int = BATCH) -> dict:
    """One rank's bytes, collectives and flops per recurrence for ``variant``
    on a mesh of ``mesh_shape`` ({axis: extent}), the batch split over
    ``batch_axes``."""
    impl, dtype = VARIANTS[variant]
    model = mesh_shape["model"]
    extent = math.prod(mesh_shape[a] for a in batch_axes)
    if n % model or batch % extent:
        raise ValueError(f"n={n} over {model} model ranks, batch={batch} over {extent}")
    nx, b_local = n // model, batch // extent
    args = {
        **layout_nbytes(nx, n, d, impl, dtype),
        "dom": b_local * n * d,
        "changed": b_local * n,
    }
    coll = collective_stats(recurrence_collectives(b_local, n, d, model))
    rec = {
        "workload": "rtac",
        "variant": variant,
        "n_vars": n,
        "dom": d,
        "batch": batch,
        "n_devices": math.prod(mesh_shape.values()),
        "mesh_shape": dict(mesh_shape),
        "rows_per_rank": nx,
        "batch_per_rank": b_local,
        "memory_analysis": {
            "argument_size_in_bytes": sum(args.values()),
            "output_size_in_bytes": b_local * (n * d + 1 + 4),  # dom, consistent, k (int32)
        },
        "arguments": args,
        "collectives": coll,
        "collective_wire_bytes": total_wire_bytes(coll),
    }
    if impl == "einsum":
        rec["cost_analysis"] = {"flops": 2.0 * b_local * nx * n * d * d}
    return rec


def run_variant(variant: str, mesh_kind: str) -> dict:
    mesh_shape, batch_axes = MESHES[mesh_kind]
    rec = {**plan(variant, mesh_shape, batch_axes), "mesh": mesh_kind}
    mem = rec["memory_analysis"]
    print(f"[dryrun-rtac] {variant:12s} × {mesh_kind}: "
          f"flops/dev={rec.get('cost_analysis', {}).get('flops', 0):.3e} "
          f"wire/dev={rec['collective_wire_bytes']:.3e}B "
          f"args={mem['argument_size_in_bytes'] / 2**30:.4f}GiB "
          f"({', '.join(f'{k} {v}' for k, v in rec['arguments'].items())} B)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    ART_DIR.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_kind in meshes:
        for variant in args.variants.split(","):
            rec = run_variant(variant, mesh_kind)
            path = ART_DIR / f"rtac__{variant}__{mesh_kind}.json"
            path.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
