"""One rank of the port's sharded fixpoint on gloo meshes, for
`tests/test_torch_sharded.py` (not a test module itself).

    python tests/torch_sharded_worker.py STORE RANK WORLD MESHES INPUTS OUT

Joins a world of WORLD processes through the `FileStore` at STORE. For each
(data, model) mesh of MESHES (comma-separated ``DxM``, e.g. ``1x4,2x2,4x1``,
each D·M = WORLD) it reads every case of INPUTS (an .npz of numpy networks,
domain batches and seeds, keyed ``{case}_{field}``), runs each through
`shard_csp_arrays` and `make_sharded_enforcer` with its collectives
recorded, and the engine on the first three domains of each batch (so B
pads to the data extent), then writes this rank's results to
OUT/rank{RANK}.npz and its records to OUT/rank{RANK}.json, keyed
``{mesh}/{case}``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.csp import CSP
from repro_torch.core.sharded import batch_shard, make_sharded_enforcer, shard_csp_arrays
from repro_torch.engines import get_engine
from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.parallel import comm_stats

DTYPES = {"bfloat16": torch.bfloat16, "uint8": torch.uint8}


def main(store_path: str, rank: str, world: str, meshes: str, inputs: str, out: str) -> int:
    rank, world = int(rank), int(world)
    init_world("cpu", dist.FileStore(store_path, world), rank=rank, world_size=world)
    data = np.load(inputs)
    cases = sorted({k.rsplit("_", 1)[0] for k in data.files})
    results, records = {}, {}
    for shape in meshes.split(","):
        mesh = make_mesh(tuple(int(s) for s in shape.split("x")), ("data", "model"),
                         device="cpu")
        for case in cases:
            key = f"{shape}/{case}"
            _seed, impl, dtype_name = case.split("-")
            dtype = DTYPES[dtype_name]
            cons, mask, doms, changed = (data[f"{case}_{f}"] for f in ("cons", "mask", "doms",
                                                                        "changed"))
            cons_blk, mask_blk, dom = shard_csp_arrays(mesh, cons, mask, doms, impl=impl,
                                                       dtype=dtype)
            ch = batch_shard(mesh, ("data",), torch.as_tensor(changed))
            enforce = make_sharded_enforcer(mesh, "model", ("data",), dtype, impl)
            with comm_stats.recording() as log:
                res = enforce(cons_blk, mask_blk, dom, ch)
            for name, t in zip(("dom", "consistent", "k"), res):
                results[f"{key}_{name}"] = t.numpy()
            records[key] = [list(c) for c in log]
            csp = CSP(*(torch.as_tensor(a) for a in (cons, mask, doms[0])))
            eng = get_engine("sharded", device="cpu", mesh=mesh, impl=impl, dtype=dtype)
            whole = eng.prepare(csp).enforce_batch(doms[:3], changed[:3])
            for name, t in zip(("dom", "consistent", "k"), whole):
                results[f"{key}_engine_{name}"] = t.numpy()
    np.savez(Path(out) / f"rank{rank}.npz", **results)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(records))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
