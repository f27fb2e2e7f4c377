"""The sharded path on one and on several cards, in one call: the
production CSP (n=4096, d=32; `hashed_random_csp`, density 0.01, tightness
0.6) at its full batch, B=512, through `repro_torch.launch.distributed_ac`
under ``torchrun``, one process a card.

    python -m repro_torch.launch.sharded_cards --out DIR [-- ARGS]

(ARGS go to every `distributed_ac` command after the network's, e.g.
``-- --device cpu --n-vars 64 --dom-size 16 --density 0.2`` for a
rehearsal on gloo, four ranks on the CPU.)

Prints each card's name and power limit, ``nvidia-smi topo -m`` and
``nvlink -s``, and which cards reach each other's memory (also in
DIR/cards.txt), then runs, each
command's output (NCCL's ``INFO`` lines too; of those only the transports
between ranks, ``via ...``, are printed) also in DIR/<name>.log:

1. one card, bitpacked and u8 (``--mesh 1,1``), each saved with ``--out``
   (the packed run also held against `hopper_packed` and plain; the saved
   files are removed at the end);
2. on every card of the machine, one rank a card, meshes (1, cards) and,
   where ``cards`` is even and above 2, (2, cards/2), bitpacked and u8: every
   rank held against the one-card run (``--against``), rank 0 against
   `hopper_packed`, every rank's first block call against plain;
3. the bf16 einsum on (1, cards) at B=32, rank 0 against `hopper_packed`
   (the library yardstick of the block revises).

Each run is stopped after `TIMEOUT` seconds. Exits non-zero if any run
did.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import torch

NETWORK = ["--network", "hashed", "--n-vars", "4096", "--dom-size", "32", "--density", "0.01",
           "--tightness", "0.6", "--seed", "0"]
VARIANTS = {"bitpacked": ["--impl", "bitpacked"],
            "u8": ["--impl", "einsum", "--dtype", "uint8"]}
#: seconds a run may take: a collective that never completes would otherwise
#: hold every card until NCCL's own timeout
TIMEOUT = 300.0


def run(name: str, cmd: list, out: Path) -> int:
    """Run ``cmd``, stopped after `TIMEOUT` seconds; print its output
    (torch's ``[W`` warnings left out) prefixed with ``name`` and keep all
    of it in ``out/name.log``."""
    print(f"[{name}] $ {' '.join(cmd)}", flush=True)
    env = {**os.environ, "NCCL_DEBUG": os.environ.get("NCCL_DEBUG", "INFO")}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env)
    try:
        log = proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        proc.terminate()  # torchrun stops its workers, each in a session of its own
        try:
            log = proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            log = ""
        log += f"\nstopped after {TIMEOUT} s\n"
    (out / f"{name}.log").write_text(log)
    for line in log.splitlines():  # of NCCL's own lines, the transports between ranks
        if not line.startswith("[W") and (" NCCL INFO " not in line or " via " in line):
            print(f"[{name}] {line}", flush=True)
    print(f"[{name}] exit {proc.returncode}", flush=True)
    return proc.returncode


def torchrun(nproc: int, args: list, rest: list) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.distributed_ac", *NETWORK,
            *args, *rest]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    info = []
    for query in (["--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                  ["topo", "-m"], ["nvlink", "-s"]):
        try:
            done = subprocess.run(["nvidia-smi", *query], capture_output=True, text=True)
            info.append(f"nvidia-smi {' '.join(query)}: {done.stdout}{done.stderr}")
        except FileNotFoundError:
            info.append("nvidia-smi not found")
    cards = torch.cuda.device_count() or 4  # four gloo ranks for a rehearsal on the CPU
    info.append("peer access (torch.cuda.can_device_access_peer): " + str(
        [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(cards)]
         for i in range(cards)]) if torch.cuda.is_available() else "no card: gloo ranks")
    (out / "cards.txt").write_text("\n".join(info) + "\n")
    print("\n".join(info), flush=True)
    codes = []
    for name, impl in VARIANTS.items():
        checks = ["--check", "hopper_packed", "--check", "plain"] if name == "bitpacked" else []
        codes.append(run(f"one-{name}", torchrun(1, [
            *impl, "--batch", "512", "--mesh", "1,1", "--check", "none", *checks,
            "--out", str(out / f"one-{name}.npz")], rest), out))
    meshes = [(1, cards)] + ([(2, cards // 2)] if cards > 2 and cards % 2 == 0 else [])
    for data, model in meshes:
        for name, impl in VARIANTS.items():
            codes.append(run(f"{data}x{model}-{name}", torchrun(cards, [
                *impl, "--batch", "512", "--mesh", f"{data},{model}", "--check",
                "hopper_packed", "--check", "plain", "--against",
                str(out / f"one-{name}.npz")], rest), out))
    codes.append(run(f"1x{cards}-bf16-b32", torchrun(cards, [
        "--impl", "einsum", "--dtype", "bfloat16", "--batch", "32", "--mesh",
        f"1,{cards}", "--check", "hopper_packed"], rest), out))
    for name in VARIANTS:  # 64 MiB each at B=512, needed only by the runs above
        (out / f"one-{name}.npz").unlink(missing_ok=True)
    print(f"exit codes: {codes}", flush=True)
    return 0 if not any(codes) else 1


if __name__ == "__main__":
    sys.exit(main())
