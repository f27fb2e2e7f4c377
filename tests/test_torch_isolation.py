"""The port stands alone: it imports neither JAX nor `repro`, and its entry
points run on the card unless the caller asks for the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.core import mac_solve, solve_many
from repro_torch.engines import get_engine
from repro_torch.kernels import autotune
from repro_torch.launch.serve import serve
from repro_torch.problems import generate
from repro_torch.service import SolverService
from repro_torch.sweeps import load_spec, run_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = (
        "import sys, importlib.util\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
        "import repro_torch, repro_torch.core, repro_torch.engines, repro_torch.kernels\n"
        "import repro_torch.problems, repro_torch.obs, repro_torch.faults\n"
        "import repro_torch.kernels.rtac_support, repro_torch.engines.hopper\n"
        "import repro_torch.engines.ac3, repro_torch.core.brute, repro_torch.service\n"
        "import repro_torch.obs.export, repro_torch.obs.__main__, repro_torch.launch.serve\n"
        "import repro_torch.problems.coloring, repro_torch.problems.structured\n"
        "import repro_torch.sweeps, repro_torch.sweeps.__main__, repro_torch.kernels.autotune\n"
        "import repro_torch.launch.mesh, repro_torch.parallel.comm_stats\n"
        "import repro_torch.parallel.sharding, repro_torch.core.sharded\n"
        "import repro_torch.engines.sharded, repro_torch.launch.dryrun_rtac\n"
        "import repro_torch.launch.distributed_ac\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    csp = generate("model_rb", n=8, device="cpu")
    if torch.cuda.is_available():
        assert get_engine("hopper_packed").device.type == "cuda"
        return
    for make in (lambda: get_engine("hopper_packed"), lambda: get_engine("einsum"),
                 lambda: generate("model_rb", n=8), lambda: solve_many([csp]),
                 lambda: mac_solve(csp), lambda: get_engine("ac3"), lambda: SolverService(),
                 lambda: SolverService(engine="hopper_dense"),
                 lambda: serve(duration=0.5, quiet=True),
                 lambda: run_spec(load_spec("smoke"), progress=None),
                 lambda: autotune.tune("packed", 16, 8), lambda: get_engine("sharded")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 2, out.stdout + out.stderr
    assert '"ok"' not in out.stdout
