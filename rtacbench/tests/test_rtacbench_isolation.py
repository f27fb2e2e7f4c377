"""No run loads JAX or the JAX package (``repro``, compared by whole
top-level name: the port's ``repro_torch`` begins with it), and the
reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from conftest import ROOT, SEED, TINY

PY = [sys.executable, "-c"]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))


def _run(code: str) -> str:
    out = subprocess.run(PY + [code], cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_reference_package():
    code = ("import json, sys, time\n"
            "from rtacbench.lib import harness\n"
            f"r = harness.run_cell('rb100-40.single', {SEED}, 0.3, False, time.perf_counter(),"
            f" device='cpu', overrides={TINY['rb100-40.single']!r})\n"
            "print(json.dumps([r['correct'], sorted({m.split('.')[0] for m in sys.modules})]))")
    correct, tops = json.loads(_run(code))
    assert correct is True
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys\n"
            "import rtacbench.reference.generators, rtacbench.reference.hashed\n"
            "import rtacbench.reference.fixpoint, rtacbench.reference.mac\n"
            "import rtacbench.lib.roofline, rtacbench.lib.control\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(json.loads(_run(code)))
    assert not {"repro_torch", "repro", "jax"} & tops


def test_the_harness_flags_a_forbidden_module():
    code = ("import sys, types, json\n"
            "from rtacbench.lib import harness\n"
            "sys.modules['repro'] = types.ModuleType('repro')\n"
            "print(json.dumps(harness.forbidden_modules()))")
    assert json.loads(_run(code)) == ["repro"]


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "rtacbench/run.py", "--workload",
                          "rb100-40.single", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_a_forbidden_module_loaded_by_the_check_prints_no_result():
    # the reference and the readers run after the window: a JAX module
    # that either loads still keeps the result from being printed
    code = ("import json, sys, time, types\n"
            "from rtacbench.lib import harness, searches\n"
            "real = searches.replay\n"
            "def replay(*args, **kwargs):\n"
            "    sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
            "    return real(*args, **kwargs)\n"
            "searches.replay = replay\n"
            f"r = harness.run_cell('rb100-40.single', {SEED}, 0.3, False, time.perf_counter(),"
            f" device='cpu', overrides={TINY['rb100-40.single']!r})\n"
            "print(json.dumps(r))")
    assert json.loads(_run(code)) is None
