"""One cell for a few seconds on the card through the command (run with
``pytest -m gpu rtacbench/tests``); skips without a card."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT, SEED


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "rtacbench/run.py", "--workload",
                          "prod4096.batch512", "--seed", str(SEED), "--seconds", "3",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["metrics"]["node_rate"]["value"] > 0
