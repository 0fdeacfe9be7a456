"""A whole run of each cell on the card, through the command, at a short
window: the result line has the contract's keys and the run is correct.
Needs an NVIDIA Hopper card and nvcc; skips without them."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17), "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
