"""The output check separates the program from its control and from planted
faults, at sizes a CPU test run holds.

The control is the plain reference put in the program's place and computed
in bfloat16, the precision below the float32 that the configurations state.
The faults are planted in the public call the window drives: an answer
altered where it is produced, and half of the batch left out."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench_small import cpu_renders, small_cell

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _correct(res) -> bool:
    return res["failed"] == 0 and all(v <= lim for _, v, lim in res["checks"])


def _run(cell):
    with cpu_renders():
        return harness.run(cell, 2 ** 31 + 99, 0.0, False, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    cell = small_cell(name)
    res = _run(cell)
    assert _correct(res), res["checks"]
    with cpu_renders():
        step = cell.step(2 ** 31 + 5, "cpu")
        step.warm()
        step.run(0)
        checks, failed = step.check(cell.limits, control=torch.bfloat16)
    assert failed > 0 and any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("kind", harness.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_fail(name, kind):
    cell = small_cell(name)
    cell.kind.plant_fault(kind)
    res = _run(cell)
    assert not _correct(res), res["checks"]
