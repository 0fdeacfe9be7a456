"""The halo configuration's own files: the generator repeats, the step kind
adds the halo tiles, reads the program's counters and ends a run whose
warm renders are too slow, the dense roofline reader reads a hand-made
trace, and the card test runs the new cell."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.roofline import least_ms
from portbench.roofline_dense import dense_bytes
from portbench_small import cpu_renders, small_cell

CELL = "camels-halos.render-sph-1024"


def test_generator_repeats_and_fills_the_box():
    c = small_cell(CELL)
    seed = 2 ** 31 + 12345
    a = c.generator.snapshot(c.config, seed, torch.device("cpu"))
    b = c.generator.snapshot(c.config, seed, torch.device("cpu"))
    other = c.generator.make(c.config, "particles", seed + 1, "cpu")
    n = c.config["particles"]
    assert a.pos.shape == (n, 3) and a.pos.dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.pos, other)
    assert float(a.pos.min()) >= 0.0 and float(a.pos.max()) < c.config["box"]
    assert bool((a.hsml > 0).all()) and bool(torch.isfinite(a.hsml).all())
    assert bool((a.sizes[:-1] >= a.sizes[1:]).all())


def test_step_adds_halo_tiles_and_reads_counters():
    from nbodyhpc_tpu_torch.utils import profiling

    c = small_cell(CELL)
    step = c.step(11, "cpu")
    (pos, w, r), corners = step.sets[0]
    assert (w == 1).all() and len(corners) == 38 + step.grid // step.T + 4
    assert step.params() == {"particles": c.config["particles"],
                             "voxels": step.grid ** 3}
    profiling.reset()
    with cpu_renders():
        step.run(0)
    assert step.counters() == {}  # the CPU oracle counts no dense rows
    profiling.count("render.dense_rows", 0)
    profiling.count("render.dense_voxels", 0)
    with cpu_renders():
        step.run(1)
    assert step.counters() == {"render.dense_rows": 0,
                               "render.dense_voxels": 0}


def test_warm_ends_a_run_that_renders_too_slowly(monkeypatch):
    """Warm renders past ``WARM_LIMIT_S`` end the process (exit 1);
    renders inside it leave the process alone."""
    c = small_cell(CELL)
    step = c.step(11, "cpu")
    g = step.grid
    exits = []
    monkeypatch.setattr(c.kind.os, "_exit", exits.append)

    def render(pause):
        def fn(*a, **kw):
            time.sleep(pause)
            return np.zeros((g, g, g), np.float32, order="F")
        return fn

    monkeypatch.setattr(c.kind, "WARM_LIMIT_S", 0.1)
    step.render = render(0.15)
    step.warm()
    assert exits == [1]
    monkeypatch.setattr(c.kind, "WARM_LIMIT_S", 0.3)
    step.render = render(0.0)
    step.warm()
    time.sleep(0.4)
    assert exits == [1] and step.kept == []


def test_dense_roofline_reader(monkeypatch):
    """The mean least bytes of the traced steps, the grid bounding the
    sphere voxels, over the dense span's 2 ms a call."""
    mod = harness.load_module(
        harness.HERE / "metrics" / "render.dense_roofline.py")
    monkeypatch.setattr(mod, "per_call_ms", lambda span, call: 2.0)
    rec = trace.Records(params={"particles": 10, "voxels": 1000})
    assert mod.read(rec) is None
    rec.steps = [{"render.dense_rows": 4, "render.dense_voxels": 400},
                 {"render.dense_rows": 6, "render.dense_voxels": 4000}]
    want = (dense_bytes(4, 400, 1000) + dense_bytes(6, 4000, 1000)) / 2
    assert dense_bytes(6, 4000, 1000) == 20 * 6 + 4 * 1000
    assert mod.read(rec) == pytest.approx(100 * least_ms(want) / 2.0)
    rec.steps = [{"render.dense_rows": 4}]
    assert mod.read(rec) is None


def test_card_test_runs_the_new_cell():
    from test_portbench_card import CELLS

    assert CELL in CELLS
