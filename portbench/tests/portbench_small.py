"""The cells at sizes a CPU test run holds: the same files, fewer points."""
from __future__ import annotations

import contextlib

from portbench import harness

SMALL_CONFIG = {
    "upstream-uniform": {"particles": 1500, "points": 12000},
}
SMALL_TRAFFIC = {
    "render-1024": {"grid": 16},
    "knn-k16": {"queries": 8192},
}


def small_cell(name: str) -> harness.Cell:
    bench = harness.benchmark()
    spec = harness.cell_spec(bench, name)
    entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
    config = harness.read_json(harness.ROOT / entry["file"])
    config.update(SMALL_CONFIG[spec["config"]])
    traffic = harness.read_json(
        harness.HERE / "traffic" / f"{spec['traffic']}.json")
    traffic.update(SMALL_TRAFFIC[spec["traffic"]])
    return harness.Cell(name, bench, config, traffic)


@contextlib.contextmanager
def cpu_renders():
    """Renders through the public API on a CPU container."""
    from nbodyhpc_tpu_torch import rasterizer

    saved = rasterizer.get_default_container
    cpu = rasterizer.Container(device="cpu")
    rasterizer.get_default_container = lambda: cpu
    try:
        yield
    finally:
        rasterizer.get_default_container = saved
