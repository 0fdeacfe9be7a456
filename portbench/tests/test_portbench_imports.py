"""No module of JAX or of the JAX package is loaded by the harness and the
cells' step kinds, compared by whole top-level names (the port's package
name begins with the JAX package's)."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
bench = harness.benchmark()
for w in bench["workloads"]:
    harness.Cell(w["name"], bench)
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.load_module(harness.HERE / "metrics" / (m["name"] + ".py"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_harness_or_the_cells():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "nbodyhpc_tpu_torch" in top and "torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole():
    assert harness.loaded_forbidden(
        ["nbodyhpc_tpu_torch.ops", "jaxlibrary", "flaxen", "numpy"]) == []
    assert harness.loaded_forbidden(
        ["jaxlib.xla", "nbodyhpc_tpu.ops.knn", "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "nbodyhpc_tpu"]
