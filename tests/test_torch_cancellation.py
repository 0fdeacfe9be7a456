"""Cooperative cancellation in the PyTorch port: Ctrl-C aborts its long
chunked loops (CPU).

The children of ``tests/test_cancellation.py`` on the port, with
``device="cpu"``: SIGINT sent mid-call must raise ``KeyboardInterrupt`` at
the next chunk (reference: the ``PyErr_CheckSignals`` poll every 1000
queries, kdtree/src/cpp/pybind.cpp:127-134, and the render's fence-wait
slices, rasterization/src/cpp/point_renderer.cpp:797-818). In the port the
chunk loops are Python loops (``ops/knn_device.py::ladder_knn``'s query
chunks, the oracle's 256-particle chunks, a streamed render's batches),
where Python delivers the signal. A streamed render must also leave no
reader thread behind. Each child's call would run for many seconds; the abort
must come within one chunk."""
from test_cancellation import _run_sigint_child

KNN_CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.ops import knn

rng = np.random.Generator(np.random.Philox(5))
pts = rng.random((50000, 3)).astype(np.float32)
t = KDTree(pts, device="cpu")
q = torch.from_numpy(rng.random((100000, 3)).astype(np.float32))
# many ladder chunks: the chunk boundaries are the cancellation points
assert q.shape[0] >= 20 * knn.ladder_chunk(knn.default_ladder(t._tree))
t.query_device(q[:2048], 8, engine="ladder")
print("WARM", flush=True)
try:
    t.query_device(q, 8, engine="ladder")
    print("DONE", flush=True)
    sys.exit(1)
except KeyboardInterrupt:
    print("INTERRUPTED", flush=True)
    sys.exit(42)
"""

RENDER_CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from nbodyhpc_tpu_torch.rasterizer import Container, PointRenderer

rng = np.random.Generator(np.random.Philox(9))
n = 200_000
pos = rng.random((n, 3)).astype(np.float32)
w = np.ones(n, np.float32)
r = (rng.random(n) * 0.04 + 0.01).astype(np.float32)
pr = PointRenderer(Container(device="cpu"), 32, 32)
pr.render_points_volume(pos[:256], w[:256], r[:256], 32, 32.0)
print("WARM", flush=True)
try:
    pr.render_points_volume(pos, w, r, 32, 32.0)
    print("DONE", flush=True)
    sys.exit(1)
except KeyboardInterrupt:
    print("INTERRUPTED", flush=True)
    sys.exit(42)
"""

STREAM_CHILD = r"""
import os, sys, tempfile, threading
import numpy as np
import torch
torch.set_num_threads(2)
from nbodyhpc_tpu_torch import runtime
from nbodyhpc_tpu_torch.cli.rasterizer_demo import main

rng = np.random.Generator(np.random.Philox(11))
n = 100_000
pos = (rng.random((n, 3)) * 0.8 + 0.1).astype(np.float32)
w = np.ones(n, np.float32)
r = (rng.random(n) * 0.04 + 0.01).astype(np.float32)
tmp = tempfile.mkdtemp()
path = os.path.join(tmp, "parts.bin")
runtime.save_particles(path, pos, w, r)
before = threading.active_count()
print("WARM", flush=True)
try:
    main(["--file", path, "--grid", "32", "--stream", "10000",
          "--device", "cpu"])
    print("DONE", flush=True)
    sys.exit(1)
except KeyboardInterrupt:
    # the stream was closed on the way out: its reader thread is joined
    alive = threading.active_count()
    print("INTERRUPTED" if alive == before else f"LEAKED {alive}", flush=True)
    sys.exit(42 if alive == before else 43)
finally:
    os.remove(path)
    os.rmdir(tmp)
"""


def test_sigint_aborts_chunked_query():
    _run_sigint_child(KNN_CHILD)


def test_sigint_aborts_chunked_render():
    _run_sigint_child(RENDER_CHILD)


def test_sigint_aborts_streamed_render():
    _run_sigint_child(STREAM_CHILD)
