"""The ladder's route on a host without a card: a CPU tree, and any k above
the ladder kernel's 128, keep the torch rungs (the kernel's plain twin);
``default_ladder`` packs into the kernel's rung arguments; the kernel's
wrapper refuses bad inputs, a CPU tree among them, before it loads the
kernel library, and its ctypes signature matches the C entry point; the
rows the rungs leave reach the brute pass a chunk at a time.

The file imports torch only (no JAX); the kernel itself is held to the
twin on the card in ``test_torch_knn_cuda.py``.
"""
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch import _build
from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.ops import knn
from nbodyhpc_tpu_torch.ops import knn_cuda as kc
from nbodyhpc_tpu_torch.ops import knn_device as kd
from nbodyhpc_tpu_torch.utils import profiling


def _points(n, seed):
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.random((n, 3)).astype(np.float32)


def _tree(case):
    """A CPU tree: ``uniform`` (three rungs), ``clustered`` (a cluster of
    1,500 points, so a capacity rung), ``tiny`` (30 points, two rungs)."""
    pts = _points(4000, 7)
    if case == "clustered":
        rng = np.random.Generator(np.random.Philox(8))
        clu = 0.5 + 0.01 * rng.standard_normal((1500, 3))
        pts = np.concatenate([pts, clu]).clip(0.0, 0.9999).astype(np.float32)
    elif case == "tiny":
        pts = pts[:30]
    return KDTree(pts, boxsize=1.0, device="cpu")._tree


@pytest.fixture
def no_library(monkeypatch):
    """Loading the kernel library fails the test."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("k", [16, kc.TOPK_MAX + 1])
def test_cpu_tree_keeps_the_torch_rungs(no_library, k):
    tree = _tree("uniform")
    q = torch.from_numpy(_points(50, 9))
    profiling.reset()
    got = kd.ladder_knn(tree, q, k, with_stats=True)
    c = profiling.counters()
    assert c["knn.rungs"] >= 1
    assert c.get("knn.ladder.kernel_rows", 0) == 0
    assert c.get("knn.ladder.launches", 0) == 0
    assert got.distances.shape == (50, k)
    assert bool((got.stats.cells_scanned > 0).all())


@pytest.mark.parametrize("device,k,want", [
    ("cuda", 1, True), ("cuda", 16, True), ("cuda", kc.TOPK_MAX, True),
    ("cuda", kc.TOPK_MAX + 1, False), ("cpu", 16, False),
    ("cpu", kc.TOPK_MAX + 1, False)])
def test_ladder_route_follows_the_tree_device_and_k(device, k, want):
    tree = types.SimpleNamespace(device=torch.device(device))
    assert kc.ladder_on_kernel(tree, k) is want


@pytest.mark.parametrize("case,npad,want", [
    ("uniform", None, (3, 1, 18, 2, 18, 4, 18, 0, 0)),
    ("clustered", None, (4, 1, 256, 1, 1504, 2, 128, 4, 64)),
    ("tiny", None, (2, 1, 6, 2, 6, 0, 0, 0, 0)),
    # a tree padded to fewer slots than a cap: the cap is cut to npad
    ("clustered", 1000, (4, 1, 256, 1, 1000, 2, 128, 4, 64)),
])
def test_default_ladder_packs_into_the_rung_arguments(case, npad, want):
    tree = _tree(case)
    ladder = knn.default_ladder(tree)
    assert kc.ladder_args(ladder, npad or tree.npad) == want
    if npad is None:  # uncut: the ladder's own pairs, in order
        n = want[0]
        assert ladder == tuple(zip(want[1:2 * n:2], want[2:2 * n + 1:2]))


def _bad_inputs(case):
    """(tree, queries, k, ladder) with one thing wrong."""
    tree = _tree("uniform")
    q = torch.from_numpy(_points(10, 10))
    ladder = knn.default_ladder(tree)
    if case == "k0":
        return tree, q, 0, ladder
    if case == "k129":
        return tree, q, kc.TOPK_MAX + 1, ladder
    if case == "no_rungs":
        return tree, q, 8, ()
    if case == "five_rungs":
        return tree, q, 8, ((1, 8),) * 5
    if case == "radius0":
        return tree, q, 8, ((0, 8),)
    if case == "cpu_tree":  # nothing else wrong: the kernel needs a card
        return tree, q, 8, ladder
    if case == "cap0":
        return tree, q, 8, ((1, 0),)
    if case == "float64":
        return tree, q.double(), 8, ladder
    if case == "two_columns":
        return tree, q[:, :2], 8, ladder
    if case == "other_device":
        return tree, q.to("meta"), 8, ladder
    if case == "meta_tree":
        meta = dataclasses.replace(tree, xyz=tree.xyz.to("meta"),
                                   offsets=tree.offsets.to("meta"))
        return meta, q.to("meta"), 8, ladder
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "k0", "k129", "no_rungs", "five_rungs", "radius0", "cpu_tree", "cap0",
    "float64", "two_columns", "other_device", "meta_tree"])
def test_knn_ladder_raises_before_loading(no_library, case):
    tree, q, k, ladder = _bad_inputs(case)
    with pytest.raises(ValueError, match="knn_ladder"):
        kc.knn_ladder(tree, q, k, ladder)


@pytest.mark.parametrize("k", [1, 16, kc.TOPK_MAX + 1])
@pytest.mark.parametrize("periodic", [False, True])
def test_brute_pass_takes_the_unconverged_rows_a_chunk_at_a_time(
        monkeypatch, periodic, k):
    """Rows the rungs leave go to the brute pass at most ``ladder_chunk``
    at a time, whichever route ran the rungs, and get its answer."""
    pts = _points(200, 12)
    tree = KDTree(pts, boxsize=1.0 if periodic else None, device="cpu")._tree
    ladder = ((1, 1 << 14),)  # the rungs are stubbed: the least chunk
    step = knn.ladder_chunk(ladder)
    assert step == 2048
    Q = step + 5
    q = torch.from_numpy(_points(Q, 13) * 1.2 - 0.1)

    def unconverged(tree, queries, k, ladder):  # rungs that certify nothing
        n = queries.shape[0]
        zeros = torch.zeros((n,), dtype=torch.int32)
        return (torch.full((n, k), float("inf")),
                torch.zeros((n, k), dtype=torch.int64),
                torch.zeros((n,), dtype=torch.bool),
                (zeros, zeros.clone(), zeros.clone()))

    rows = []
    brute = knn._streaming_brute_pass

    def counted(xyz, n, queries_w, k, box):
        rows.append(queries_w.shape[0])
        return brute(xyz, n, queries_w, k, box)

    monkeypatch.setattr(kd, "ladder_rungs", unconverged)
    monkeypatch.setattr(kd, "_streaming_brute_pass", counted)
    d2, slot, stats = kd._ladder_query(tree, q, k, ladder, False)
    assert rows == [step, 5]
    box = [1.0] * 3 if periodic else None
    want_d2, want_slot = brute(tree.xyz, tree.n,
                               knn.query_cells(tree, q)[0], k, box)
    assert torch.equal(d2, want_d2)
    assert torch.equal(slot, want_slot)
    assert bool((stats[1] == tree.n).all())
    assert not bool(stats[0].any()) and not bool(stats[2].any())


def test_knn_ladder_signature_matches_the_entry_point():
    src = (_build.CSRC / "knn_ladder.cu").read_text()
    params = re.search(r'extern "C" int knn_ladder\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(_build.SIGNATURES["knn_ladder"])
