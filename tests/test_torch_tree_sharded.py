"""The port's slab-sharded k-NN tree (``nbodyhpc_tpu_torch.parallel.
tree_sharded``) against the JAX package's and against the single-process
``KDTree``, on gloo ranks on the CPU.

One ``torch.multiprocessing`` spawn per world size (2 and 4 ranks), the
world of one in this process: every rank runs the cases of
``torch_tree_sharded_ranks`` with ``device="cpu"`` and saves its answers.
Against the JAX function on a JAX mesh of the same size (conftest's virtual
CPU devices) indices and overflow are equal and distances bit-equal: both
compute with slab-local z. Against the single tree, whose distances use
global z, indices are equal and distances within the rounding of the
slab-local coordinates (``assert_close_to_single``).
"""
import jax
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
import torch_tree_sharded_ranks as TR
from nbodyhpc_tpu.parallel.mesh import make_slab_mesh as jax_mesh
from nbodyhpc_tpu.parallel.tree_sharded import (
    build_tree_sharded as jax_build,
    knn_query_tree_sharded as jax_query,
)
from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.parallel.mesh import make_slab_mesh
from nbodyhpc_tpu_torch.parallel.tree_sharded import (
    build_tree_sharded,
    knn_query_tree_sharded,
)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def jax_trees():
    """``tree(case)``: the JAX tree of a JAX case on a mesh of its world
    size (one build per point set)."""
    done = {}

    def get(case):
        pts, _, _, box, _, _, nd = TR.JAX_CASES[case]
        key = (TR.JAX_CASES[case][0].tobytes(), box, nd)
        if key not in done:
            done[key] = jax_build(pts, boxsize=box,
                                  mesh=jax_mesh(jax.devices()[:nd]))
        return done[key]

    return get


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_trees):
    """``ranks(nd)``: every rank's answers at ``nd`` ranks (one spawn per
    world size). The 4-rank spawn reads "jax_capped"'s JAX tree from a
    file written here."""
    done = {}

    def get(nd):
        if nd not in done:
            out = tmp_path_factory.mktemp(f"tree{nd}")
            if nd == 4:
                st = jax_trees("jax_capped")
                np.savez(out / "jax_tree.npz", **{
                    key: np.asarray(getattr(st, key)) if key != "boxsize"
                    or st.boxsize is not None else np.zeros(3)
                    for key in TR.JAX_TREE_FIELDS})
            done[nd] = R.spawn(out, nd, fn=TR.run)
        return done[nd]

    return get


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("nd", WORLDS)
def test_every_rank_returns_the_same(ranks, nd):
    answers = ranks(nd)
    shared = [key for key in answers[0]
              if not key.endswith(("_xyz", "_index", "_offsets",
                                   "_escalated", "_brute", "_sent"))]
    for r in range(1, nd):
        for key in shared:
            assert np.array_equal(answers[r][key], answers[0][key]), (key, r)


@pytest.mark.parametrize("case", list(TR.JAX_CASES))
def test_matches_jax(ranks, jax_trees, case):
    """Indices, bit patterns of the distances and overflow equal to the JAX
    function on a JAX mesh of the same size ("jax_one": a world of one in
    this process; "jax_capped": hops=1, cap=8 on the JAX tree carried
    across, so overflow > 0)."""
    _, q, k, box, hops, cap, nd = TR.JAX_CASES[case]
    d, i, ov = jax_query(jax_trees(case), q, k, hops=hops, cap=cap)
    if nd == 1:
        pts = TR.JAX_CASES[case][0]
        st = build_tree_sharded(pts, boxsize=box,
                                mesh=make_slab_mesh(device="cpu"))
        got_d, got_i, got_ov = knn_query_tree_sharded(st, q, k, hops=hops,
                                                      cap=cap)
    else:
        got = ranks(nd)[0]
        got_d, got_i, got_ov = (got[case + "_d"], got[case + "_i"],
                                int(got[case + "_ov"]))
    assert got_i.dtype == np.uint32 and got_d.shape == (q.shape[0], k)
    np.testing.assert_array_equal(got_i, i)
    np.testing.assert_array_equal(_bits(got_d), _bits(d))
    assert got_ov == ov
    assert (ov > 0) == (case == "jax_capped")


@pytest.mark.parametrize("case", ["jax_open", "jax_periodic"])
def test_each_rank_builds_the_jax_shard(ranks, jax_trees, case):
    st = jax_trees(case)
    nd = TR.JAX_CASES[case][6]
    for s, got in enumerate(ranks(nd)):
        np.testing.assert_array_equal(_bits(got[case + "_xyz"]),
                                      _bits(np.asarray(st.xyz)[s]))
        np.testing.assert_array_equal(got[case + "_index"],
                                      np.asarray(st.index)[s].astype(np.int32))
        np.testing.assert_array_equal(got[case + "_offsets"],
                                      np.asarray(st.offsets)[s])
        np.testing.assert_array_equal(got[case + "_counts"], st.counts)
        assert int(got[case + "_max_cell_count"]) == st.max_cell_count


@pytest.mark.parametrize("case", list(TR.TREE_CASES))
@pytest.mark.parametrize("nd", WORLDS)
def test_matches_single_tree(ranks, nd, case):
    pts, q, k, box = TR.TREE_CASES[case]
    dref, iref = KDTree(pts, boxsize=box, device="cpu").query(q, k=k)
    got = ranks(nd)[0]
    assert int(got[case + "_ov"]) == 0
    np.testing.assert_array_equal(got[case + "_i"], iref)
    TR.assert_close_to_single(got[case + "_d"], dref, pts, q)


@pytest.mark.parametrize("nd", WORLDS)
def test_hops_and_backstop_are_exercised(ranks, nd):
    """The slab-face queries are sent to other slabs, and k above a slab's
    population takes the ladder's rungs and its brute backstop."""
    answers = ranks(nd)
    assert all(int(a["faces_sent"]) > 0 for a in answers[:-1])
    assert sum(int(a["deep_escalated"]) for a in answers) > 0
    assert sum(int(a["deep_brute"]) for a in answers) > 0


@pytest.mark.parametrize("hops", (0, 1))
@pytest.mark.parametrize("nd", WORLDS)
def test_limited_hops_certify(ranks, nd, hops):
    """A row that differs from the exact answer is counted in overflow; at
    2 ranks one hop reaches every slab."""
    pts, q, k, box = TR.LIMITED
    _, iref = KDTree(pts, boxsize=box, device="cpu").query(q, k=k)
    got = ranks(nd)[0]
    key = f"limited{hops}"
    wrong = int(np.any(got[key + "_i"] != iref, axis=1).sum())
    overflow = int(got[key + "_ov"])
    assert wrong <= overflow
    if hops == 0:
        assert wrong > 0
    elif nd == 2:
        assert overflow == 0 and wrong == 0


@pytest.mark.parametrize("nd", WORLDS)
def test_tensors_in_give_tensors_out(ranks, nd):
    pts, q, k, box = TR.TENSOR
    d, i = KDTree(pts, boxsize=box, device="cpu").query_device(q, k=k)
    got = ranks(nd)[0]
    assert list(got["tensor_types"]) == ["torch.float32", "torch.int32",
                                         "cpu", "cpu"]
    assert int(got["tensor_ov"]) == 0
    np.testing.assert_array_equal(got["tensor_i"], i.numpy())
    TR.assert_close_to_single(got["tensor_d"], d.numpy(), pts, q)


def test_tensor_build_equals_array_build():
    """Points as a tensor (slabs by the multiplication, on the device) and
    as an array (by the division, on the host): the same tree here."""
    pts, q, k, box = TR.TENSOR
    mesh = make_slab_mesh(device="cpu")
    a = build_tree_sharded(pts, boxsize=box, mesh=mesh)
    t = build_tree_sharded(torch.from_numpy(pts), boxsize=box, mesh=mesh)
    for key in ("xyz", "index", "offsets"):
        assert torch.equal(getattr(a, key), getattr(t, key)), key
    assert np.array_equal(a.counts, t.counts)
    for key in ("dims_loc", "lo", "cell_size", "slab_depth", "n",
                "max_cell_count"):
        assert getattr(a, key) == getattr(t, key), key


@pytest.mark.parametrize("nd", WORLDS)
def test_tensor_build_equals_array_build_on_ranks(ranks, nd):
    """The same at 2 and 4 ranks, where the two slab assignments decide
    which rank keeps a point; a quarter of the points lie on the periodic
    box's slab faces."""
    for got in ranks(nd):
        for name in TR.BUILDS:
            for key in ("xyz", "index", "offsets", "counts"):
                a = got[f"{name}_array_{key}"]
                t = got[f"{name}_tensor_{key}"]
                assert a.dtype == t.dtype and np.array_equal(a, t), (name,
                                                                     key)
            assert got[f"{name}_array_counts"].min() > 0


def test_empty_queries():
    mesh = make_slab_mesh(device="cpu")
    st = build_tree_sharded(TR.points(100, 1), boxsize=1.0, mesh=mesh)
    d, i, ov = knn_query_tree_sharded(st, np.zeros((0, 3), np.float32), 4)
    assert d.shape == (0, 4) and d.dtype == np.float32
    assert i.shape == (0, 4) and i.dtype == np.uint32 and ov == 0
    d, i, ov = knn_query_tree_sharded(st, torch.zeros((0, 3)), 4)
    assert torch.is_tensor(d) and d.shape == (0, 4) and i.dtype == torch.int32


@pytest.mark.parametrize("bad", ["k", "box", "shape"])
def test_errors(bad):
    mesh = make_slab_mesh(device="cpu")
    pts = TR.points(100, 2)
    if bad == "box":
        with pytest.raises(ValueError, match="contained in the box"):
            build_tree_sharded(pts * 2.0, boxsize=1.0, mesh=mesh)
        return
    st = build_tree_sharded(pts, mesh=mesh)
    with pytest.raises(ValueError):
        if bad == "k":
            knn_query_tree_sharded(st, pts[:4], 0)
        else:
            knn_query_tree_sharded(st, pts[:4, :2], 1)


def test_build_needs_a_card_or_a_mesh():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tree_sharded(TR.points(10, 3))
