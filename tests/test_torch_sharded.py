"""The port's sharded pipelines (``nbodyhpc_tpu_torch.parallel``) against the
JAX package's, on gloo ranks on the CPU.

One ``torch.multiprocessing.spawn`` per world size (2 and 4 ranks): every
rank runs every case of ``torch_sharded_ranks`` with ``device="cpu"`` (the
kernels' plain versions) and saves its answers; the tests here compare
them, in this process, with the JAX functions on a JAX mesh of the same
size (conftest's 8 virtual CPU devices). k-NN is held bit for bit and the
kNN-CDF exactly; fields within rtol 2e-5 / atol 1e-6 (plus the subcell
quantum, for radii of 4 px and more).
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from nbodyhpc_tpu.kdtree import KDTree as JaxKDTree
from nbodyhpc_tpu.parallel.mesh import make_slab_mesh as jax_mesh
from nbodyhpc_tpu.parallel.sharded import (
    knn_query_sharded as jax_knn_query_sharded,
    render_points_volume_sharded as jax_render_sharded,
)
from nbodyhpc_tpu.parallel.stats import knn_cdf_sharded as jax_knn_cdf_sharded
from nbodyhpc_tpu.rasterizer import render_points_volume as jax_render
from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.parallel.mesh import SlabMesh, make_slab_mesh
from nbodyhpc_tpu_torch.parallel.sharded import (
    knn_query_sharded,
    render_points_volume_sharded,
)
from nbodyhpc_tpu_torch.parallel.stats import knn_cdf_sharded
from nbodyhpc_tpu_torch.rasterizer import Container, PointRenderer
from test_splat_dense import _quantum_atol

RTOL, ATOL = 2e-5, 1e-6
REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(nd)``: every rank's answers at ``nd`` ranks (one spawn per
    world size for the whole module)."""
    done = {}

    def get(nd):
        if nd not in done:
            done[nd] = R.spawn(tmp_path_factory.mktemp(f"ranks{nd}"), nd)
        return done[nd]

    return get


def _mesh(nd):
    return jax_mesh(jax.devices()[:nd])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("nd", WORLDS)
def test_every_rank_returns_the_same(ranks, nd):
    answers = ranks(nd)
    for r in range(1, nd):
        assert answers[r].keys() == answers[0].keys()
        for key, val in answers[0].items():
            assert np.array_equal(answers[r][key], val), (key, r)


@pytest.mark.parametrize("case", list(R.KNN_CASES))
@pytest.mark.parametrize("nd", WORLDS)
def test_knn_query_sharded_matches_jax(ranks, nd, case):
    pts, q, k, box = R.KNN_CASES[case]
    tree = JaxKDTree(pts, boxsize=box)
    d, i = jax_knn_query_sharded(tree._tree, tree._dev, q, k, mesh=_mesh(nd))
    got = ranks(nd)[0]
    assert got[case + "_d"].shape == (q.shape[0], k)
    np.testing.assert_array_equal(got[case + "_i"], i)
    np.testing.assert_array_equal(_bits(got[case + "_d"]), _bits(d))


@pytest.mark.parametrize("case", list(R.KNN_CASES))
@pytest.mark.parametrize("nd", WORLDS)
def test_query_workers_in_a_group_equals_one_worker(ranks, nd, case):
    got = ranks(nd)[0]
    assert got[case + "_wi"].dtype == np.uint32
    np.testing.assert_array_equal(got[case + "_wi"], got[case + "_1i"])
    np.testing.assert_array_equal(_bits(got[case + "_wd"]),
                                  _bits(got[case + "_1d"]))
    np.testing.assert_array_equal(got[case + "_wi"], got[case + "_i"])


@pytest.mark.parametrize("case", list(R.CDF_CASES))
@pytest.mark.parametrize("nd", WORLDS)
def test_knn_cdf_sharded_equals_jax(ranks, nd, case):
    pts, box, k, radii, nq, seed = R.CDF_CASES[case]
    tree = JaxKDTree(pts, boxsize=box)
    r_ref, cdf_ref = jax_knn_cdf_sharded(tree._tree, tree._dev, k, radii,
                                         n_queries=nq, mesh=_mesh(nd),
                                         seed=seed)
    got = ranks(nd)[0]
    assert got[case].dtype == cdf_ref.dtype
    np.testing.assert_array_equal(got[case + "_r"], r_ref)
    np.testing.assert_array_equal(got[case], cdf_ref)
    assert 0.0 < got[case].max() <= 1.0


#: the halo depth each render case must reach at 4 ranks
HOPS_AT_4 = {"render_two_slabs": 2, "render_dense": 3, "render_dryrun": 2}


@pytest.mark.parametrize("case", list(R.RENDER_CASES))
@pytest.mark.parametrize("nd", WORLDS)
def test_render_sharded_matches_jax(ranks, nd, case):
    pos, w, r, ppu, grid, periodic, _ = R.RENDER_CASES[case]
    ref = jax_render(pos, w, r, ppu, grid, periodic=periodic)
    got = ranks(nd)[0]
    assert int(got[case + "_overflow"]) == 0
    assert got[case].shape == tuple(grid)
    np.testing.assert_allclose(got[case], ref, rtol=RTOL,
                               atol=ATOL + _quantum_atol(w, r * ppu))
    want_hops = HOPS_AT_4.get(case, 1) if nd == 4 else 1
    assert int(got[case + "_hops"]) == want_hops


def test_render_sharded_matches_jax_sharded_dryrun(ranks):
    """The one case through the JAX sharded render itself (interpret-mode
    Pallas per shard: about a minute on one core), at 2 ranks."""
    pos, w, r, ppu, grid = R.dryrun_inputs(2)
    ref, overflow = jax_render_sharded(pos, w, r, ppu, grid, periodic=True,
                                       mesh=_mesh(2), band_cap=2048)
    assert overflow == 0
    got = ranks(2)[0]
    assert int(got["render_dryrun_overflow"]) == 0
    np.testing.assert_allclose(got["render_dryrun"], ref, rtol=RTOL,
                               atol=ATOL)


def test_world_of_one_equals_the_single_process_port():
    """No process group: every function runs as a world of one."""
    mesh = make_slab_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1,
                                                                None)
    pos, w, r, ppu, grid, periodic, _ = R.RENDER_CASES["render_periodic"]
    vol, overflow = render_points_volume_sharded(pos, w, r, ppu, grid,
                                                 periodic=periodic, mesh=mesh)
    one = PointRenderer(Container(device="cpu"), grid[1], grid[0],
                        engine="cuda").render_points_volume(
        pos, w, r, grid[2], ppu, period=(1.0, 1.0, 1.0))
    assert overflow == 0
    np.testing.assert_allclose(vol, one, rtol=RTOL, atol=ATOL)
    pts, q, k, box = R.KNN_CASES["knn_periodic"]
    tree = KDTree(pts, boxsize=box, device="cpu")
    d, i = knn_query_sharded(tree._tree, q, k)
    d1, i1 = tree.query(q, k=k)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(_bits(d), _bits(d1))


def test_knn_cdf_world_of_one_equals_jax_on_one_device():
    pts, box, k, radii, nq, seed = R.CDF_CASES["cdf_periodic"]
    tree = KDTree(pts, boxsize=box, device="cpu")
    _, cdf = knn_cdf_sharded(tree._tree, k, radii, n_queries=nq, seed=seed)
    jt = JaxKDTree(pts, boxsize=box)
    _, ref = jax_knn_cdf_sharded(jt._tree, jt._dev, k, radii, n_queries=nq,
                                 mesh=_mesh(1), seed=seed)
    np.testing.assert_array_equal(cdf, ref)


def test_query_workers_without_a_group_is_the_single_path():
    pts, q, k, box = R.KNN_CASES["knn_open"]
    tree = KDTree(pts, boxsize=box, device="cpu")
    d, i = tree.query(q, k=k, workers=-1)
    d1, i1 = tree.query(q, k=k)
    assert i.dtype == np.uint32
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(_bits(d), _bits(d1))


def test_make_slab_mesh_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_slab_mesh()
    assert make_slab_mesh(device="cpu").device == torch.device("cpu")


def test_mesh_and_tree_must_share_a_device():
    pts, q, k, box = R.KNN_CASES["knn_open"]
    tree = KDTree(pts, boxsize=box, device="cpu")
    mesh = SlabMesh(None, 0, 1, torch.device("meta"), None)
    with pytest.raises(ValueError, match="the tree lives on"):
        knn_query_sharded(tree._tree, q, k, mesh=mesh)


def test_grid_z_must_divide_over_the_ranks():
    mesh = SlabMesh(None, 0, 3, torch.device("cpu"), None)
    pos, w, r, ppu, grid, periodic, _ = R.RENDER_CASES["render_open"]
    with pytest.raises(ValueError, match="must divide over 3"):
        render_points_volume_sharded(pos, w, r, ppu, grid, mesh=mesh)


def test_parallel_and_chip_smoke_import_no_jax():
    code = ("import sys, nbodyhpc_tpu_torch.parallel, "
            "nbodyhpc_tpu_torch.parallel.mesh, "
            "nbodyhpc_tpu_torch.parallel.sharded, "
            "nbodyhpc_tpu_torch.parallel.stats, chip_smoke; "
            "sys.path.insert(0, 'tests'); import torch_sharded_ranks; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'nbodyhpc_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
