"""The sharded pipelines on the card: the cases of
``tests/test_torch_sharded.py`` at one NCCL rank on ``cuda:0``, held to the
single-process port on the same card (k-NN bit for bit, the kNN-CDF
exactly, fields within rtol 2e-5 / atol 1e-6).

Every test here needs an NVIDIA Hopper GPU and ``nvcc`` (marker ``cuda``)
and skips without a CUDA device. The file imports torch only:

    python -m pytest tests/test_torch_sharded_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.parallel.stats import cdf_queries

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def rank0(tmp_path_factory):
    """The answers of one NCCL rank on ``cuda:0`` (one spawn per module)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for sm_90a)")
    out = tmp_path_factory.mktemp("nccl1")
    return R.spawn(out, 1, backend="nccl", device="cuda:0")[0]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(R.KNN_CASES))
def test_knn_query_sharded_on_the_card(rank0, case):
    pts, q, k, box = R.KNN_CASES[case]
    d, i = KDTree(pts, boxsize=box, device="cuda").query(q, k=k)
    np.testing.assert_array_equal(rank0[case + "_i"], i)
    np.testing.assert_array_equal(_bits(rank0[case + "_d"]), _bits(d))
    np.testing.assert_array_equal(rank0[case + "_wi"], i)


@pytest.mark.parametrize("case", list(R.CDF_CASES))
def test_knn_cdf_sharded_on_the_card(rank0, case):
    pts, box, k, radii, nq, seed = R.CDF_CASES[case]
    tree = KDTree(pts, boxsize=box, device="cuda")
    q, qloc = cdf_queries(tree._tree, nq, 1, seed)
    d, _ = tree.query(q, k=max(k))
    kth = d[:, [kk - 1 for kk in k]]
    r32 = np.asarray(radii, np.float32)
    want = (kth[:, :, None] <= r32[None, None, :]).sum(0).astype(
        np.float32) / qloc
    np.testing.assert_array_equal(rank0[case], want)


@pytest.mark.parametrize("case", list(R.RENDER_CASES))
def test_render_sharded_on_the_card(rank0, case):
    from nbodyhpc_tpu_torch.rasterizer import render_points_volume

    pos, w, r, ppu, grid, periodic, _ = R.RENDER_CASES[case]
    ref = render_points_volume(pos, w, r, ppu, grid, periodic=periodic)
    assert int(rank0[case + "_overflow"]) == 0
    np.testing.assert_allclose(rank0[case], ref, rtol=RTOL, atol=ATOL)
