"""The sharded pipelines on the card: the cases of
``tests/test_torch_sharded.py`` at one NCCL rank on ``cuda:0``, held to the
single-process port on the same card (k-NN bit for bit, the kNN-CDF
exactly, fields within rtol 2e-5 / atol 1e-6); and the slab-sharded tree's
cases of ``tests/test_torch_tree_sharded.py`` at one NCCL rank (indices
equal, distances within the rounding of its slab-local z) and, for the
hops=0 certificate, at two gloo ranks sharing ``cuda:0``.

Every test here needs an NVIDIA Hopper GPU and ``nvcc`` (marker ``cuda``)
and skips without a CUDA device. The file imports torch only:

    python -m pytest tests/test_torch_sharded_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
import torch_tree_sharded_ranks as TR
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


@pytest.fixture(scope="module")
def tree_ranks(tmp_path_factory):
    """``tree_ranks(nd)``: the sharded tree's answers of every rank, at one
    NCCL rank or two gloo ranks (NCCL takes no two ranks on one GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    done = {}

    def get(nd):
        if nd not in done:
            out = tmp_path_factory.mktemp(f"tree{nd}")
            done[nd] = R.spawn(out, nd, backend="nccl" if nd == 1 else "gloo",
                               device="cuda:0", fn=TR.run)
        return done[nd]

    return get


@pytest.mark.parametrize("case", list(TR.TREE_CASES))
def test_tree_sharded_on_the_card(tree_ranks, case):
    pts, q, k, box = TR.TREE_CASES[case]
    d, i = KDTree(pts, boxsize=box, device="cuda").query(q, k=k)
    got = tree_ranks(1)[0]
    assert int(got[case + "_ov"]) == 0
    np.testing.assert_array_equal(got[case + "_i"], i)
    TR.assert_close_to_single(got[case + "_d"], d, pts, q)


def test_tree_sharded_tensors_stay_on_the_card(tree_ranks):
    pts, q, k, box = TR.TENSOR
    d, i = KDTree(pts, boxsize=box, device="cuda").query_device(q, k=k)
    got = tree_ranks(1)[0]
    assert list(got["tensor_types"]) == ["torch.float32", "torch.int32",
                                         "cuda:0", "cuda:0"]
    assert int(got["tensor_ov"]) == 0
    np.testing.assert_array_equal(got["tensor_i"], i.cpu().numpy())
    TR.assert_close_to_single(got["tensor_d"], d.cpu().numpy(), pts, q)


@pytest.mark.parametrize("nd", (1, 2))
def test_tree_sharded_hops0_certificate(tree_ranks, nd):
    """hops=0: exact with overflow 0 on one rank; on two, every row off
    the exact answer counted in overflow, every rank the same."""
    pts, q, k, box = TR.LIMITED
    _, i = KDTree(pts, boxsize=box, device="cuda").query(q, k=k)
    answers = tree_ranks(nd)
    got = answers[0]
    wrong = int(np.any(got["limited0_i"] != i, axis=1).sum())
    overflow = int(got["limited0_ov"])
    if nd == 1:
        assert overflow == 0 and wrong == 0
    else:
        assert 0 < wrong <= overflow
        for key in ("limited0_d", "limited0_i", "limited0_ov"):
            assert np.array_equal(answers[1][key], got[key]), key
