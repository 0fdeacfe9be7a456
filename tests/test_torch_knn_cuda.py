"""The k-NN candidate kernels (B3 ``knn_topk``, B4 ``knn_dist``) against
their plain PyTorch versions on the card, and ``KDTree`` on the card against
``KDTree`` on the CPU.

Every test here needs an NVIDIA Hopper GPU and ``nvcc`` (marker ``cuda``)
and skips without a CUDA device. The file imports torch only, so it runs on
a machine without JAX:

    python -m pytest tests/test_torch_knn_cuda.py -q --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.ops import knn_cuda as kc
from nbodyhpc_tpu_torch.ops import knn_device as kd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for sm_90a)")
    return torch.device("cuda")


def _points(n, seed):
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.random((n, 3)).astype(np.float32)


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _staged(device, n, nq, periodic, dense=False, seed=3):
    pts = _points(n, seed)
    if dense:
        pts[:, :2] *= 1e-3  # one thin column: the ZSEG plan
    tree = KDTree(torch.from_numpy(pts).to(device),
                  boxsize=1.0 if periodic else None)._tree
    plan = kd.tree_plan(tree)
    assert plan.fullz != dense
    q = torch.from_numpy(_points(nq, seed + 1)).to(device)
    if dense:
        q[:, :2] *= 1e-3
    st = kd._stage_sort(tree, plan, q)
    args = (st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
            plan.run_start, plan.run_len, tree.xyz, plan.box)
    return tree, plan, st, args


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_topk_kernel_bit_equal_to_plain(cuda, periodic, k):
    _, _, _, args = _staged(cuda, 200_000, 20_000, periodic)
    before = kc.knn_topk.launches
    d2, slot = kc.knn_topk(*args, k)
    assert kc.knn_topk.launches == before + 1
    rd, rs = kc.knn_topk_reference(*args, k)
    torch.cuda.synchronize()
    assert _bit_equal(d2, rd)
    assert torch.equal(slot, rs)
    assert kc.knn_topk.launches == before + 1  # the plain version counts none


@pytest.mark.parametrize("periodic", [False, True])
def test_dist_kernel_bit_equal_to_plain(cuda, periodic):
    _, plan, st, args = _staged(cuda, 200_000, 20_000, periodic)
    ncand = int(plan.points[st.piece_pid.long()].max())
    before = kc.knn_dist.launches
    block = kc.knn_dist(*args, ncand)
    assert kc.knn_dist.launches == before + 1
    ref = kc.knn_dist_reference(*args, ncand)
    torch.cuda.synchronize()
    assert _bit_equal(block, ref)
    vals, slot = kc.select_block(block, 200, st.pid, plan.run_start,
                                 plan.run_len)
    rv, rsl = kc.select_block(ref, 200, st.pid, plan.run_start, plan.run_len)
    assert _bit_equal(vals, rv) and torch.equal(slot, rsl)


def test_kernels_on_a_zseg_plan(cuda):
    _, plan, st, args = _staged(cuda, 20_000, 2_000, True, dense=True)
    assert plan.run_start.shape[1] == 36
    d2, slot = kc.knn_topk(*args, 16)
    rd, rs = kc.knn_topk_reference(*args, 16)
    assert _bit_equal(d2, rd) and torch.equal(slot, rs)
    ncand = int(plan.points[st.piece_pid.long()].max())
    assert _bit_equal(kc.knn_dist(*args, ncand),
                      kc.knn_dist_reference(*args, ncand))


def test_kernel_wrappers_raise_and_never_fall_back(cuda):
    _, _, _, args = _staged(cuda, 20_000, 9_000, False)
    bad = list(args)
    bad[6] = args[6].double()  # xyz must be float32
    with pytest.raises(ValueError):
        kc.knn_topk(*bad, 8)
    with pytest.raises(ValueError):
        kc.knn_dist(*bad, 100)
    with pytest.raises(ValueError):
        kc.knn_topk(*args, 129)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 16, 200])
def test_kdtree_on_the_card_equals_the_cpu(cuda, periodic, k):
    pts = _points(100_000, 11)
    q = _points(10_000, 12)
    box = 1.0 if periodic else None
    # k > 128: cells of 64 points, so the r = 1 bound certifies the k-th
    # neighbour and most answers come from B4 rather than the ladder
    leafsize = 1024 if k > 128 else 128
    gpu = KDTree(torch.from_numpy(pts).to(cuda), boxsize=box,
                 leafsize=leafsize)
    cpu = KDTree(pts, boxsize=box, device="cpu", leafsize=leafsize)
    assert gpu.device.type == "cuda" and cpu.device.type == "cpu"
    launches = kc.knn_topk.launches + kc.knn_dist.launches
    d, i = gpu.query_device(torch.from_numpy(q).to(cuda), k=k)
    assert kc.knn_topk.launches + kc.knn_dist.launches > launches
    assert kd.query_blocks_device.ladder_queries < len(q) // 2
    rd, ri = cpu.query_device(torch.from_numpy(q), k=k)
    assert _bit_equal(d.cpu(), rd)
    # equal distances inside the k may come in another candidate order on
    # the two routes; there the index sets agree
    same = (i.cpu() == ri).all(1)
    tied = (rd[:, 1:] == rd[:, :-1]).any(1)
    same_set = (i.cpu().sort(1).values == ri.sort(1).values).all(1)
    assert bool((same | (tied & same_set)).all())
    nd, ni = gpu.query(q, k=k)
    assert np.array_equal(nd, d.cpu().numpy())
    assert np.array_equal(ni, i.cpu().numpy().astype(np.uint32))
