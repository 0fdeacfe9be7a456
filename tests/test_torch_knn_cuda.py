"""The k-NN candidate kernels (B3 ``knn_topk``; B4's two sinks ``knn_select``
and ``knn_dist``) against their plain PyTorch versions on the card, and
``KDTree`` on the card against ``KDTree`` on the CPU.

Every test here needs an NVIDIA Hopper GPU and ``nvcc`` (marker ``cuda``)
and skips without a CUDA device. The file imports torch only, so it runs on
a machine without JAX:

    python -m pytest tests/test_torch_knn_cuda.py -q --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

import test_torch_knn_select as select
import test_torch_knn_window as window
from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.ops import knn_cuda as kc
from nbodyhpc_tpu_torch.ops import knn_device as kd
from nbodyhpc_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


def _launches(kernel: str) -> int:
    return profiling.counters().get(f"{kernel}.launches", 0)


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
    return tree, plan, st, args, kd.cell_grid(tree, plan)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_topk_kernel_bit_equal_to_plain(cuda, periodic, k):
    _, _, _, args, grid = _staged(cuda, 200_000, 20_000, periodic)
    before = _launches("knn.topk")
    d2, slot = kc.knn_topk(*args, k, grid=grid)
    assert _launches("knn.topk") == before + 1
    rd, rs = kc.knn_topk_reference(*args, k)
    torch.cuda.synchronize()
    assert _bit_equal(d2, rd)
    assert torch.equal(slot, rs)
    assert _launches("knn.topk") == before + 1  # the plain version counts none


@pytest.mark.parametrize("periodic", [False, True])
def test_dist_kernel_bit_equal_to_plain(cuda, periodic):
    _, plan, st, args, _ = _staged(cuda, 200_000, 20_000, periodic)
    ncand = int(plan.points[st.piece_pid.long()].max())
    before = _launches("knn.dist")
    block = kc.knn_dist(*args, ncand)
    assert _launches("knn.dist") == before + 1
    ref = kc.knn_dist_reference(*args, ncand)
    torch.cuda.synchronize()
    assert _bit_equal(block, ref)
    vals, slot = kc.select_block(block, 200, st.pid, plan.run_start,
                                 plan.run_len)
    rv, rsl = kc.select_block(ref, 200, st.pid, plan.run_start, plan.run_len)
    assert _bit_equal(vals, rv) and torch.equal(slot, rsl)
    # rows padded to 32 columns as the engine pads them (vector stores), a
    # width that is no multiple of 4 (scalar stores), and a block that cuts
    # the candidates short
    for width in (-(-ncand // 32) * 32, ncand + 1, ncand - 3, 1000):
        assert _bit_equal(kc.knn_dist(*args, width),
                          kc.knn_dist_reference(*args, width))
    padded = kc.knn_dist(*args, -(-ncand // 32) * 32)
    pv, ps = kc.select_block(padded, 200, st.pid, plan.run_start,
                             plan.run_len)
    assert _bit_equal(pv, rv) and torch.equal(ps, rsl)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [129, 200, kc.SELECT_MAX])
def test_select_kernel_bit_equal_to_plain(cuda, periodic, k):
    _, plan, st, args, _ = _staged(cuda, 200_000, 20_000, periodic)
    assert int(plan.points[st.piece_pid.long()].max()) > 2 * kc.SELECT_LIST
    before = _launches("knn.select"), _launches("knn.dist")
    d2, slot = kc.knn_select(*args, k)
    assert _launches("knn.select") == before[0] + 1
    rd, rs = kc.knn_select_reference(*args, k)
    torch.cuda.synchronize()
    assert _bit_equal(d2, rd)
    assert torch.equal(slot, rs)
    # the plain version counts none, and the sink writes no block
    assert (_launches("knn.select"), _launches("knn.dist")) == (
        before[0] + 1, before[1])
    # a row range of its own, as the block route cuts them
    p0, p1 = 7, 40
    r0 = int(st.piece_q0[p0])
    nr = int(st.piece_q0[p1]) - r0
    sub = (args[0], *(a[p0:p1] for a in args[1:4]), *args[4:])
    sd, ss = kc.knn_select(*sub, k, row_base=r0, nrows=nr)
    assert _bit_equal(sd, rd[r0:r0 + nr]) and torch.equal(ss, rs[r0:r0 + nr])


@pytest.mark.parametrize("k", [129, 200, kc.SELECT_MAX])
@pytest.mark.parametrize("case", select.CASES,
                         ids=["-".join(c) for c in select.CASES])
def test_select_kernel_on_the_cpu_cases(cuda, case, k):
    """B4's selection sink on the CPU tests' cases (a lattice whose rows tie
    at the k-th distance, ZSEG plans, an open box, pieces with fewer than k
    candidates): bit-equal to its plain version and to the CPU mirror of
    its rule; the block sink on the same plans."""
    tree, plan, st = select._staged(*case, 300 + k)
    want_d, want_s, _ = select.mirror_select(tree, plan, st, k)
    args = (st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
            plan.run_start, plan.run_len, tree.xyz)
    ref_d, ref_s = kc.knn_select_reference(*args, plan.box, k)
    assert _bit_equal(want_d, ref_d) and torch.equal(want_s, ref_s)
    on_card = tuple(a.to(cuda) for a in args)
    d2, slot = kc.knn_select(*on_card, plan.box, k)
    torch.cuda.synchronize()
    assert _bit_equal(d2.cpu(), ref_d) and torch.equal(slot.cpu(), ref_s)
    ncand = -(-max(int(plan.points[st.piece_pid.long()].max()), 1) // 32) * 32
    block = kc.knn_dist(*on_card, plan.box, ncand)
    assert _bit_equal(block.cpu(),
                      kc.knn_dist_reference(*args, plan.box, ncand))


def test_kernels_on_a_zseg_plan(cuda):
    _, plan, st, args, grid = _staged(cuda, 20_000, 2_000, True, dense=True)
    assert plan.run_start.shape[1] == 36
    d2, slot = kc.knn_topk(*args, 16, grid=grid)
    rd, rs = kc.knn_topk_reference(*args, 16)
    assert _bit_equal(d2, rd) and torch.equal(slot, rs)
    ncand = int(plan.points[st.piece_pid.long()].max())
    for width in (ncand, -(-ncand // 32) * 32):
        assert _bit_equal(kc.knn_dist(*args, width),
                          kc.knn_dist_reference(*args, width))
    for k in (129, kc.SELECT_MAX):
        d2, slot = kc.knn_select(*args, k)
        rd, rs = kc.knn_select_reference(*args, k)
        assert _bit_equal(d2, rd) and torch.equal(slot, rs)


def test_kernel_wrappers_raise_and_never_fall_back(cuda):
    _, _, _, args, grid = _staged(cuda, 20_000, 9_000, False)
    bad = list(args)
    bad[6] = args[6].double()  # xyz must be float32
    with pytest.raises(ValueError):
        kc.knn_topk(*bad, 8, grid=grid)
    with pytest.raises(ValueError):
        kc.knn_dist(*bad, 100)
    with pytest.raises(ValueError):
        kc.knn_select(*bad, 200)
    for pos in (1, 4):  # piece_q0, run_start must be int32
        bad = list(args)
        bad[pos] = args[pos].long()
        with pytest.raises(ValueError):
            kc.knn_select(*bad, 200)
        with pytest.raises(ValueError):
            kc.knn_dist(*bad, 100)
    with pytest.raises(ValueError):
        kc.knn_select(*args[:6], args[6].cpu(), args[7], 200)
    for k in (0, kc.SELECT_MAX + 1):
        with pytest.raises(ValueError):
            kc.knn_select(*args, k)
    with pytest.raises(ValueError):
        kc.knn_dist(*args, 0)
    # more runs than the kernels take
    wide = torch.zeros((2, kc.MAX_RUNS + 1), dtype=torch.int32, device=cuda)
    for call in (lambda a: kc.knn_select(*a, 200),
                 lambda a: kc.knn_dist(*a, 100)):
        with pytest.raises(ValueError):
            call((*args[:4], wide, wide, *args[6:]))
    with pytest.raises(ValueError):
        kc.knn_topk(*args, 129, grid=grid)
    with pytest.raises(ValueError, match="cells"):
        kc.knn_topk(*args, 8, grid=None)  # the kernel needs the plan's cells
    with pytest.raises(ValueError):
        kc.knn_topk(*args, 8, grid=grid._replace(offsets=grid.offsets.cpu()))


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("case", window.CASES,
                         ids=["-".join(c) for c in window.CASES])
def test_topk_kernel_follows_the_window_rule(cuda, case, k):
    """B3 on the CPU tests' window cases (a lattice, ZSEG plans, an open box,
    3 cells in x, a sparse tree): bit-equal to its plain version, and it
    scans exactly the cells the CPU mirror of its rule scans."""
    tree, plan, st = window._staged(*case, 100 + k)
    want_d, want_s, scanned, held = window.mirror_topk(tree, plan, st, k)
    args = (st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
            plan.run_start, plan.run_len, tree.xyz)
    ref_d, ref_s = kc.knn_topk_reference(*args, plan.box, k)
    assert _bit_equal(want_d, ref_d) and torch.equal(want_s, ref_s)
    grid = kd.cell_grid(tree, plan)
    grid = grid._replace(run_cell=grid.run_cell.to(cuda),
                         run_ncell=grid.run_ncell.to(cuda),
                         offsets=grid.offsets.to(cuda))
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    d2, slot = kc.knn_topk(*(a.to(cuda) for a in args), plan.box, k,
                           grid=grid, counts=counts)
    torch.cuda.synchronize()
    assert _bit_equal(d2.cpu(), ref_d) and torch.equal(slot.cpu(), ref_s)
    assert int(counts[1]) == scanned <= held


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 16, 200, 300])
def test_kdtree_on_the_card_equals_the_cpu(cuda, periodic, k):
    pts = _points(100_000, 11)
    q = _points(10_000, 12)
    box = 1.0 if periodic else None
    # k > 128: cells of 64 points (128 for k = 300), so the r = 1 bound
    # certifies the k-th neighbour and most answers come from B4 (its
    # selection sink at 200, its block above that sink's capacity) rather
    # than the ladder
    leafsize = {1: 128, 16: 128, 200: 1024, 300: 2048}[k]
    gpu = KDTree(torch.from_numpy(pts).to(cuda), boxsize=box,
                 leafsize=leafsize)
    cpu = KDTree(pts, boxsize=box, device="cpu", leafsize=leafsize)
    assert gpu.device.type == "cuda" and cpu.device.type == "cpu"
    kernels = ("knn.topk", "knn.select", "knn.dist")
    before = [_launches(name) for name in kernels]
    d, i = gpu.query_device(torch.from_numpy(q).to(cuda), k=k)
    took = [_launches(name) - b for name, b in zip(kernels, before)]
    assert [t > 0 for t in took] == [k <= 128, 128 < k <= 256, k > 256]
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
