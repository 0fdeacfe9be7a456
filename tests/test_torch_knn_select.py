"""The selection sink of the distance kernel (``knn_cuda.knn_select``, kernel
``csrc/knn_dist.cu``), pinned on the CPU.

The kernel keeps, per query row, a list of 64-bit keys ``(d2 bits << 32) |
candidate position`` in shared memory. Candidates arrive in ascending
position, 32 at a time within tiles of 1024; one enters only if its d2 bits
lie strictly below the row's bound ``tau``; when fewer than 32 slots of the
512 are free, a bit-by-bit bisection finds a key bound that at least k keys
respect, stops once at most k + (512 - k) / 4 pass (ties resolve down to the
position bits), keeps those and lowers ``tau``. A last compaction without
slack, a sort and the decode of positions to tree slots give the answer. A
numpy mirror of exactly those steps must equal the sink's plain version
``knn_select_reference`` (every distance, a stable sort) bit for bit:

- on random inputs and on a lattice, where most distances tie;
- periodic and open boxes, FULLZ and ZSEG plans (forced z-segments, and a
  dense tree whose own plan is ZSEG);
- rows whose piece holds fewer than k candidates;
- k in {129, 200, 256 (the sink's capacity)}.

Then the plain version against the JAX package: ``_run_knn`` in interpret
mode plus ``_topk_blocks``, and ``KDTree`` at k = 200 (the sink's route) and
k = 300 (above its capacity: the distance block and a stable sort). Those
tests import the JAX package inside their bodies: the card-only tests reuse
this file's mirror and cases on a machine that has no JAX.
"""
import re

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch import _build
from nbodyhpc_tpu_torch.core.cells import build_cell_list
from nbodyhpc_tpu_torch.kdtree import KDTree as TKDTree
from nbodyhpc_tpu_torch.ops import knn_cuda as tkc
from nbodyhpc_tpu_torch.ops import knn_device as tkd



def kernel_constants():
    """The ``constexpr int`` constants of ``csrc/knn_dist.cu`` that follow
    from that file alone, by name: the mirror below reads the kernel's own
    sizes, so it cannot drift from the source."""
    src = (_build.CSRC / "knn_dist.cu").read_text()
    vals = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        try:
            vals[name] = eval(expr.replace("/", "//"), {"__builtins__": {}},
                              vals)
        except NameError:   # built on a constant of another header
            pass
    return vals


KERNEL = kernel_constants()
CAP = KERNEL["kCap"]    # keys per row list
TILE = KERNEL["kTile"]  # candidate positions per tile
WARP = 32
INF_BITS = 0x7F800000


def test_wrapper_constants_are_the_kernels():
    """``knn_cuda`` states the list length and the capacity that the source
    compiles in; the tile holds whole steps of the warp."""
    assert tkc.SELECT_LIST == KERNEL["kCap"]
    assert tkc.SELECT_MAX == KERNEL["kSelectMax"] == KERNEL["kCap"] // 2
    assert KERNEL["kKeysPerLane"] * WARP == KERNEL["kCap"]
    assert KERNEL["kTile"] % (WARP * KERNEL["kChunks"]) == 0
    assert KERNEL["kRows"] == KERNEL["kWarps"] * KERNEL["kRowsPerWarp"]


def _compact(keys, tau, k, slack, log):
    """The kernel's ``compact``: (kept keys, tau)."""
    cnt = len(keys)
    if cnt <= k + slack:
        return keys, tau
    mn, mx = int(keys.min()), int(keys.max())
    top = (mn ^ mx).bit_length() - 1
    below = (2 << top) - 1
    prefix, ub, h = mx & ~below, mx | below, cnt
    b = top
    while b >= 0 and h > k + slack:
        trial = prefix | (1 << b)
        c = int((keys < np.uint64(trial)).sum())
        if c >= k:
            ub, h = trial - 1, c
        else:
            prefix = trial
        b -= 1
    kept = keys[keys <= np.uint64(ub)]
    assert k <= len(kept) == h <= max(k + slack, k)
    log.append((slack, b + 1))
    return kept, min(ub >> 32, INF_BITS)


def mirror_row(bits, k, log):
    """The kernel's selection over one row's d2 bits (uint32, one entry per
    candidate position): the kept keys, ascending."""
    slack = (CAP - k) // 4
    keys = np.empty(0, np.uint64)
    tau = INF_BITS
    total = len(bits)
    for lo in range(0, total, TILE):
        n = min(TILE, total - lo)
        for base in range(0, n, WARP):
            pos = np.arange(lo + base, lo + min(base + WARP, n))
            d = bits[pos]
            enter = d < tau
            if not enter.any():
                continue
            new = (d[enter].astype(np.uint64) << np.uint64(32)) | pos[
                enter].astype(np.uint64)
            keys = np.concatenate([keys, new])
            assert len(keys) <= CAP
            if len(keys) > CAP - WARP:
                keys, tau = _compact(keys, tau, k, slack, log)
    keys, _ = _compact(keys, tau, k, 0, log)
    return np.sort(keys)


def mirror_select(tree, plan, st, k):
    """(d2 [Q, k], slot [Q, k], compaction log) of the kernel's rule on every
    sorted query row; the log holds (slack, lowest bit decided) of every
    compaction that cut a list."""
    args = (st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
            plan.run_start, plan.run_len, tree.xyz, plan.box)
    ncand = max(int(plan.points[st.piece_pid.long()].max()), 1)
    block = tkc.knn_dist_reference(*args, ncand).numpy().view(np.uint32)
    Q = st.qs.shape[0]
    out_d = np.full((Q, k), INF_BITS, np.uint32)
    out_s = np.full((Q, k), -1, np.int32)
    starts, lens = plan.run_start.numpy(), plan.run_len.numpy()
    log = []
    for row in range(Q):
        pid = int(st.pid[row])
        ends = np.cumsum(lens[pid])
        keys = mirror_row(block[row, :ends[-1]], k, log)
        m = len(keys)
        assert m == min(k, ends[-1])
        pos = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
        # cand_slot: the first run whose end lies past the position
        r = np.searchsorted(ends, pos, side="right")
        out_d[row, :m] = (keys >> np.uint64(32)).astype(np.uint32)
        out_s[row, :m] = starts[pid][r] + pos - (ends - lens[pid])[r]
    return (torch.from_numpy(out_d.view(np.float32)), torch.from_numpy(out_s),
            log)


# (plan, box, inputs): plan "fullz" (the tree's own), "zseg" (3-cell
# z-segments forced on it) or "dense" (a thin column, whose own plan is
# ZSEG); "sparse" inputs hold 2 points per cell, so no piece reaches k
# candidates; the others hold 32 per cell, 1,728 to 2,880 candidates a piece
CASES = [
    ("fullz", "periodic", "random"), ("fullz", "periodic", "lattice"),
    ("fullz", "open", "random"), ("fullz", "open", "lattice"),
    ("zseg", "periodic", "random"), ("zseg", "open", "lattice"),
    ("dense", "periodic", "random"),
    ("fullz", "periodic", "sparse"), ("fullz", "open", "sparse"),
]
NQ = 48
DIMS = 6


def _staged(plan_kind, box_kind, kind, seed):
    rng = np.random.Generator(np.random.Philox(seed))
    per_cell = 2 if kind == "sparse" else 32
    n = 20_000 if plan_kind == "dense" else per_cell * DIMS ** 3
    if kind == "lattice":
        pts = rng.integers(0, 2 * DIMS, (n, 3)) / (2 * DIMS)
        q = rng.integers(0, 2 * DIMS, (NQ, 3)) / (2 * DIMS)
    else:
        pts = rng.random((n, 3))
        q = rng.random((NQ, 3))
    q[:NQ // 2] = pts[rng.integers(0, n, NQ // 2)]
    if box_kind == "open":
        q[-6:] = rng.random((6, 3)) * 1.6 - 0.3   # some outside the points
    if plan_kind == "dense":
        pts[:, :2] *= 1e-3
        q[:, :2] *= 1e-3
    tree = build_cell_list(torch.from_numpy(pts.astype(np.float32)),
                           boxsize=None if box_kind == "open" else 1.0,
                           occupancy=float(per_cell))
    plan = tkd.tree_plan(tree)
    if plan_kind == "dense":
        assert not plan.fullz
    else:
        assert plan.fullz and tree.dims.tolist() == [DIMS] * 3
    if plan_kind == "zseg":
        zseg, nseg, npair = 3, DIMS // 3, (DIMS * DIMS + 1) // 2
        s, ln, cells, c0, nc = tkd._build_static_tables(tree, zseg, nseg,
                                                        npair)
        plan = tkd.KernelPlan(False, zseg, nseg, s, ln, cells,
                              ln.sum(1, dtype=torch.int32), plan.box, c0, nc)
    st = tkd._stage_sort(tree, plan,
                         torch.from_numpy(q.astype(np.float32)))
    return tree, plan, st


@pytest.mark.parametrize("k", [129, 200, tkc.SELECT_MAX])
@pytest.mark.parametrize("plan_kind,box_kind,kind", CASES,
                         ids=["-".join(c) for c in CASES])
def test_selection_rule_equals_stable_sort(plan_kind, box_kind, kind, k):
    tree, plan, st = _staged(plan_kind, box_kind, kind, 300 + k)
    d2, slot, log = mirror_select(tree, plan, st, k)
    args = (st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
            plan.run_start, plan.run_len, tree.xyz, plan.box)
    want_d, want_s = tkc.knn_select_reference(*args, k + 1)
    assert torch.equal(d2.view(torch.int32), want_d[:, :k].view(torch.int32))
    assert torch.equal(slot, want_s[:, :k])
    # the wrapper takes the plain version for CPU tensors
    got_d, got_s = tkc.knn_select(*args, k)
    assert torch.equal(got_d.view(torch.int32), d2.view(torch.int32))
    assert torch.equal(got_s, slot)
    finite = torch.isfinite(want_d)
    if kind == "sparse":
        # no piece holds k candidates: nothing is ever compacted
        assert not log and not bool(finite[:, k - 1].any())
        assert bool((slot[:, -1] == -1).all())
        return
    # lists were cut while candidates still arrived, and again at the end
    assert any(slack > 0 for slack, _ in log)
    assert any(slack == 0 for slack, _ in log)
    if kind == "lattice":
        # rows tie at the k-th distance, and some compaction had to decide
        # position bits to cut a list of equal distances
        assert bool(((want_d[:, k - 1] == want_d[:, k]) & finite[:, k]).any())
        assert min(b for _, b in log) < 32
    else:
        # distinct distances: no cut with slack reads the position bits
        assert min(b for slack, b in log if slack > 0) >= 32


def test_select_wrapper_refuses_bad_inputs():
    q = torch.zeros((3, 4))
    one = torch.zeros(1, dtype=torch.int32)
    runs = torch.zeros((1, 6), dtype=torch.int32)
    xyz = torch.zeros((4, 8))
    for k in (0, tkc.SELECT_MAX + 1):
        with pytest.raises(ValueError, match="k must be"):
            tkc.knn_select(q, one, one, one, runs, runs, xyz, (0.0,) * 3, k)
    with pytest.raises(ValueError, match="one device"):
        tkc.knn_select(q, one, one, one, runs, runs,
                       xyz.double().to("meta"), (0.0,) * 3, 130)
    with pytest.raises(ValueError, match="unsupported device"):
        tkc.knn_select(*(t.to("meta") for t in (q, one, one, one, runs, runs,
                                                xyz)), (0.0,) * 3, 130)
    assert tkc.TOPK_MAX < tkc.SELECT_MAX and tkc.SELECT_MAX >= 256


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [130, 200])
def test_select_plain_matches_pallas_and_topk_blocks(periodic, k):
    """The selection sink's plain version against ``_run_knn`` (interpret)
    plus ``_topk_blocks``: bit-equal d2, equal slots; piece 1 holds 160
    candidates, so at k = 200 its rows end in inf / -1."""
    from test_torch_knn_kernels import (
        assert_equals_topk_blocks,
        pallas_dist_block,
    )

    d2j, runs, geom, _, args, _ = pallas_dist_block(periodic)
    for fn in (tkc.knn_select, tkc.knn_select_reference):
        vals, slot = fn(*args, k)
        assert_equals_topk_blocks(vals, slot, d2j, runs, geom, k)
    if k > 160:
        assert bool(torch.isinf(vals[20:, 160:]).all())
        assert bool(torch.isfinite(vals[:20]).all())


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [200, 300])
def test_kdtree_above_128_matches_jax(periodic, k, monkeypatch):
    """``KDTree(device="cpu").query_device(engine="kernel")`` against the JAX
    ``KDTree``, bit for bit: k = 200 goes through ``knn_select``, k = 300
    (above its capacity) through ``knn_dist`` blocks padded to 32 columns
    and the stable-sort selection."""
    from nbodyhpc_tpu.kdtree import KDTree as JKDTree
    from test_torch_knn import _points, assert_bit_equal

    calls = {"knn_select": 0, "knn_dist": 0}
    widths = []

    def counted(name):
        real = getattr(tkc, name)

        def fn(*a, **kw):
            calls[name] += 1
            if name == "knn_dist":
                widths.append(a[8])
            return real(*a, **kw)
        return fn

    for name in calls:
        monkeypatch.setattr(tkc, name, counted(name))
    box = 1.0 if periodic else None
    pts = _points(20000, 61)
    q = _points(1024, 62)
    want_d, want_i = JKDTree(pts, boxsize=box, leafsize=1024).query(q, k=k)
    tree = TKDTree(pts, boxsize=box, device="cpu", leafsize=1024)
    d, i = tree.query_device(torch.from_numpy(q), k=k, engine="kernel")
    assert tkd.query_blocks_device.ladder_queries < len(q)
    assert_bit_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(i.numpy().astype(np.uint32), want_i)
    if k <= tkc.SELECT_MAX:
        assert calls == {"knn_select": 1, "knn_dist": 0}
    else:
        assert calls["knn_select"] == 0 and calls["knn_dist"] >= 1
        assert all(w % tkd.DIST_ROW_ALIGN == 0 for w in widths)
