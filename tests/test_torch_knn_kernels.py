"""The k-NN kernel route of the PyTorch port against the JAX package (CPU).

The kernel plan (FULLZ column runs, ZSEG static tables, the plan choice),
the query staging, and the candidate kernels' plain versions against the
Pallas kernels in interpret mode, on the same numpy-made inputs; then the
kernel route's statistics. Distances are held bit-equal and slots equal.
The kernels' wrappers take their plain versions here, because every tensor
lies on the CPU; ``tests/test_torch_knn_cuda.py`` holds the kernels to the
same plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbodyhpc_tpu.kdtree import KDTree as JKDTree
from nbodyhpc_tpu.ops import knn_device as jkd
from nbodyhpc_tpu.ops import knn_pallas as jkp

from nbodyhpc_tpu_torch.kdtree import KDTree as TKDTree
from nbodyhpc_tpu_torch.ops import knn as tknn
from nbodyhpc_tpu_torch.ops import knn_cuda as tkc
from nbodyhpc_tpu_torch.ops import knn_device as tkd
from test_torch_knn import _points, assert_bit_equal, port_tree


# ---------------------------------------------------------------------------
# the kernel plan
# ---------------------------------------------------------------------------


def _run_slots(starts, lens):
    """Tree slots a plan row scans, in scan order."""
    return [s for st, ln in zip(starts, lens) for s in range(st, st + ln)]


def _assert_run_cells(tree, starts, lens, c0, nc, cells):
    """Each run is the slots of its cell range [c0, c0 + nc); the ranges
    sum to the plan's cell count."""
    off = tree.offsets.long()
    used = nc > 0
    np.testing.assert_array_equal(
        torch.where(used, off[c0.long()], 0).numpy(), starts.numpy())
    np.testing.assert_array_equal(
        torch.where(used, off[(c0 + nc).long()] - off[c0.long()], 0).numpy(),
        lens.numpy())
    np.testing.assert_array_equal(nc.sum(1).numpy(), cells.numpy())


@pytest.mark.parametrize("periodic", [True, False])
def test_fullz_runs_match_jax(periodic):
    jt = JKDTree(_points(4000, 1), leafsize=64,
                 boxsize=1.0 if periodic else None)
    dims = tuple(int(v) for v in jt._tree.dims)
    js, jl, jmax = jkd._fullz_logical_runs(jt._dev[2], dims, periodic)
    tree = port_tree(jt)
    ts, tl, cells, tmax, c0, nc = tkd._fullz_logical_runs(tree)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tmax == int(jmax)
    _assert_run_cells(tree, ts, tl, c0, nc, cells)
    Cz = dims[2]
    ncol_nb = (tl.numpy().reshape(-1, 3, 2) > 0).any(2).sum(1)
    assert (cells.numpy() <= 9 * Cz).all() and (cells.numpy() > 0).all()
    assert ncol_nb.max() == 3


@pytest.mark.parametrize("periodic", [True, False])
def test_zseg_tables_match_jax(periodic):
    """The ZSEG plan's logical runs cover, piece by piece, exactly the slots
    of the JAX plan's physical slots, in the same order (which decides
    ties); JAX-flagged pieces carry no runs there."""
    jt = JKDTree(_points(4000, 1), leafsize=64,
                 boxsize=1.0 if periodic else None)
    tree = port_tree(jt)
    zseg, nseg, npair, nsp = jkd.piece_geometry(jt._tree)
    assert tkd.piece_geometry(tree) == (zseg, nseg, npair, nsp)
    prow, flagged = (np.asarray(a) for a in jkd.static_piece_tables(
        jt._tree, jt._dev))
    starts, lens, cells, c0, nc = tkd._build_static_tables(tree, zseg, nseg,
                                                           npair)
    _assert_run_cells(tree, starts, lens, c0, nc, cells)
    starts, lens, cells = starts.numpy(), lens.numpy(), cells.numpy()
    NR = jkp.NRUNS
    assert starts.shape == (nsp, NR)
    for p in range(nsp):
        got = _run_slots(starts[p], lens[p])
        assert len(got) == len(set(got))
        if flagged[p]:
            continue
        want = _run_slots(prow[p, :NR] + prow[p, 2 * NR:3 * NR],
                          prow[p, NR:2 * NR])
        assert got == want


def test_tree_plan_choice_matches_jax():
    jt = JKDTree(_points(4000, 7), leafsize=64, boxsize=1.0)
    plan = tkd.tree_plan(port_tree(jt))
    assert plan.fullz and not jkd.tree_plan(jt._tree, jt._dev)[1]
    assert plan.run_start.shape[1] == 6
    # all points in one thin column: ZSEG on both sides
    rng = np.random.default_rng(8)
    pts = rng.random((20000, 3), dtype=np.float32)
    pts[:, :2] *= 1e-3
    jt2 = JKDTree(pts, boxsize=1.0)
    plan2 = tkd.tree_plan(port_tree(jt2))
    assert not plan2.fullz and jkd.tree_plan(jt2._tree, jt2._dev)[1]
    assert plan2.run_start.shape[1] == 36
    # a periodic tree with fewer than 3 cells in x refuses the kernel
    tiny = TKDTree(_points(30, 9), boxsize=1.0, device="cpu")._tree
    assert tkd.tree_plan(tiny) is None


def test_stage_sort_matches_jax():
    jt = JKDTree(_points(3000, 3), leafsize=64, boxsize=1.0)
    tree = port_tree(jt)
    for fullz in (True, False):
        if fullz:
            zseg, nseg = int(tree.dims[2]), 1
        else:
            zseg, nseg, _, _ = tkd.piece_geometry(tree)
        plan = tkd.KernelPlan(fullz, zseg, nseg, *([None] * 4), (0.0,) * 3,
                              None, None)
        q = _points(2048, 4) * np.float32(1.5) - np.float32(0.25)
        qs, qcs, orig, dpid, sip, pmeta, npieces = jkd._stage_sort(
            jnp.asarray(q), jnp.asarray(tree.lo), jnp.asarray(tree.cell_size),
            tuple(int(v) for v in tree.dims), True, zseg, nseg,
            pair=not fullz)
        st = tkd._stage_sort(tree, plan, torch.from_numpy(q), qb=jkp.QB)
        npieces = int(npieces)
        assert_bit_equal(st.qs.numpy(), qs)
        np.testing.assert_array_equal(st.qcs.numpy(), np.asarray(qcs))
        np.testing.assert_array_equal(st.orig.numpy(), np.asarray(orig))
        # each sorted row's dynamic piece and its place in it
        qn = st.piece_qn.long()
        got_dpid = torch.repeat_interleave(torch.arange(qn.numel()), qn)
        got_sip = torch.arange(len(q)) - st.piece_q0.long()[got_dpid]
        np.testing.assert_array_equal(got_dpid.numpy(), np.asarray(dpid))
        np.testing.assert_array_equal(got_sip.numpy(), np.asarray(sip))
        assert st.piece_q0.numel() == npieces
        pmeta = np.asarray(pmeta)[:, :npieces]
        np.testing.assert_array_equal(st.piece_qn.numpy(), pmeta[0])
        np.testing.assert_array_equal(st.piece_pid.numpy(), pmeta[1])
        # the port cuts pieces at its own kernel's block size too
        small = tkd._stage_sort(tree, plan, torch.from_numpy(q))
        assert int(small.piece_qn.max()) <= tkc.QB


# ---------------------------------------------------------------------------
# the candidate kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _jax_runs(spec, geom, npad):
    """JAX's physical run table [1, G, 128] (128-aligned s0, len, shift)
    and the port's logical (start, len) rows for ``spec``
    {piece: [(start, len), ...]}."""
    runs = np.zeros((1, geom.G, 128), np.int32)
    nr = max(len(v) for v in spec.values())
    rs = np.zeros((len(spec), nr), np.int32)
    rl = np.zeros((len(spec), nr), np.int32)
    for g, rr in spec.items():
        for r, (start, ln) in enumerate(rr):
            s0 = min((start // 128) * 128, npad - geom.RFETCH)
            runs[0, g, r] = s0
            runs[0, g, geom.NR + r] = ln
            runs[0, g, 2 * geom.NR + r] = start - s0
            rs[g, r], rl[g, r] = start, ln
    return runs, torch.from_numpy(rs), torch.from_numpy(rl)


@pytest.mark.parametrize("periodic", [False, True])
def test_topk_plain_matches_pallas_fullz(periodic):
    """B3's plain version against ``_run_knn_topk`` (interpret, FULLZ run
    slots) on one block as the JAX package's own smoke test builds it, with
    one candidate duplicated into a later run: the query placed on it meets
    a tie at distance 0, which both sides break to the earlier run."""
    # FULLZ's nine run slots per piece at its smallest slot width, two
    # piece slots per block (the kernel is the same at G = 12; fewer gated
    # units keep the interpreter to seconds)
    geom = jkp.KGeom(G=2, NR=jkp.FULLZ.NR, RCAP=jkp.FULLZ_RCAP_RUNGS[0])
    rng = np.random.Generator(np.random.Philox(77))
    npad = geom.RFETCH + 256
    xyz = rng.random((4, npad)).astype(np.float32)
    xyz[:, 131 + 7] = xyz[:, 3]  # run 1 of piece 0 repeats run 0's slot 3
    k = 8
    spec = {0: [(0, 100), (131, 50)], 1: [(256, 40)]}
    runs, rs, rl = _jax_runs(spec, geom, npad)
    qblk = np.zeros((1, 128, 4), np.float32)
    qblk[0, :, :3] = rng.random((128, 3))
    qblk[0, :, 3] = -1.0
    qblk[0, :10, 3] = 0.0
    qblk[0, 10:16, 3] = 1.0
    qblk[0, 0, :3] = xyz[:3, 3]  # its nearest two tie at distance 0
    box = (1.0, 1.0, 1.0) if periodic else (0.0, 0.0, 0.0)
    dk, sk = jkp._run_knn_topk(
        jnp.asarray(runs), jnp.asarray(qblk), jnp.asarray(xyz), nblocks=1,
        kpad=jkp._kpad(k), periodic=periodic, box=box, interpret=True,
        geom=geom)
    dk = np.asarray(dk)[0, :16, :k]
    sk = np.asarray(sk)[0, :16, :k]
    g = np.where(np.arange(16) < 10, 0, 1)
    want_slot = runs[0, g[:, None], sk // geom.RCAP] + runs[
        0, g[:, None], 2 * geom.NR + sk // geom.RCAP] + sk % geom.RCAP

    q = torch.from_numpy(np.ascontiguousarray(qblk[0, :16, :3].T))
    args = (q, torch.tensor([0, 10], dtype=torch.int32),
            torch.tensor([10, 6], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), rs, rl,
            torch.from_numpy(xyz), box)
    d2, slot = tkc.knn_topk(*args, k, grid=None)  # the plain version's runs
    assert_bit_equal(d2.numpy(), dk)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    assert slot[0, 0] == 3 and slot[0, 1] == 131 + 7 and d2[0, 1] == 0
    ref = tkc.knn_topk_reference(*args, k)
    assert torch.equal(ref[0], d2) and torch.equal(ref[1], slot)


def pallas_dist_block(periodic):
    """One block through ``_run_knn`` (interpret, a small KGeom) and the
    same inputs for the port: (JAX block [1, 128, NCAND], JAX run table,
    geom, {piece: runs}, the port's kernel arguments up to ``box``, each of
    the 30 real rows' piece). Piece 0 holds 20 queries and 280 candidates,
    piece 1 holds 10 and 160."""
    geom = jkp.KGeom(G=2, NR=4, RCAP=128)
    rng = np.random.Generator(np.random.Philox(78))
    npad = 1024
    xyz = rng.random((4, npad)).astype(np.float32)
    spec = {0: [(5, 120), (300, 60), (700, 100)], 1: [(130, 90), (600, 70)]}
    runs, rs, rl = _jax_runs(spec, geom, npad)
    qblk = np.zeros((1, 128, 4), np.float32)
    qblk[0, :, :3] = rng.random((128, 3))
    qblk[0, :, 3] = -1.0
    qblk[0, :20, 3] = 0.0
    qblk[0, 20:30, 3] = 1.0
    box = (1.0, 1.0, 1.0) if periodic else (0.0, 0.0, 0.0)
    d2j = jkp._run_knn(jnp.asarray(runs), jnp.asarray(qblk),
                       jnp.asarray(xyz), nblocks=1, periodic=periodic,
                       box=box, interpret=True, geom=geom)
    q = torch.from_numpy(np.ascontiguousarray(qblk[0, :30, :3].T))
    pid = torch.tensor([0, 1], dtype=torch.int32)
    args = (q, torch.tensor([0, 20], dtype=torch.int32),
            torch.tensor([20, 10], dtype=torch.int32), pid, rs, rl,
            torch.from_numpy(xyz), box)
    return (np.asarray(d2j), runs, geom, spec, args,
            torch.tensor([0] * 20 + [1] * 10))


def assert_equals_topk_blocks(vals, slot, d2j, runs, geom, k):
    """(vals, slot) of the 30 real rows equal ``_topk_blocks`` of the JAX
    block: distances bit for bit, slots where the distance is finite, -1
    elsewhere."""
    dk, sk = jkp._topk_blocks(jnp.asarray(d2j), k)
    dk, sk = np.asarray(dk)[:30], np.asarray(sk)[:30]
    assert_bit_equal(vals.numpy(), dk)
    g = np.where(np.arange(30) < 20, 0, 1)[:, None]
    want_slot = runs[0, g, sk // geom.RCAP] + runs[
        0, g, 2 * geom.NR + sk // geom.RCAP] + sk % geom.RCAP
    fin = np.isfinite(dk)
    np.testing.assert_array_equal(slot.numpy()[fin], want_slot[fin])
    assert (slot.numpy()[~fin] == -1).all()


@pytest.mark.parametrize("periodic", [False, True])
def test_dist_plain_matches_pallas_and_topk_blocks(periodic):
    """B4's plain version against ``_run_knn`` (interpret, a small KGeom):
    the same distances with candidates back to back, and the stable-sort
    selection from the block against ``_topk_blocks``."""
    d2j, runs, geom, spec, args, row_pid = pallas_dist_block(periodic)
    # the JAX block in the port's layout: each run's lanes back to back
    want = np.full((30, 400), np.inf, np.float32)
    for row in range(30):
        p = 0 if row < 20 else 1
        got_cols = [d2j[0, row, r * geom.RCAP:r * geom.RCAP + ln]
                    for r, (_, ln) in enumerate(spec[p])]
        cat = np.concatenate(got_cols)
        want[row, :cat.size] = cat
    block = tkc.knn_dist(*args, 400)
    assert_bit_equal(block.numpy(), want)
    k = 130
    vals, slot = tkc.select_block(block, k, row_pid, args[4], args[5])
    assert_equals_topk_blocks(vals, slot, d2j, runs, geom, k)


def test_topk_kernel_wrapper_refuses_bad_inputs():
    q = torch.zeros((3, 4))
    one = torch.zeros(1, dtype=torch.int32)
    runs = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        tkc.knn_topk(q, one, one, one, runs, runs, torch.zeros((4, 8)),
                     (0.0,) * 3, 129, grid=None)
    with pytest.raises(ValueError):
        tkc.knn_topk(q, one, one, one, runs, runs,
                     torch.zeros((4, 8), dtype=torch.float64).to("meta"),
                     (0.0,) * 3, 4, grid=None)
    with pytest.raises(TypeError):  # the plan's cells are never implied
        tkc.knn_topk(q, one, one, one, runs, runs, torch.zeros((4, 8)),
                     (0.0,) * 3, 4)


def test_kernel_route_counts_and_ladder_share():
    """The kernel route on the CPU: plain versions, no launches counted;
    statistics of certified queries come from their piece's plan row,
    those the bound cannot certify take the ladder's counters."""
    pts = _points(20000, 43)
    q = pts[:1500]
    tree = TKDTree(pts, boxsize=1.0, device="cpu")
    before = (tkc.knn_topk.launches, tkc.knn_dist.launches)
    d, i, stats = tree.query_with_statistics(q, k=16, engine="kernel")
    assert (tkc.knn_topk.launches, tkc.knn_dist.launches) == before
    assert (d[:, 0] == 0).all()
    nbad = tkd.query_blocks_device.ladder_queries
    assert 0 <= nbad < 150
    cl = tree._tree
    plan = tkd.tree_plan(cl)
    _, qcell = tknn.query_cells(cl, torch.from_numpy(q))
    col = (qcell[:, 0] * int(cl.dims[1]) + qcell[:, 1]).numpy()
    from_plan = stats.points_visited == plan.points.numpy()[col]
    assert from_plan.sum() >= len(q) - nbad
    assert (stats.cells_scanned[from_plan] == plan.cells.numpy()[col][
        from_plan]).all()
    ncells = cl.ncells
    assert (stats.cells_pruned[from_plan] == ncells - stats.cells_scanned[
        from_plan]).all()
    # ladder statistics equal the JAX package's
    dl, il, sl = tree.query_with_statistics(q[:300], k=16, engine="ladder")
    jd, ji, js = JKDTree(pts, boxsize=1.0).query_with_statistics(q[:300], 16)
    for g, w in zip(sl, js):
        np.testing.assert_array_equal(g, w)
