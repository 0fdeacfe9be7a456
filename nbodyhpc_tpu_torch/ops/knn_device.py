"""Per-tree kernel plan and the batch pipeline around the candidate kernels.

PyTorch port of :mod:`nbodyhpc_tpu.ops.knn_device`. The tree precomputes,
once, the candidate runs of every static *piece*:

- **FULLZ** (preferred): a piece is one cell column (x, y) over the full z
  extent. Its queries' 27-cell neighbourhoods union to the 3x3 neighbour
  columns, which in the z-major sorted storage are, per neighbour x, one
  contiguous slice spanning y - 1 .. y + 1 (two when y wraps): at most 6
  logical runs. The convergence bound then drops the z face.
- **ZSEG**: a piece is a column pair (2m, 2m + 1) times a static z-segment;
  its 36 runs are the neighbour columns' z-windows (A's 3x3, then B's minus
  the columns A already covers, each z-window split in two where it wraps).
  Taken when more than 1% of columns would overflow the largest FULLZ
  candidate budget of the JAX plan (dense trees).

A batch then sorts its queries by static piece id, cuts each group into
dynamic pieces of at most :data:`.knn_cuda.QB` queries, runs over every
piece B3 (k <= 128), B4's selection sink (k <= 256) or B4's distance block
plus a stable-sort selection (larger k), and applies the r = 1 cube
convergence bound. Queries the bound cannot certify finish on
the exact ladder (:mod:`.knn`).

Kept from the JAX plan: which tree ranges each piece scans, which queries
are certified, and which go to the ladder. Left out, being TPU artefacts:
128-aligned run starts with a residual shift and lane roll, the RCAP
physical-slot split of long runs, first-fit packing of 12 pieces per
128-row block (and ``csrc/hostio.c``), macro sizes, power-of-two chunk
padding, in-flight pacing, the stage tracer, and the sort-plus-gather used
in place of a scatter. Because the kernels stream runs of any length, no
piece is flagged for overflowing a slot budget: the kernel route is refused
only where the JAX plan refuses it outright (periodic trees with fewer than
3 cells in x or y, see :func:`.knn.kernel_route_ok`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cells import CellList
from ..utils import profiling
from . import knn_cuda
from .knn import (
    KnnResult,
    QueryStatistics,
    as_queries,
    cube_bound,
    finish_indices,
    kernel_route_ok,
    ladder_knn,
    query_cells,
)

#: the JAX plan's ZSEG candidate budget (NRUNS x RCAP), which sizes the
#: static z-segments
ZSEG_BUDGET = 36 * 256
#: the JAX plan's FULLZ slot widths and slots per piece: a tree whose
#: columns overflow the largest rung's 9 slots in more than 1% of columns
#: takes ZSEG, exactly as the JAX plan decides
FULLZ_RCAP_RUNGS = (512, 1024, 2048)
FULLZ_NR = 9
#: bytes of one B4 distance block (k above B4's selection sink): pieces are
#: chunked to fit
DIST_BLOCK_BYTES = 1 << 30
#: a block's rows are padded to this many float32 columns (inf), so every
#: row starts on a 128-byte line
DIST_ROW_ALIGN = 32


class KernelPlan(NamedTuple):
    """Static per-tree plan: pieces are columns (``fullz``) or column pairs x
    z-segments; ``run_start``/``run_len`` int32 [pieces, 6 or 36] hold each
    piece's logical runs in scan order; ``cells`` and ``points`` int32
    [pieces] its scanned cells and candidates (the statistics of the queries
    it certifies); ``box`` the periodic lengths ``dims * h`` (zeros when not
    periodic); ``run_cell``/``run_ncell`` int32 [pieces, 6 or 36] the first
    cell id and the cell count of each run (zeros for an unused run)."""

    fullz: bool
    zseg: int
    nseg: int
    run_start: torch.Tensor
    run_len: torch.Tensor
    cells: torch.Tensor
    points: torch.Tensor
    box: tuple
    run_cell: torch.Tensor
    run_ncell: torch.Tensor


def piece_geometry(tree: CellList):
    """Static ZSEG piece grid: (zseg, nseg, npair, nsp). A z-segment is sized
    so 18 column runs of a full segment fit the JAX plan's candidate budget
    at the tree's average occupancy."""
    Cx, Cy, Cz = (int(v) for v in tree.dims)
    avg_occ = max(tree.n / max(tree.ncells, 1), 1.0)
    zseg = int(max(1, ZSEG_BUDGET / (18.0 * 2.0 * avg_occ) - 2))
    zseg = min(zseg, Cz)
    nseg = (Cz + zseg - 1) // zseg
    npair = (Cx * Cy + 1) // 2
    return zseg, nseg, npair, npair * nseg


def _run(offsets, use, lo_cell, ncell):
    """(start, len, first cell, cells) of the cell range [lo_cell, lo_cell +
    ncell) where ``use``, else zeros."""
    s = offsets[torch.where(use, lo_cell, 0)]
    e = offsets[torch.where(use, lo_cell + ncell, 0)]
    return (torch.where(use, s, 0), torch.where(use, e - s, 0),
            torch.where(use, lo_cell, 0), torch.where(use, ncell, 0))


def _build_static_tables(tree: CellList, zseg: int, nseg: int, npair: int):
    """ZSEG logical runs: (starts, lens, cells, run_cell, run_ncell) with
    starts/lens int32 [NSP, 36] in the JAX kernel's slot order, cells [NSP]
    the cells the runs cover, and each run's first cell and cell count.
    Row p = pair m, segment s (p = m * nseg + s): the 3x3
    neighbourhoods of columns (2m, 2m + 1) over the z-interval
    [s*zseg - 1, min((s+1)*zseg, Cz)]; B skips the columns A covers, so
    every tree point lands in at most one run."""
    Cx, Cy, Cz = (int(v) for v in tree.dims)
    periodic = tree.periodic
    offsets = tree.offsets.long()
    dev = offsets.device
    ncol = Cx * Cy
    p = torch.arange(npair * nseg, device=dev)
    m, s = p // nseg, p % nseg
    colA = 2 * m
    colB = torch.clamp_max(2 * m + 1, ncol - 1)
    dup_col = colB == colA
    axy = (colA // Cy, colA % Cy)
    bxy = (colB // Cy, colB % Cy)
    z0 = s * zseg - 1
    z1 = torch.clamp_max((s + 1) * zseg, Cz)
    ddx = bxy[0] - axy[0]
    ddy = bxy[1] - axy[1]
    if periodic:
        ddx = torch.remainder(ddx + Cx // 2, Cx) - Cx // 2
        ddy = torch.remainder(ddy + Cy // 2, Cy) - Cy // 2

    starts, lens, c0s, ncs = [], [], [], []
    for csel, cxy in ((0, axy), (1, bxy)):
        for nb in range(9):
            dx, dy = nb // 3 - 1, nb % 3 - 1
            if csel == 0:
                skip = torch.zeros_like(dup_col)
            else:
                skip = ((dx + ddx).abs() <= 1) & ((dy + ddy).abs() <= 1)
                skip = skip | dup_col
            x = cxy[0] + dx
            y = cxy[1] + dy
            if periodic:
                x = torch.remainder(x, Cx)
                y = torch.remainder(y, Cy)
                inb = ~skip
                za = torch.remainder(z0, Cz)
                span = torch.clamp_max(z1 - z0 + 1, Cz)
                first = torch.minimum(span, Cz - za)
                seg = ((za, first), (torch.zeros_like(za), span - first))
            else:
                inb = ~skip & (x >= 0) & (x < Cx) & (y >= 0) & (y < Cy)
                x = x.clamp(0, Cx - 1)
                y = y.clamp(0, Cy - 1)
                za = z0.clamp(0, Cz - 1)
                zb = z1.clamp(0, Cz - 1)
                seg = ((za, zb - za + 1),
                       (torch.zeros_like(za), torch.zeros_like(za)))
            base = (x * Cy + y) * Cz
            for zs, zl in seg:
                zl = torch.clamp_min(zl, 0)
                use = inb & (zl > 0)
                for acc, v in zip((starts, lens, c0s, ncs),
                                  _run(offsets, use, base + zs, zl)):
                    acc.append(v)
    ncell = torch.stack(ncs, 1).to(torch.int32)
    return (torch.stack(starts, 1).to(torch.int32),
            torch.stack(lens, 1).to(torch.int32),
            ncell.sum(1, dtype=torch.int32),
            torch.stack(c0s, 1).to(torch.int32), ncell)


def _fullz_logical_runs(tree: CellList):
    """FULLZ logical runs: (starts, lens, cells, max slice, run_cell,
    run_ncell) with starts/lens int32 [ncol, 6] -- per neighbour x (-1, 0,
    1) the y-window [y-1, y+1] over full z as one slice, or two where it
    wraps (Cy >= 3, so the two never alias) -- cells [ncol] the cells
    covered, the longest per-neighbour-x slice (which sizes the JAX plan's
    slot width), and each run's first cell and cell count."""
    Cx, Cy, Cz = (int(v) for v in tree.dims)
    periodic = tree.periodic
    offsets = tree.offsets.long()
    dev = offsets.device
    c = torch.arange(Cx * Cy, device=dev)
    x, y = c // Cy, c % Cy
    starts, lens, c0s, ncs = [], [], [], []
    for dx in (-1, 0, 1):
        xd = x + dx
        if periodic:
            xd = torch.remainder(xd, Cx)
            okx = torch.ones_like(xd, dtype=torch.bool)
        else:
            okx = (xd >= 0) & (xd < Cx)
            xd = xd.clamp(0, Cx - 1)
        if periodic:
            ya = torch.remainder(y - 1, Cy)
            w1 = torch.clamp_max(Cy - ya, 3)
            segs = ((ya, w1), (torch.zeros_like(ya), 3 - w1))
        else:
            ya = torch.clamp_min(y - 1, 0)
            yb = torch.clamp_max(y + 1, Cy - 1)
            segs = ((ya, yb - ya + 1),
                    (torch.zeros_like(ya), torch.zeros_like(ya)))
        for ys, yw in segs:
            use = okx & (yw > 0)
            run = _run(offsets, use, (xd * Cy + ys) * Cz, yw * Cz)
            for acc, v in zip((starts, lens, c0s, ncs), run):
                acc.append(v)
    starts = torch.stack(starts, 1).to(torch.int32)
    lens = torch.stack(lens, 1).to(torch.int32)
    ncell = torch.stack(ncs, 1).to(torch.int32)
    slice_len = lens[:, 0::2] + lens[:, 1::2]
    return (starts, lens, ncell.sum(1, dtype=torch.int32),
            int(slice_len.max()), torch.stack(c0s, 1).to(torch.int32), ncell)


def _fullz_overflow_fraction(lens, maxsl: int) -> float:
    """Share of columns whose runs need more than FULLZ_NR slots of the JAX
    plan's slot width (the smallest rung covering the longest slice)."""
    rcap = next((r for r in FULLZ_RCAP_RUNGS if maxsl <= 3 * r),
                FULLZ_RCAP_RUNGS[-1])
    slots = ((lens.long() + rcap - 1) // rcap).sum(1)
    return float((slots > FULLZ_NR).float().mean())


def tree_plan(tree: CellList) -> KernelPlan | None:
    """The tree's kernel plan (cached on the tree), or None where the kernel
    route is refused. FULLZ unless more than 1% of columns overflow the JAX
    plan's largest FULLZ budget, then ZSEG. Two scalar syncs per tree."""
    if not kernel_route_ok(tree):
        return None
    if tree.kernel_plan is not None:
        return tree.kernel_plan
    profiling.count("knn.plan_builds")
    with profiling.span("nbodyhpc.knn.plan"):
        tree.kernel_plan = _build_plan(tree)
    return tree.kernel_plan


def _build_plan(tree: CellList) -> KernelPlan:
    dims = np.asarray(tree.dims, np.float64)
    h = np.asarray(tree.cell_size, np.float64)
    box = (tuple(float(v) for v in dims * h) if tree.periodic
           else (0.0, 0.0, 0.0))
    starts, lens, cells, maxsl, c0, nc = _fullz_logical_runs(tree)
    if _fullz_overflow_fraction(lens, maxsl) <= 0.01:
        plan = KernelPlan(True, int(tree.dims[2]), 1, starts, lens, cells,
                          lens.sum(1, dtype=torch.int32), box, c0, nc)
    else:
        zseg, nseg, npair, _ = piece_geometry(tree)
        starts, lens, cells, c0, nc = _build_static_tables(tree, zseg, nseg,
                                                           npair)
        plan = KernelPlan(False, zseg, nseg, starts, lens, cells,
                          lens.sum(1, dtype=torch.int32), box, c0, nc)
    return plan


class Staged(NamedTuple):
    """A query batch sorted by static piece id and cut into dynamic pieces
    (at most ``qb`` queries each)."""

    qs: torch.Tensor             # [Q, 3] wrapped queries, sorted
    qcs: torch.Tensor            # [Q, 3] their cells
    orig: torch.Tensor           # [Q] caller row of each sorted row
    pid: torch.Tensor            # [Q] static piece id of each sorted row
    piece_q0: torch.Tensor       # [P] int32 first sorted row of each piece
    piece_qn: torch.Tensor       # [P] int32 queries of each piece
    piece_pid: torch.Tensor      # [P] int32 static piece id of each piece


def _stage_sort(tree: CellList, plan: KernelPlan, queries,
                qb: int = knn_cuda.QB) -> Staged:
    """Sort queries by static piece id (stable) and segment each group into
    dynamic pieces split at ``qb`` multiples. One sync (the piece count)."""
    with profiling.span("nbodyhpc.knn.stage_sort"):
        st = _sorted_pieces(tree, plan, queries, qb)
    profiling.count("knn.pieces", st.piece_q0.shape[0])
    return st


def _sorted_pieces(tree: CellList, plan: KernelPlan, queries,
                   qb: int) -> Staged:
    Cy = int(tree.dims[1])
    qw, qcell = query_cells(tree, queries)
    colid = qcell[:, 0] * Cy + qcell[:, 1]
    pid = (colid // (1 if plan.fullz else 2)) * plan.nseg + qcell[:, 2] // plan.zseg
    pid_s, orig = torch.sort(pid, stable=True)
    Q = pid_s.shape[0]
    iota = torch.arange(Q, device=pid_s.device)
    newp = torch.ones(Q, dtype=torch.bool, device=pid_s.device)
    newp[1:] = pid_s[1:] != pid_s[:-1]
    # start row of each pid group, carried forward by a running max
    gstart = torch.cummax(torch.where(newp, iota, 0), 0).values
    jloc = iota - gstart
    bnd = newp | ((jloc % qb == 0) & (jloc > 0))
    piece_q0 = torch.nonzero(bnd).squeeze(1)
    piece_qn = torch.diff(piece_q0, append=piece_q0.new_tensor([Q]))
    return Staged(
        qs=qw[orig], qcs=qcell[orig], orig=orig, pid=pid_s,
        piece_q0=piece_q0.to(torch.int32),
        piece_qn=piece_qn.to(torch.int32),
        piece_pid=pid_s[piece_q0].to(torch.int32),
    )


def _epilogue(tree: CellList, plan: KernelPlan, d2, slot, qs, qcs):
    """Global indices and the r = 1 cube box-distance convergence bound,
    in float32 as the JAX device epilogue computes it. With ``plan.fullz``
    the piece scanned its neighbour columns over the full z extent, so the
    z face never bounds convergence. Returns (dist, idx, conv)."""
    dist, gidx = finish_indices(tree, d2, slot)
    db, covered = cube_bound(tree, qs, qcs, 1, 2 if plan.fullz else 3)
    conv = (d2[:, -1] < db * db) | covered
    return dist, gidx, conv


def _dist_chunks(st: Staged, tot_piece):
    """Contiguous piece ranges whose B4 block (rows x the range's largest
    candidate count rounded up to :data:`DIST_ROW_ALIGN`, float32) fits
    :data:`DIST_BLOCK_BYTES`: (first piece, end piece, first row, rows,
    columns) each."""
    q0 = st.piece_q0.cpu().numpy().astype(np.int64)
    qn = st.piece_qn.cpu().numpy().astype(np.int64)
    tot = tot_piece.cpu().numpy().astype(np.int64)
    tot = -(-np.maximum(tot, 1) // DIST_ROW_ALIGN) * DIST_ROW_ALIGN
    rows_max = max(DIST_BLOCK_BYTES // (4 * int(tot.max())), 1)
    ends = q0 + qn
    out, p0 = [], 0
    while p0 < len(q0):
        p1 = int(np.searchsorted(ends, q0[p0] + rows_max, side="right"))
        p1 = max(p1, p0 + 1)
        out.append((p0, p1, int(q0[p0]), int(ends[p1 - 1] - q0[p0]),
                    int(tot[p0:p1].max())))
        p0 = p1
    return out


def cell_grid(tree: CellList, plan: KernelPlan) -> knn_cuda.CellGrid:
    """The cells behind the plan's runs, as B3 takes them."""
    return knn_cuda.CellGrid(plan.run_cell, plan.run_ncell, tree.offsets,
                             tuple(int(v) for v in tree.dims),
                             tuple(float(v) for v in tree.lo),
                             tuple(float(v) for v in tree.cell_size),
                             tuple(float(v) for v in tree.inv_cell_size))


def _kernel_args(tree: CellList, plan: KernelPlan, st: Staged):
    """The candidate kernels' shared arguments: q [3, Q], then the pieces,
    the plan's runs, the tree's points and the box."""
    return (st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
            plan.run_start, plan.run_len, tree.xyz, plan.box)


def block_topk(tree: CellList, plan: KernelPlan, st: Staged, k: int):
    """(d2 [Q, k], slot [Q, k]) through B4's distance blocks, chunked by
    :data:`DIST_BLOCK_BYTES`, and a stable-sort selection from each: the
    route of any k above B4's selection sink."""
    q, *args = _kernel_args(tree, plan, st)
    Q = q.shape[1]
    d2 = torch.empty((Q, k), device=q.device)
    slot = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    tot = plan.points[st.piece_pid.long()]
    for p0, p1, r0, nr, ncand in _dist_chunks(st, tot):
        sub = [a[p0:p1] for a in args[:3]]
        block = knn_cuda.knn_dist(q, *sub, *args[3:], ncand, row_base=r0,
                                  nrows=nr)
        d2[r0:r0 + nr], slot[r0:r0 + nr] = knn_cuda.select_block(
            block, k, st.pid[r0:r0 + nr], plan.run_start, plan.run_len)
    return d2, slot


def candidate_topk(tree: CellList, plan: KernelPlan, st: Staged, k: int):
    """(d2 [Q, k], slot [Q, k]) of every sorted query over its piece's
    candidates: B3 for k <= 128; B4's selection sink, one launch over all
    pieces, up to its capacity (256); above, :func:`block_topk`."""
    with profiling.span("nbodyhpc.knn.candidates"):
        if k <= knn_cuda.TOPK_MAX:
            return knn_cuda.knn_topk(*_kernel_args(tree, plan, st), k,
                                     grid=cell_grid(tree, plan))
        if k <= knn_cuda.SELECT_MAX:
            return knn_cuda.knn_select(*_kernel_args(tree, plan, st), k)
        return block_topk(tree, plan, st, k)


def query_blocks_device(tree: CellList, queries, k: int,
                        with_stats: bool = False) -> KnnResult:
    """Exact k-NN through the candidate kernels: (distances [Q, k] float32
    ascending, indices [Q, k] int32, statistics or None), tensors on the
    tree's device in caller order. Queries the r = 1 bound cannot certify
    are finished by the exact ladder, whose counters then replace the
    plan's. Raises where the kernel route is refused (see
    :func:`tree_plan`)."""
    plan = tree_plan(tree)
    if plan is None:
        raise ValueError("the kernel route needs >= 3 cells in x and y of a "
                         "periodic tree; use the ladder")
    queries = as_queries(queries, tree.device)
    Q = queries.shape[0]
    dev = queries.device
    dist = torch.empty((Q, k), device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    conv = torch.ones((Q,), dtype=torch.bool, device=dev)
    pid = torch.zeros((Q,), dtype=torch.int64, device=dev)
    if Q:
        st = _stage_sort(tree, plan, queries)
        d2, slot = candidate_topk(tree, plan, st, k)
        with profiling.span("nbodyhpc.knn.epilogue"):
            d, gi, cv = _epilogue(tree, plan, d2, slot, st.qs, st.qcs)
            dist[st.orig] = d
            idx[st.orig] = gi
            conv[st.orig] = cv
            pid[st.orig] = st.pid
            bad = torch.nonzero(~conv).squeeze(1)
    else:
        bad = torch.empty((0,), dtype=torch.int64, device=dev)
    stats = None
    if with_stats:
        cs = plan.cells[pid]
        stats = QueryStatistics(
            cs, plan.points[pid],
            torch.where(conv, torch.clamp_min(tree.ncells - cs, 0), 0))
    if bad.numel():
        sub = ladder_knn(tree, queries[bad], k, with_stats=with_stats)
        dist[bad] = sub.distances
        idx[bad] = sub.indices
        if with_stats:
            stats = QueryStatistics(*(s.index_copy(0, bad, t)
                                      for s, t in zip(stats, sub.stats)))
    profiling.count("knn.ladder_queries", bad.numel())
    # the same value as the counter; kept only because the benchmark's k-NN
    # step kind reads this attribute
    query_blocks_device.ladder_queries = bad.numel()
    return KnnResult(dist, idx, stats)


query_blocks_device.ladder_queries = 0
