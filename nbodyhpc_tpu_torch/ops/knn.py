"""Exact batched k-NN: brute force and the cell-list escalation ladder.

PyTorch port of :mod:`nbodyhpc_tpu.ops.knn`, the exact engine every fast
path defers to. The reference's kd-tree traversal with box-distance pruning
(kdtree_impl.hpp:185-269) becomes an expanding-cube cell scan: each query
scans every cell within Chebyshev cell radius ``r`` of its own cell, and its
answer is exact once the k-th best distance is below the distance to the
nearest unscanned cell. A ladder of (radius, per-cell slice cap) passes runs
each later pass only while some query is unconverged, and a streaming
brute-force pass finishes whatever the ladder could not certify.

Selection is a stable ``torch.sort`` of the distances followed by the first
``k`` columns: equal distances keep the lowest candidate position, which is
``lax.top_k``'s tie rule, so indices equal the JAX package's wherever the
candidate order does (cube-offset order then slot in the ladder, ``[best,
new]`` in the brute pass). Every distance is the JAX package's float32
expression as XLA compiles it for the CPU: :func:`.metrics.sq_dist` after
the min-image wrap in the passes, ``(dx*dx + dy*dy) + dz*dz`` in
:func:`brute_force_knn`.

The kernel route (``use_kernel``) answers large batches on a CUDA device
through :mod:`.knn_device` and finishes its unconverged queries here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cells import CellList
from ..utils import profiling
from .metrics import fma_f32, sq_dist, sqrt_f32, wrap_min_image

#: the smallest batch the "auto" route sends to the candidate kernels
KERNEL_MIN_QUERIES = 8192


class QueryStatistics(NamedTuple):
    """Per-query work counters (reference KDTreeQueryStatistics,
    kdtree.hpp:124-131): ``cells_scanned`` (nodes_visited analog),
    ``points_visited`` (candidate points) and ``cells_pruned`` (cells the
    convergence bound excluded; 0 for queries the brute-force pass
    answered). int32 tensors of shape [Q]."""

    cells_scanned: torch.Tensor
    points_visited: torch.Tensor
    cells_pruned: torch.Tensor


class KnnResult(NamedTuple):
    distances: torch.Tensor  # [Q, k] float32, ascending (sqrt applied)
    indices: torch.Tensor    # [Q, k] int32 (== n for missing neighbours)
    stats: QueryStatistics | None


def select_k(d2: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row, ascending, ties to the lowest
    column (a stable sort; ``torch.topk`` orders ties arbitrarily). Rows
    narrower than ``k`` are padded with ``inf`` at column 0."""
    if d2.shape[1] < k:
        pad = d2.new_full((d2.shape[0], k - d2.shape[1]), float("inf"))
        vals, pos = torch.sort(torch.cat([d2, pad], dim=1), dim=1, stable=True)
        pos = torch.where(pos < d2.shape[1], pos, 0)
    else:
        vals, pos = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]


def as_queries(queries, device) -> torch.Tensor:
    """(Q, 3) float32 tensor on ``device`` from an array or tensor."""
    return torch.as_tensor(queries, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Brute force (oracle + fallback)
# ---------------------------------------------------------------------------


def brute_force_knn(points, queries, k: int, box=None):
    """Exact k-NN by dense distance computation; the tests' oracle.

    ``points`` (N, 3), ``queries`` (Q, 3), ``box`` None or a 3-sequence of
    periodic box lengths. Returns (distances [Q, k] float32 ascending,
    indices [Q, k] int64). Mirrors the JAX oracle's expression, including
    its division ``round(d / b)``.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=points.device)
    d = queries[:, None, :] - points[None, :, :]
    if box is not None:
        b = torch.as_tensor(np.asarray(box, np.float32), device=points.device)
        d = d - b * torch.round(d / b)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    vals, idx = select_k(d2, k)
    return sqrt_f32(vals), idx


def _divisor_block(npad: int, want: int) -> int:
    """Largest power-of-two block <= want that divides npad (npad % 128 == 0)."""
    b = want
    while npad % b != 0:
        b //= 2
    return b


def _streaming_brute_pass(xyz, n: int, queries_w, k: int, box,
                          block: int = 2048):
    """Memory-bounded exact scan over all sorted, padded points: a top-k
    carried over point blocks, merged as ``[best, new]`` (best wins ties).
    Returns (d2 [Q, k] ascending, slot [Q, k] int64)."""
    profiling.count("knn.brute_rows", queries_w.shape[0])
    with profiling.span("nbodyhpc.knn.brute"):
        return _brute_pass(xyz, n, queries_w, k, box, block)


def _brute_pass(xyz, n: int, queries_w, k: int, box, block: int):
    npad = xyz.shape[1]
    block = _divisor_block(npad, min(block, npad))
    Q = queries_w.shape[0]
    dev = queries_w.device
    best_d2 = torch.full((Q, k), float("inf"), device=dev)
    best_slot = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    qcols = [queries_w[:, d:d + 1] for d in range(3)]
    for s in range(0, npad, block):
        d2 = sq_dist(qcols, xyz[0, s:s + block], xyz[1, s:s + block],
                      xyz[2, s:s + block], box)
        slot = torch.arange(s, s + block, device=dev)
        d2 = torch.where(slot < n, d2, float("inf"))
        cat_d2 = torch.cat([best_d2, d2], dim=1)
        cat_slot = torch.cat([best_slot, slot.expand(Q, block)], dim=1)
        best_d2, sel = select_k(cat_d2, k)
        best_slot = torch.gather(cat_slot, 1, sel)
    return best_d2, best_slot


# ---------------------------------------------------------------------------
# Cell-list expanding-cube passes
# ---------------------------------------------------------------------------


def cube_window(tree: CellList, qcell, rc, ccap: int, periodic=None):
    """Candidate slots of each query's cell cube: per-dimension Chebyshev
    cell radii ``rc`` around ``qcell``, offsets in x-major order, each cell
    one contiguous slice of the sorted storage read through a ``ccap``-wide
    window. Along a periodic axis the cube wraps and, where it spans the
    whole axis, keeps only the first ``dims`` offsets so no cell appears
    twice; along a plain axis it drops cells off the grid. ``periodic``
    gives each axis's kind (default: the tree's flag on every axis).
    Returns (valid [Q, M], slot [Q, M, ccap], valid_c [Q, M, ccap], taken
    [Q, M] slots of each cell inside the window, overflow [Q] some cell is
    fuller than its window)."""
    dims = np.asarray(tree.dims, np.int64)
    rc = np.asarray(rc, np.int64)
    if periodic is None:
        periodic = (tree.periodic,) * 3
    dev = qcell.device
    axes = [np.arange(-c, c + 1) for c in rc]
    M_off = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    Q, M = qcell.shape[0], M_off.shape[0]
    offs_t = torch.as_tensor(M_off, device=dev)
    ccd = []
    static_valid = np.ones(M, dtype=bool)
    valid = torch.ones((Q, M), dtype=torch.bool, device=dev)
    for dim in range(3):
        if periodic[dim]:
            static_valid &= (M_off[:, dim] + rc[dim]) < dims[dim]
            c = qcell[:, dim:dim + 1] + int(dims[dim]) + offs_t[None, :, dim]
            ccd.append(torch.remainder(c, int(dims[dim])))
        else:
            c = qcell[:, dim:dim + 1] + offs_t[None, :, dim]
            valid = valid & (c >= 0) & (c < int(dims[dim]))
            ccd.append(c.clamp(0, int(dims[dim]) - 1))
    valid = valid & torch.as_tensor(static_valid, device=dev)[None, :]

    ids = (ccd[0] * int(dims[1]) + ccd[1]) * int(dims[2]) + ccd[2]
    offsets = tree.offsets.long()
    starts = offsets[ids]
    counts = torch.where(valid, offsets[ids + 1] - starts, 0)  # [Q, M]

    # a slice near the padded end clamps its start and ``delta`` re-aims the
    # validity window at the cell's real rows
    starts_cl = torch.clamp_max(starts, max(tree.npad - ccap, 0))
    delta = starts - starts_cl
    usable = ccap - delta
    overflow = (valid & (counts > usable)).any(dim=1)
    taken = torch.where(valid, torch.minimum(counts, usable), 0)
    j_idx = torch.arange(ccap, device=dev)
    valid_c = (valid[:, :, None]
               & (j_idx >= delta[:, :, None])
               & (j_idx < (delta + taken)[:, :, None]))
    slot = starts_cl[:, :, None] + j_idx
    return valid, slot, valid_c, taken, overflow


def cube_bound(tree: CellList, queries_w, qcell, r: int, ndim: int = 3,
               periodic=None, wrap=None):
    """(db [Q], covered [Q]): the distance from each query to the nearest
    cell outside its cube of Chebyshev cell radius ``r``, over the first
    ``ndim`` dimensions, in float32; and whether the cube holds every cell
    of those dimensions. A plain dimension is fully scanned only where the
    clipped interval covers [0, C-1], decided per query. ``periodic`` gives
    each axis's kind (default: the tree's flag on every axis). ``wrap``,
    the metric period of each axis, makes a plain axis's bound the
    min-image distance to its unscanned cells, with each face one fused
    multiply-add: the slab tree's z, whose cells are clipped while a
    query may lie past them, as the JAX slab tree's bound compiles."""
    dims, h, lo = tree.dims, tree.cell_size, tree.lo
    if periodic is None:
        periodic = (tree.periodic,) * 3
    Q = queries_w.shape[0]
    dev = queries_w.device
    side = 2 * r + 1
    db = torch.full((Q,), float("inf"), device=dev)
    covered = torch.ones((Q,), dtype=torch.bool, device=dev)
    for dim in range(ndim):
        C = int(dims[dim])
        hd = float(h[dim])
        lod = float(lo[dim])
        qd = queries_w[:, dim]
        if periodic[dim]:
            if side >= C:
                continue  # fully wrapped: no bound from this dimension
            covered = torch.zeros_like(covered)
            dlo = qd - ((qcell[:, dim] - r).to(torch.float32) * hd + lod)
            dhi = side * hd - dlo
        else:
            a = torch.clamp_min(qcell[:, dim] - r, 0)
            b = torch.clamp_max(qcell[:, dim] + r, C - 1)
            covered = covered & (a == 0) & (b == C - 1)
            if wrap is None:
                dlo = torch.where(a > 0,
                                  qd - (a.to(torch.float32) * hd + lod),
                                  float("inf"))
                dhi = torch.where(
                    b < C - 1, ((b + 1).to(torch.float32) * hd + lod) - qd,
                    float("inf"))
            else:
                # unscanned low cells [0, a) span [lo, lo + a*h], high
                # cells (b, C) span [lo + (b+1)*h, lo + C*h]
                dlo = torch.where(
                    a > 0, _interval_dist(qd, _f32(lod),
                                          _fma(a, hd, lod), wrap[dim]),
                    float("inf"))
                dhi = torch.where(
                    b < C - 1, _interval_dist(qd, _fma(b + 1, hd, lod),
                                              _f32(lod + C * hd), wrap[dim]),
                    float("inf"))
        db = torch.minimum(db, torch.clamp_min(torch.minimum(dlo, dhi), 0.0))
    return db, covered


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float: how a Python constant
    enters the JAX package's float32 arithmetic (a weak type)."""
    return float(np.float32(x))


def _fma(i: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``float32(i) * b + c`` with float32 constants, rounded once."""
    a = i.to(torch.float32)
    return fma_f32(a, torch.full_like(a, _f32(b)), torch.full_like(a, _f32(c)))


def _interval_dist(qv, a, b, L):
    """Min-image distance from ``qv`` to the interval [a, b] on a torus of
    period ``L`` (a huge ``L``: the line)."""
    mid = (a + b) * 0.5
    half = (b - a) * 0.5
    return torch.clamp_min(wrap_min_image(qv - mid, L).abs() - half, 0.0)


def query_cells(tree: CellList, queries: torch.Tensor):
    """(wrapped queries [Q, 3], cell coordinates [Q, 3] int64): periodic
    queries wrap by ``L = dims * h`` in float32 (not ``boxsize``), then
    :func:`cell_coords` with ``1/h`` divided in float32."""
    dev = queries.device
    h = torch.as_tensor(np.asarray(tree.cell_size, np.float32), device=dev)
    if tree.periodic:
        dims = torch.as_tensor(np.asarray(tree.dims, np.int64), device=dev)
        L = dims.to(torch.float32) * h
        qw = queries - L * torch.floor(queries / L)
    else:
        qw = queries
    return qw, cell_coords(qw, tree.lo, 1.0 / h, tree.dims,
                           (tree.periodic,) * 3)


def cell_coords(q: torch.Tensor, lo, inv_h, dims, periodic):
    """Cell coordinates [Q, 3] int64 of the points ``q``: ``floor((q - lo)
    * inv_h)`` in float32 (``lo`` and ``inv_h`` rounded to float32),
    wrapped along each ``periodic`` axis and clipped along the others."""
    dev = q.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    inv_h = torch.as_tensor(inv_h, dtype=torch.float32, device=dev)
    dims = torch.as_tensor(np.asarray(dims, np.int64), device=dev)
    per = torch.as_tensor(np.asarray(periodic, bool), device=dev)
    c = torch.floor((q - lo) * inv_h).to(torch.int64)
    return torch.where(per, torch.remainder(c, dims),
                       torch.minimum(torch.clamp_min(c, 0), dims - 1))


def _cube_pass(tree: CellList, queries_w, qcell, k: int, r: int, budget: int,
               state):
    """One expanding-cube pass at Chebyshev cell radius ``r`` with per-cell
    slice cap ``budget``: recomputes the top-k from the whole cube and
    updates the unconverged rows of ``state`` (d2, slot, conv, stats)."""
    profiling.count("knn.rungs")
    with profiling.span("nbodyhpc.knn.rung"):
        return _rung(tree, queries_w, qcell, k, r, budget, state)


def _rung(tree: CellList, queries_w, qcell, k: int, r: int, budget: int,
          state):
    Q = queries_w.shape[0]
    # cells fuller than the slice cap are truncated and force escalation
    ccap = min(budget, tree.npad)
    valid, slot, valid_c, taken, overflow = cube_window(tree, qcell, (r,) * 3,
                                                        ccap)
    M = valid.shape[1]
    box = ([float(d) * float(h) for d, h in zip(tree.dims, tree.cell_size)]
           if tree.periodic else None)
    d2 = sq_dist([queries_w[:, d, None, None] for d in range(3)],
                 tree.xyz[0][slot], tree.xyz[1][slot], tree.xyz[2][slot], box)
    d2 = torch.where(valid_c, d2, float("inf")).reshape(Q, M * ccap)
    new_d2, sel = select_k(d2, k)
    new_slot = torch.gather(slot.reshape(Q, M * ccap), 1, sel)

    db, covered = cube_bound(tree, queries_w, qcell, r)
    new_conv = (~overflow) & ((new_d2[:, -1] < db * db) | covered)

    old_d2, old_slot, old_conv, stats = state
    upd = ~old_conv
    d2_out = torch.where(upd[:, None], new_d2, old_d2)
    slot_out = torch.where(upd[:, None], new_slot, old_slot)
    conv_out = old_conv | (upd & new_conv)
    cells_scanned, points_visited, cells_pruned = stats
    cells_scanned = cells_scanned + torch.where(
        upd, valid.sum(dim=1, dtype=torch.int32), 0)
    points_visited = points_visited + torch.where(
        upd, taken.sum(dim=1, dtype=torch.int32), 0)
    cells_pruned = cells_pruned + torch.where(
        upd & new_conv, torch.clamp_min(tree.ncells - cells_scanned, 0), 0)
    return d2_out, slot_out, conv_out, (cells_scanned, points_visited,
                                        cells_pruned)


def default_ladder(tree: CellList):
    """Static (radius, per-cell slice cap) escalation ladder from build
    statistics (k-independent; the JAX module's default budget cap of 2048
    slots per cell)."""
    mcc = max(tree.max_cell_count, 1)
    max_dim = int(np.max(tree.dims))
    rungs = [(1, int(min(mcc, 256)))]
    if mcc > 256:
        # clustered data: a capacity rung before widening the radius
        rungs.append((1, int(min(mcc, 2048))))
    for r, cap in ((2, 128), (4, 64)):
        rungs.append((r, int(min(mcc, cap))))
        if 2 * r + 1 >= max_dim:
            break
    out = []
    for rung in rungs:
        if not out or rung != out[-1]:
            out.append(rung)
    return tuple(out)


def ladder_chunk(ladder) -> int:
    """Queries per ladder call: bounds the biggest pass's [chunk, M, ccap]
    candidate block at ``1 << 25`` elements (at least 2048, at most 65536
    queries)."""
    bmax = max(((2 * r + 1) ** 3) * c for r, c in ladder)
    return min(65536, max(2048, (1 << 25) // bmax))


def _ladder_query(tree: CellList, queries, k: int, ladder):
    """The ladder on one chunk, finished by the streaming brute-force pass
    where it cannot certify: returns (d2, slot, stats)."""
    Q = queries.shape[0]
    dev = queries.device
    qw, qcell = query_cells(tree, queries)
    zeros = torch.zeros((Q,), dtype=torch.int32, device=dev)
    state = (
        torch.full((Q, k), float("inf"), device=dev),
        torch.zeros((Q, k), dtype=torch.int64, device=dev),
        torch.zeros((Q,), dtype=torch.bool, device=dev),
        (zeros, zeros.clone(), zeros.clone()),
    )
    state = _cube_pass(tree, qw, qcell, k, *ladder[0], state)
    for r, budget in ladder[1:]:
        if bool((~state[2]).any()):
            state = _cube_pass(tree, qw, qcell, k, r, budget, state)
    d2, slot, conv, stats = state
    if bool((~conv).any()):
        bad = torch.nonzero(~conv).squeeze(1)
        box = None
        if tree.periodic:
            L = np.asarray(tree.dims, np.float32) * np.asarray(tree.cell_size,
                                                               np.float32)
            box = [float(v) for v in L]
        d2f, slotf = _streaming_brute_pass(tree.xyz, tree.n, qw[bad], k, box)
        d2 = d2.index_copy(0, bad, d2f)
        slot = slot.index_copy(0, bad, slotf)
        pv = stats[1].index_add(0, bad, torch.full_like(bad, tree.n,
                                                        dtype=torch.int32))
        stats = (stats[0], pv, stats[2])  # brute-forced queries pruned nothing
    return d2, slot, stats


def finish_indices(tree: CellList, d2, slot):
    """(distances, original indices): sqrt of ``d2``, and ``index[slot]``
    with ``n`` wherever the distance is not finite."""
    gidx = tree.index[slot.clamp_min(0).long()]
    gidx = torch.where(torch.isfinite(d2), gidx, tree.n)
    return sqrt_f32(d2), gidx


def ladder_knn(tree: CellList, queries, k: int,
               with_stats: bool = False) -> KnnResult:
    """Exact k-NN through the ladder alone, chunked so the biggest pass's
    candidate block stays bounded. ``queries`` (Q, 3) on the tree's device."""
    with profiling.span("nbodyhpc.knn.ladder"):
        return _ladder_knn(tree, queries, k, with_stats)


def _ladder_knn(tree: CellList, queries, k: int, with_stats: bool):
    ladder = default_ladder(tree)
    csize = ladder_chunk(ladder)
    dists, idxs, cs, pv, cp = [], [], [], [], []
    for s in range(0, queries.shape[0], csize):
        d2, slot, stats = _ladder_query(tree, queries[s:s + csize], k,
                                        ladder)
        d, gi = finish_indices(tree, d2, slot)
        dists.append(d)
        idxs.append(gi)
        cs.append(stats[0])
        pv.append(stats[1])
        cp.append(stats[2])
    if not dists:
        dev = queries.device
        empty_i = torch.empty((0,), dtype=torch.int32, device=dev)
        dists = [torch.empty((0, k), device=dev)]
        idxs = [torch.empty((0, k), dtype=torch.int32, device=dev)]
        cs, pv, cp = [empty_i], [empty_i], [empty_i]
    stats = (QueryStatistics(torch.cat(cs), torch.cat(pv), torch.cat(cp))
             if with_stats else None)
    return KnnResult(torch.cat(dists), torch.cat(idxs), stats)


def kernel_route_ok(tree: CellList) -> bool:
    """The candidate kernels scan wrapped 3x3 neighbour columns; a periodic
    tree with fewer than 3 cells in x or y would alias them, so such
    (tiny) trees stay on the exact ladder."""
    return not (tree.periodic
                and (int(tree.dims[0]) < 3 or int(tree.dims[1]) < 3))


def cell_knn_query(tree: CellList, queries, k: int,
                   with_stats: bool = False,
                   use_kernel: str = "auto") -> KnnResult:
    """Exact batched k-NN against a :class:`CellList`.

    ``queries`` (Q, 3), numpy or tensor; results are tensors on the tree's
    device. ``use_kernel``: "auto" sends batches of at least
    :data:`KERNEL_MIN_QUERIES` on a CUDA tree through the candidate kernels
    (:func:`.knn_device.query_blocks_device`), "force" always does (on the
    CPU through the kernels' plain versions), "never" keeps the ladder.
    Either way unconverged queries finish on the ladder, so every answer is
    exact.
    """
    if k <= 0:
        raise ValueError("k must be positive")  # reference: pybind.cpp:92-94
    if use_kernel not in ("auto", "force", "never"):
        raise ValueError(f"use_kernel must be auto, force or never, "
                         f"got {use_kernel!r}")
    with profiling.span("nbodyhpc.knn.query", tree.device):
        return _cell_knn_query(tree, queries, k, with_stats, use_kernel)


def _cell_knn_query(tree: CellList, queries, k: int, with_stats: bool,
                    use_kernel: str) -> KnnResult:
    queries = as_queries(queries, tree.device)
    profiling.count("knn.queries", queries.shape[0])
    use = kernel_route_ok(tree) and (
        use_kernel == "force"
        or (use_kernel == "auto" and tree.device.type == "cuda"
            and queries.shape[0] >= KERNEL_MIN_QUERIES))
    if use:
        from .knn_device import query_blocks_device

        return query_blocks_device(tree, queries, k, with_stats=with_stats)
    return ladder_knn(tree, queries, k, with_stats)
