"""Sharded k-NN tree: the point set partitioned into z-slabs over the ranks.

PyTorch port of :mod:`nbodyhpc_tpu.parallel.tree_sharded`. The replicated
tree of :func:`.sharded.knn_query_sharded` caps the tree at one device's
memory; here each rank holds only its z-slab of the points:

- **Build** (:func:`build_tree_sharded`): every rank sees the same points,
  assigns them to ``nd`` z-slabs, keeps its own slab's rows and builds a
  cell list over it with a shared grid geometry (global x/y cells, ``Cz/nd``
  local z cells). Coordinates in z are slab-local; the index channel holds
  global point indices.
- **Query** (:func:`knn_query_tree_sharded`): every rank routes the queries
  to their home slab, answers its own exactly against its slab by an
  expanding-cube ladder (x and y binned with the box, z clipped to the slab,
  the min-image metric on every axis), then sends each query whose k-th
  best distance reaches past a slab face to that slab in hop rounds (hop 1,
  2, ...), and merges the returned top-k. A query the configured hops or
  band ``cap`` cannot certify counts in the returned ``overflow``:
  ``overflow == 0`` certifies an exact answer.

SPMD contract as :mod:`.sharded`: one process per device, every rank calls
with the same arguments and returns the whole answer; a world of one needs
no process group. Distances use slab-local z, ``(q - z0) - (p - z0)``, one
float32 rounding more than the single tree's ``q - p``: on the CPU they
equal the JAX function's bit for bit, and the single tree's to one ulp.

Reference analog: a slab is visited only when its z-interval's min-image
distance to the query is below the current k-th best, the kd-tree's
box-distance prune (reference: kdtree/src/cpp/include/kdtree/
kdtree_impl.hpp:239-267).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.cells import MAX_CELLS_PER_DIM, choose_dims
from ..core.points import PAD_SENTINEL, round_up, validate_points
from ..ops import knn as _knn
from ..ops.knn import _f32, _fma
from ..ops.metrics import sq_dist, sqrt_f32
from .mesh import SlabMesh, make_slab_mesh
from .sharded import _all_gather, _exchange_rows, _sync, _wire

#: metric period of the axes that do not wrap: ``round(d / L) == 0`` for
#: every real displacement (the PAD_SENTINEL's included), so the shared wrap
#: expression is the identity
_NO_WRAP = 1.0e30

#: candidates ([rows, cells, slots]) one cube pass holds at once
PASS_ELEMENTS = 1 << 25

#: queries per call of the brute-force backstop
BRUTE_ROWS = 1024


class ShardedTree(NamedTuple):
    """One rank's slab of a slab-sharded cell list, with the geometry every
    rank shares. Tensors live on ``mesh.device``."""

    xyz: torch.Tensor      # (4, npad_loc) float32, z local to the slab
    index: torch.Tensor    # (npad_loc,) int32 global indices (pad = n)
    offsets: torch.Tensor  # (ncells_loc + 1,) int32
    counts: np.ndarray     # (nd,) int64 real points of every rank's slab
    dims_loc: tuple        # (Cx, Cy, Cz_loc) local grid dims
    lo: tuple              # (lo_x, lo_y, lo_z) global lower corner
    cell_size: tuple       # (hx, hy, hz), Python floats (double)
    slab_depth: float      # z extent of one slab (Cz_loc * hz)
    periodic: bool
    boxsize: tuple | None  # (Lx, Ly, Lz) when periodic
    n: int                 # global point count
    max_cell_count: int    # fullest cell over all ranks
    mesh: SlabMesh

    @property
    def nd(self) -> int:
        return self.mesh.size

    @property
    def dims(self) -> np.ndarray:
        """Local grid dims, as :func:`..ops.knn.cube_window` reads them."""
        return np.asarray(self.dims_loc, np.int64)

    @property
    def npad(self) -> int:
        return int(self.xyz.shape[1])


def _shared_geometry(n, extent, occupancy, nd):
    """Grid geometry every rank shares: global x/y dims, z dims a multiple of
    ``nd`` so each slab owns a whole number of cells; the cell size in
    double precision, ``extent / dims``."""
    dims = choose_dims(n, extent, occupancy)
    cz = int(round_up(max(int(dims[2]), nd), nd))
    cz = min(cz, round_up(MAX_CELLS_PER_DIM, nd))
    dims = (int(dims[0]), int(dims[1]), cz)
    h = tuple(float(extent[d]) / dims[d] for d in range(3))
    return dims, h


def _slab_z0(lo_z: float, s: int, depth: float) -> float:
    """The float32 lower face of slab ``s``, ``lo_z + s * depth`` as XLA
    compiles it on the CPU (one fused multiply-add)."""
    return float(_fma(torch.tensor([s]), depth, lo_z))


def _all_max(mesh: SlabMesh, value: int) -> int:
    if mesh.group is None:
        return value
    t = _wire(mesh, torch.tensor([value], dtype=torch.int64))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t)


def build_tree_sharded(points, boxsize=None, mesh: SlabMesh | None = None,
                       occupancy: float = 8.0) -> ShardedTree:
    """Partition ``points`` into z-slabs over the mesh and build this rank's
    cell list over its slab. Every rank passes the same points (numpy or a
    tensor) and gets its own slab's :class:`ShardedTree`.

    Numpy points are assigned to slabs on the host by the JAX function's
    division ``(z - lo) / depth``; tensors on the rank's device, by its
    multiplication with ``1 / depth``, with the slab counts as the only host
    sync. Either way each rank keeps its slab's rows in point order (a
    stable partition). ``mesh`` defaults to :func:`.mesh.make_slab_mesh`,
    which raises without a card.
    """
    if mesh is None:
        mesh = make_slab_mesh()
    nd, s, dev = mesh.size, mesh.rank, mesh.device

    points = validate_points(points, boxsize)
    n = int(points.shape[0])
    periodic = boxsize is not None
    if periodic:
        box = np.broadcast_to(np.asarray(boxsize, np.float32),
                              (3,)).astype(np.float32)
        lo = np.zeros(3, np.float32)
        extent = box.astype(np.float64)
        boxsize_t = tuple(float(v) for v in box)
    else:
        boxsize_t = None
        if n > 0:
            if isinstance(points, torch.Tensor):
                mm = torch.stack([points.min(0).values,
                                  points.max(0).values]).cpu().numpy()
                pmin, pmax = mm.astype(np.float64)
            else:
                pmin = points.min(axis=0).astype(np.float64)
                pmax = points.max(axis=0).astype(np.float64)
        else:
            pmin, pmax = np.zeros(3), np.ones(3)
        span = np.maximum(pmax - pmin, 1e-12)
        lo = (pmin - 1e-6 * span).astype(np.float32)
        extent = span * (1.0 + 2e-6)

    dims, h = _shared_geometry(n, extent, occupancy, nd)
    cz_loc = dims[2] // nd
    depth = cz_loc * h[2]

    # the slab partition: every rank computes every slab's count
    if isinstance(points, torch.Tensor):
        pts = points.to(dev)
        slab = torch.floor((pts[:, 2] - _f32(lo[2])) * _f32(1.0 / depth))
        slab = slab.to(torch.int64).clamp(0, nd - 1)
        counts = torch.bincount(slab, minlength=nd).cpu().numpy()
        mine = torch.nonzero(slab == s).squeeze(1)
        p_loc, i_loc = pts[mine], mine
    else:
        zslab = np.clip(
            np.floor((points[:, 2] - lo[2]) / depth).astype(np.int64),
            0, nd - 1)
        counts = np.bincount(zslab, minlength=nd)
        mine = np.nonzero(zslab == s)[0]
        p_loc = torch.from_numpy(points[mine]).to(dev)
        i_loc = torch.from_numpy(mine).to(dev)
    counts = counts.astype(np.int64)
    npad = round_up(round_up(max(int(counts.max()), 1), 128) + 2048, 2048)

    # the local build: z made slab-local, x and y binned with the box (or
    # clipped), z clipped to the slab; a stable sort by cell id
    z0 = _slab_z0(float(lo[2]), s, depth)
    zl = p_loc[:, 2] - z0
    pl = torch.stack([p_loc[:, 0], p_loc[:, 1], zl], dim=1)
    lo_t = torch.tensor([lo[0], lo[1], 0.0], dtype=torch.float32, device=dev)
    ih_t = torch.tensor([1.0 / v for v in h], dtype=torch.float32,
                        device=dev)
    ic = torch.floor((pl - lo_t) * ih_t).to(torch.int64)
    cx, cy = dims[0], dims[1]
    if periodic:
        icx, icy = torch.remainder(ic[:, 0], cx), torch.remainder(ic[:, 1], cy)
    else:
        icx, icy = ic[:, 0].clamp(0, cx - 1), ic[:, 1].clamp(0, cy - 1)
    icz = ic[:, 2].clamp(0, cz_loc - 1)
    ncells = cx * cy * cz_loc
    sid, perm = torch.sort((icx * cy + icy) * cz_loc + icz, stable=True)
    m = pl.shape[0]
    xyz = torch.full((4, npad), float(PAD_SENTINEL), dtype=torch.float32,
                     device=dev)
    xyz[2, m:] = float(np.float32(PAD_SENTINEL) - np.float32(z0))
    xyz[:3, :m] = pl[perm].T
    index = torch.full((npad,), n, dtype=torch.int32, device=dev)
    index[:m] = i_loc[perm].to(torch.int32)
    offsets = torch.searchsorted(
        sid, torch.arange(ncells + 1, dtype=torch.int64, device=dev),
        out_int32=True)
    mcc = int(torch.diff(offsets).max()) if m else 0
    return ShardedTree(
        xyz=xyz, index=index, offsets=offsets, counts=counts,
        dims_loc=(cx, cy, cz_loc), lo=tuple(float(v) for v in lo),
        cell_size=h, slab_depth=float(depth), periodic=periodic,
        boxsize=boxsize_t, n=n, max_cell_count=_all_max(mesh, mcc),
        mesh=mesh)


# ---------------------------------------------------------------------------
# The local (one slab) exact answer: an expanding-cube ladder with per-axis
# periodicity: x and y bin with the box, z is clipped to the slab while the
# min-image metric still applies (queries delivered by a hop lie outside the
# slab).
# ---------------------------------------------------------------------------


class _Geometry(NamedTuple):
    """The local grid as :func:`..ops.knn.cube_bound` reads it, with each
    axis's kind: x and y bin with the box (or clip), z clips to the slab;
    the metric period applies on every axis."""

    dims: tuple       # local cells per axis
    lo: tuple         # local lower corner (z: 0)
    cell_size: tuple  # cell size, double
    wrap: tuple       # metric period per axis (_NO_WRAP: none)
    bin_per: tuple    # per axis: cells wrap (True) or clip


def _geometry(stree: ShardedTree) -> _Geometry:
    if stree.periodic:
        wrap = tuple(float(v) for v in stree.boxsize)
        # one slab owns the whole z extent and bins z with the box: with z
        # clipped, the wrap-adjacent cells of a query at a z face are out of
        # reach at every rung and it falls to the brute backstop. Several
        # slabs clip z: a neighbour slab is the hops' work.
        bin_per = (True, True, stree.nd == 1)
    else:
        wrap = (_NO_WRAP,) * 3
        bin_per = (False, False, False)
    return _Geometry(stree.dims_loc, (stree.lo[0], stree.lo[1], 0.0),
                     stree.cell_size, wrap, bin_per)


def _cube_pass(stree: ShardedTree, geo: _Geometry, q, qcell, k: int, r: int,
               budget: int):
    """One expanding-cube pass at radius ``r`` with ``budget`` slots per cell
    against the local tree: (d2 [m, k], slot [m, k], converged [m]). The
    bound certifies exactness among this slab's points only; the other
    slabs are the hops' work."""
    m = q.shape[0]
    ccap = min(budget, stree.npad)
    valid, slot, valid_c, _, overflow = _knn.cube_window(
        stree, qcell, (r,) * 3, ccap, periodic=geo.bin_per)
    xyz = stree.xyz
    d2 = sq_dist([q[:, d, None, None] for d in range(3)], xyz[0][slot],
                 xyz[1][slot], xyz[2][slot], geo.wrap)
    width = valid.shape[1] * ccap
    d2 = torch.where(valid_c, d2, float("inf")).reshape(m, width)
    new_d2, sel = _knn.select_k(d2, k)
    new_slot = torch.gather(slot.reshape(m, width), 1, sel)
    db, covered = _knn.cube_bound(geo, q, qcell, r, periodic=geo.bin_per,
                                  wrap=geo.wrap)
    conv = (~overflow) & ((new_d2[:, -1] < db * db) | covered)
    return new_d2, new_slot, conv


def _bands(rows: torch.Tensor, size: int):
    return [rows[a:a + size] for a in range(0, rows.shape[0], size)]


def _local_answer(stree: ShardedTree, geo: _Geometry, ladder, k: int, q,
                  stats: dict):
    """Exact k-NN of the slab-local queries ``q`` [m, 3] against this
    rank's slab: (d2 [m, k], global index [m, k] int32); missing
    neighbours get (inf, n).

    The first rung runs on every query, each later rung only on the queries
    still unconverged, and the brute backstop on what the ladder leaves;
    each in bands of rows that bound its candidate block. Every route is
    exact per query and a converged query never changes, so the bands do
    not change the answer."""
    m, dev = q.shape[0], q.device
    qcell = _knn.cell_coords(q, geo.lo, [1.0 / v for v in geo.cell_size],
                             geo.dims, geo.bin_per)
    d2 = q.new_full((m, k), float("inf"))
    slot = torch.zeros((m, k), dtype=torch.int64, device=dev)
    conv = torch.zeros((m,), dtype=torch.bool, device=dev)
    rows = torch.arange(m, device=dev)
    for rung, (r, budget) in enumerate(ladder):
        if rung:
            rows = torch.nonzero(~conv).squeeze(1)
            if rows.numel() == 0:
                break
            if rung == 1:
                stats["escalated"] += rows.numel()
        cand = (2 * r + 1) ** 3 * min(budget, stree.npad)
        for band in _bands(rows, max(1, PASS_ELEMENTS // cand)):
            bd2, bslot, bconv = _cube_pass(stree, geo, q[band], qcell[band],
                                           k, r, budget)
            d2[band], slot[band], conv[band] = bd2, bslot, bconv
    rows = torch.nonzero(~conv).squeeze(1)
    if rows.numel():
        stats["brute"] += rows.numel()
        box = None if not stree.periodic else geo.wrap
        n_loc = int(stree.counts[stree.mesh.rank])
        for band in _bands(rows, BRUTE_ROWS):
            d2[band], slot[band] = _knn._streaming_brute_pass(
                stree.xyz, n_loc, q[band], k, box)
    gidx = stree.index[slot]
    return d2, torch.where(torch.isfinite(d2), gidx, stree.n)


# ---------------------------------------------------------------------------
# The sharded query: the home slab's answer, then the hop exchange
# ---------------------------------------------------------------------------


def _hop_list(nd: int, hops: int, periodic: bool):
    """(hop, direction) rounds in order: +1 before -1; one round where the
    two directions meet on a periodic mesh (2h == nd)."""
    out = []
    for h in range(1, hops + 1):
        if periodic:
            if 2 * h < nd:
                out += [(h, +1), (h, -1)]
            elif 2 * h == nd:
                out.append((h, +1))
        elif h <= nd - 1:
            out += [(h, +1), (h, -1)]
    return out


def _face_dist(qz, h: int, direction: int, nd: int, D: float,
               periodic: bool):
    """Min-image distance from slab-local ``qz`` to the slab ``h`` hops in
    ``direction``; the home slab spans [0, D)."""
    if direction > 0:
        direct = _f32(h * D) - qz
        around = qz + _f32((nd - h - 1) * D)
    else:
        direct = qz + _f32((h - 1) * D)
        around = _f32((nd - h) * D) - qz
    if periodic and nd > 1:
        return torch.minimum(direct, around)
    return direct


def _localized(stree: ShardedTree, q, s: int):
    """Queries ``q`` with z made local to slab ``s``; periodic: the
    min-image representative about the slab's centre, so a hop's queries
    land on the near side."""
    zl = q[:, 2] - _slab_z0(stree.lo[2], s, stree.slab_depth)
    if stree.periodic:
        L = float(stree.boxsize[2])
        zl = zl - _f32(L) * torch.round(
            (zl - _f32(0.5 * stree.slab_depth)) * _f32(1.0 / L))
    return torch.cat([q[:, :2], zl[:, None]], dim=1)


def _pack(d2, gi):
    """[m, 2k] float32 rows: the distances, then the indices' bits."""
    return torch.cat([d2, gi.view(torch.float32)], dim=1)


def _unpack(rows, k: int):
    return rows[:, :k], rows[:, k:].contiguous().view(torch.int32)


def knn_query_tree_sharded(stree: ShardedTree, queries, k: int,
                           hops: int | None = None, cap: int | None = None):
    """Exact batched k-NN against a :class:`ShardedTree`, on every rank of
    its mesh with the same arguments.

    Each rank routes the queries to their home slab (the slab counts are the
    one host sync), answers its own, and exchanges the queries whose k-th
    best distance reaches past a slab face with the slab ``h`` hops away
    (``_exchange_rows`` with one destination: the global query rows out,
    ``(d2, global index)`` back). Per round a rank sends at most ``cap`` of
    its queries (default: the JAX function's shard row height); the rest,
    and the queries no round certifies, count in ``overflow``, summed over
    ranks. ``hops`` defaults to enough rounds to reach every slab.

    Returns ``(distances [Q, k] float32 ascending, indices [Q, k],
    overflow)`` on every rank: numpy with uint32 indices for array queries,
    tensors on the rank's device with int32 indices for tensor queries.
    ``overflow == 0`` certifies an exact answer.

    After each call ``knn_query_tree_sharded.stats`` holds this rank's
    seconds in the local answers and in the exchanges, each round's rows
    sent, received and over ``cap``, the rows that escalated past the first
    rung and that reached the brute backstop, and the overflow.
    """
    if k <= 0:
        raise ValueError("k must be positive")
    mesh = stree.mesh
    nd, s, dev = mesh.size, mesh.rank, mesh.device
    periodic = stree.periodic
    hop_max = nd // 2 if periodic else nd - 1
    hops = hop_max if hops is None else max(0, min(int(hops), hop_max))

    tensor_in = isinstance(queries, torch.Tensor)
    q = _knn.as_queries(queries, dev)
    if q.dim() != 2 or q.shape[1] != 3:
        raise ValueError(f"queries must have shape (Q, 3), got "
                         f"{tuple(q.shape)}")
    Q = q.shape[0]
    stats = {"local_s": 0.0, "exchange_s": 0.0, "rounds": [],
             "escalated": 0, "brute": 0, "overflow": 0}
    knn_query_tree_sharded.stats = stats
    if Q == 0:
        d = torch.zeros((0, k), dtype=torch.float32, device=dev)
        i = torch.zeros((0, k), dtype=torch.int32, device=dev)
        if tensor_in:
            return d, i, 0
        return d.cpu().numpy(), i.cpu().numpy().astype(np.uint32), 0

    # routing: wrap, assign slabs; each rank keeps its slab's queries in
    # caller order (the JAX function's stable sort by slab)
    if periodic:
        L = torch.tensor(stree.boxsize, dtype=torch.float32, device=dev)
        q = q - L * torch.floor(q / L)
    slab = torch.floor((q[:, 2] - _f32(stree.lo[2]))
                       * _f32(1.0 / stree.slab_depth))
    slab = slab.to(torch.int64).clamp(0, nd - 1)
    counts = torch.bincount(slab, minlength=nd).tolist()
    order = torch.argsort(slab, stable=True)
    start = sum(counts[:s])
    mine = order[start:start + counts[s]]
    qg = q[mine]

    # the JAX function's shard row height, which caps each round's band
    qloc = round_up(max(max(counts), 1), 8)
    ql = 8
    while ql < qloc:
        ql *= 2
    qloc = min(ql, round_up(round_up(Q, 128), 8))
    cap = qloc if cap is None else min(max(int(cap), 8), qloc)

    geo = _geometry(stree)
    ladder = _knn.default_ladder(stree)

    def answer(rows):
        _sync(dev)
        t0 = time.perf_counter()
        out = _local_answer(stree, geo, ladder, k, rows, stats)
        _sync(dev)
        stats["local_s"] += time.perf_counter() - t0
        return out

    def exchange(rows, dst):
        counts_out = [0] * nd
        if dst is not None:
            counts_out[dst] = rows.shape[0]
        t0 = time.perf_counter()
        got = _exchange_rows(mesh, rows, counts_out)
        _sync(dev)
        stats["exchange_s"] += time.perf_counter() - t0
        return got

    home = _localized(stree, qg, s)
    qz = home[:, 2]
    d2, gi = answer(home)
    overflow = 0
    D = stree.slab_depth
    for h, direction in _hop_list(nd, hops, periodic):
        # squared compare: no root's rounding in the prune decision
        fd = _face_dist(qz, h, direction, nd, D, periodic)
        if periodic and 2 * h == nd:
            fd = torch.minimum(fd, _face_dist(qz, h, -1, nd, D, periodic))
        fd = torch.clamp_min(fd, 0.0)
        active = d2[:, -1] > fd * fd
        if periodic:
            dst, src = (s + direction * h) % nd, (s - direction * h) % nd
        else:
            dst, src = s + direction * h, s - direction * h
            dst = dst if 0 <= dst < nd else None
            src = src if 0 <= src < nd else None
            if dst is None:
                active = torch.zeros_like(active)
        band = torch.nonzero(active).squeeze(1)
        over = max(band.shape[0] - cap, 0)
        overflow += over
        band = band[:cap]
        got = exchange(qg[band], dst)
        rd2, rgi = answer(_localized(stree, got, s))
        back = _unpack(exchange(_pack(rd2, rgi), src), k)
        stats["rounds"].append({"hop": h, "direction": direction,
                                "sent": band.shape[0],
                                "received": got.shape[0],
                                "over_cap": over})
        # merge as [home, returned]: ties keep the home row
        cat_d2 = torch.cat([d2[band], back[0]], dim=1)
        cat_gi = torch.cat([gi[band], back[1]], dim=1)
        m_d2, pick = _knn.select_k(cat_d2, k)
        d2[band] = m_d2
        gi[band] = torch.gather(cat_gi, 1, pick)

    # certification: every unvisited slab must lie past the k-th best
    if periodic:
        if 2 * hops + 1 < nd:
            f_next = torch.clamp_min(torch.minimum(
                _face_dist(qz, hops + 1, +1, nd, D, periodic),
                _face_dist(qz, hops + 1, -1, nd, D, periodic)), 0.0)
            overflow += int((d2[:, -1] > f_next * f_next).sum())
    elif hops < nd - 1:
        h1 = hops + 1
        inf = torch.full_like(qz, float("inf"))
        f_up = (torch.clamp_min(_face_dist(qz, h1, +1, nd, D, periodic), 0.0)
                if s < nd - h1 else inf)
        f_dn = (torch.clamp_min(_face_dist(qz, h1, -1, nd, D, periodic), 0.0)
                if s >= h1 else inf)
        f_next = torch.minimum(f_up, f_dn)
        overflow += int((d2[:, -1] > f_next * f_next).sum())
    if mesh.group is not None:
        t = _wire(mesh, torch.tensor([overflow], dtype=torch.int64))
        dist.all_reduce(t, group=mesh.group)
        overflow = int(t)
    stats["overflow"] = overflow

    # every rank gathers every rank's rows and puts them in caller order
    rows = _pack(d2, gi)
    qmax = max(counts)
    if rows.shape[0] < qmax:
        rows = torch.cat([rows, rows.new_zeros((qmax - rows.shape[0],
                                                2 * k))])
    parts = _all_gather(mesh, rows)
    full = torch.cat([p[:c] for p, c in zip(parts, counts)]).to(dev)
    d2_all, gi_all = _unpack(full, k)
    d = torch.empty_like(d2_all)
    i = torch.empty_like(gi_all)
    d[order] = sqrt_f32(d2_all)
    i[order] = gi_all
    if tensor_in:
        return d, i, overflow
    return d.cpu().numpy(), i.cpu().numpy().astype(np.uint32), overflow


knn_query_tree_sharded.stats = None
