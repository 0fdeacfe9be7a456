"""Sharded render and query pipelines on ``torch.distributed``.

PyTorch port of :mod:`nbodyhpc_tpu.parallel.sharded`. The grid's z axis is
cut into slabs, one per rank (reference: rasterization/src/cpp/
point_renderer.cpp:857-946). Each rank keeps the particles whose centre
lies in its slab and sends every particle whose footprint reaches another
slab to that slab's rank, the analog of the reference's ``max_radius`` cull
margin (point_renderer.cpp:857-862). k-NN queries are data-parallel: every
rank holds the whole cell list and answers its slice of the queries.

SPMD contract: every rank of the mesh calls the same function with the same
arguments, and every rank returns the whole answer. On gloo the exchanges
stage their tensors through host memory; the compute stays on the rank's
device.
"""
from __future__ import annotations

import math
import time
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.cells import CellList
from ..core.points import round_up
from ..ops import knn as _knn
from ..ops import splat_cuda
from ..ops.ghosts import augment_points_periodic
from ..ops.splat import as_f32
from .mesh import SlabMesh, _host_staged, make_slab_mesh

#: extra z margin (pixels) beyond the pixel radius that a splat can reach
#: (coverage square + sub-pixel snap), mirroring the reference's cull margin.
Z_MARGIN = 2.0

#: rows of a slab rendered in one call when the caller gives no ``batch``
#: and a rank holds more rows than this
DEFAULT_BATCH = 4_000_000

#: bytes of slab each rank contributes to one step of the field's gather
GATHER_CHUNK_BYTES = 256 << 20


def _wire(mesh: SlabMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the mesh's backend takes it: host memory on gloo, the
    rank's device otherwise."""
    return t.cpu() if _host_staged(mesh) else t.to(mesh.device)


def _all_gather(mesh: SlabMesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (same shape on every rank), in rank order, where
    the backend holds them (see :func:`_wire`)."""
    src = _wire(mesh, t.contiguous())
    if mesh.group is None:
        return [src]
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return parts


def _exchange_rows(mesh: SlabMesh, rows: torch.Tensor,
                   counts: list) -> torch.Tensor:
    """All-to-all of float32 rows: ``rows`` holds ``counts[j]`` rows for
    rank j, in rank order. The counts go first, so each rank sizes its
    receive buffer exactly. Returns the rows every rank sent here, in rank
    order, on the mesh's device."""
    send_counts = _wire(mesh, torch.tensor(counts, dtype=torch.int64))
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts, group=mesh.group)
    recv = recv_counts.tolist()
    out = _wire(mesh, rows.new_empty((sum(recv), rows.shape[1])))
    dist.all_to_all_single(out, _wire(mesh, rows),
                           output_split_sizes=recv,
                           input_split_sizes=list(counts), group=mesh.group)
    return out.to(mesh.device)


def _period(periodic, gx: int, gy: int, gz: int, ppu: float):
    """The render's periodic box in position units (<= 0: open), as the
    JAX function normalises ``periodic``."""
    if periodic is True:
        return (gx / ppu, gy / ppu, gz / ppu)
    if periodic is False:
        return (-1.0, -1.0, -1.0)
    return tuple(float(v) for v in np.broadcast_to(periodic, (3,)))


def _halo(ppx, w, rpx, s: int, nd: int, hops: int, gz_loc: int):
    """The rows of rank ``s``'s slab whose footprint reaches another slab,
    grouped by destination rank: (rows [n, 5] as (x, y, z, w, r) in pixel
    units, counts per rank). Rank j below s takes a row when the footprint
    reaches under j's top face, rank j above when it reaches j's bottom
    face, up to ``hops`` slabs away; zero-weight rows never go. These are
    the JAX function's float32 comparisons (strict below, non-strict
    above)."""
    z = ppx[:, 2]
    live = w != 0.0
    rows = torch.cat([ppx, w[:, None], rpx[:, None]], dim=1)
    parts, counts = [], [0] * nd
    for j in range(max(0, s - hops), min(nd, s + hops + 1)):
        if j < s:
            mask = (z - (rpx + Z_MARGIN) < (j + 1) * gz_loc) & live
        elif j > s:
            mask = (z + rpx + Z_MARGIN >= j * gz_loc) & live
        else:
            continue
        parts.append(rows[mask])
        counts[j] = parts[-1].shape[0]
    if not parts:
        return rows[:0], counts
    return torch.cat(parts), counts


def _gather_slabs(mesh: SlabMesh, slab: torch.Tensor):
    """Every rank's (gx, gy, gz_loc) slab as one (gx, gy, gz) float32 numpy
    volume, on every rank, gathered a few x planes at a time so no rank
    holds a second volume-sized buffer on its device. Returns (volume,
    seconds spent in the all-gather calls)."""
    gx, gy, gz_loc = slab.shape
    nd = mesh.size
    if mesh.group is None:
        return slab.cpu().numpy(), 0.0
    out = np.empty((gx, gy, nd * gz_loc), np.float32)
    out_t = torch.from_numpy(out)
    step = max(1, GATHER_CHUNK_BYTES // max(4 * gy * gz_loc, 1))
    wire_s = 0.0
    for x0 in range(0, gx, step):
        x1 = min(gx, x0 + step)
        t0 = time.perf_counter()
        parts = _all_gather(mesh, slab[x0:x1])
        wire_s += time.perf_counter() - t0
        dst = out_t[x0:x1].view(x1 - x0, gy, nd, gz_loc)
        for r, part in enumerate(parts):
            dst[:, :, r].copy_(part)
    return out, wire_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_points_volume_sharded(
    positions,
    weights,
    radii,
    pixels_per_unit: float,
    grid,
    periodic=False,
    mesh: SlabMesh | None = None,
    subsample: int = 4,
    band_cap: int | None = None,
    batch: int | None = None,
) -> Tuple[np.ndarray, int]:
    """Render a z-slab-sharded density volume over the mesh.

    Semantics match :func:`nbodyhpc_tpu_torch.rasterizer.render_points_volume`
    (periodic wrap via ghost augmentation). Every rank passes the same
    inputs (numpy or tensors) and gets the whole volume back. Returns
    (volume (gx, gy, gz) float32 numpy, overflow). Overflow is always 0:
    each rank receives exactly the rows it is sent (the counts are
    exchanged first), so no band is cut, and the dense tail is not capped.
    ``band_cap`` is accepted so callers of the JAX function run unchanged;
    it has no effect here.

    Rank s renders its slab ``[s * gz / nd, (s + 1) * gz / nd)`` with
    :func:`..ops.splat_cuda.splat_volume` (the kernels on a CUDA device,
    their plain versions on the CPU). ``batch`` bounds the rows per render
    call: the slab's rows go in ``batch``-row slices summed onto one field,
    by default 4e6-row slices when a rank holds more rows than that.

    After each call ``render_points_volume_sharded.stats`` holds this
    rank's halo depth ``hops``, the rows it sent down and up, the rows it
    received, the bytes it sent and received, and the seconds of the
    exchange, of the gather and of the gather's all-gather calls (their
    tensors staged to the host on gloo; on NCCL the host copy after each
    call waits for it).
    """
    del band_cap  # bands are sized by exchanged counts
    if mesh is None:
        mesh = make_slab_mesh()
    nd, s, dev = mesh.size, mesh.rank, mesh.device

    gx, gy, gz = (int(v) for v in
                  (grid if not np.isscalar(grid) else (grid,) * 3))
    if gz % nd != 0:
        raise ValueError(f"grid z ({gz}) must divide over {nd} devices")
    gz_loc = gz // nd
    ppu = float(pixels_per_unit)

    positions = as_f32(positions, dev)
    weights = as_f32(weights, dev)
    radii = as_f32(radii, dev)
    period = _period(periodic, gx, gy, gz, ppu)
    if any(p > 0 for p in period):
        positions, weights, radii = augment_points_periodic(
            positions, weights, radii, period)

    ppx = positions * ppu
    rpx = radii * ppu
    max_rpx = float(rpx.max()) if rpx.numel() else 0.0
    hops = min(nd - 1, max(1, math.ceil((max_rpx + Z_MARGIN) / gz_loc)))

    # slab ownership by particle centre, as the JAX host partition's
    # floor division
    owner = torch.div(ppx[:, 2], float(gz_loc), rounding_mode="floor")
    mine = owner.clamp(0, nd - 1) == s
    ppx, weights, rpx = ppx[mine], weights[mine], rpx[mine]

    t0 = time.perf_counter()
    band, counts = _halo(ppx, weights, rpx, s, nd, hops, gz_loc)
    recv = (band.new_empty((0, 5)) if mesh.group is None
            else _exchange_rows(mesh, band, counts))
    _sync(dev)
    exchange_s = time.perf_counter() - t0

    all_p = torch.cat([ppx, recv[:, :3]])
    all_w = torch.cat([weights, recv[:, 3]])
    all_r = torch.cat([rpx, recv[:, 4]])
    all_p[:, 2] -= float(s * gz_loc)

    n = all_w.shape[0]
    if batch is None and n > DEFAULT_BATCH:
        batch = DEFAULT_BATCH
    step = max(int(batch), 1) if batch else max(n, 1)
    field = torch.zeros((gx, gy, gz_loc), dtype=torch.float32, device=dev)
    for b0 in range(0, n, step):
        field = splat_cuda.splat_volume(
            all_p[b0:b0 + step], all_w[b0:b0 + step], all_r[b0:b0 + step],
            1.0, (gx, gy, gz_loc), subsample, vol0=field)

    _sync(dev)
    t0 = time.perf_counter()
    volume, wire_s = _gather_slabs(mesh, field)
    gather_s = time.perf_counter() - t0
    render_points_volume_sharded.stats = {
        "hops": hops,
        "rows_down": sum(counts[:s]), "rows_up": sum(counts[s + 1:]),
        "rows_received": recv.shape[0],
        "exchange_bytes": 20 * (band.shape[0] + recv.shape[0]),
        "exchange_s": exchange_s, "gather_s": gather_s,
        "gather_wire_s": wire_s,
    }
    return volume, 0


render_points_volume_sharded.stats = None


# ---------------------------------------------------------------------------
# Sharded k-NN: replicated tree, sharded query batches
# ---------------------------------------------------------------------------


def _tree_mesh(tree: CellList, mesh: SlabMesh | None) -> SlabMesh:
    """The mesh a tree's queries run on: by default the process group (or
    a world of one) on the tree's device; a given mesh must name it."""
    if mesh is None:
        return make_slab_mesh(device=tree.device)
    if mesh.device != tree.device:
        raise ValueError(f"the tree lives on {tree.device}, the mesh's "
                         f"device is {mesh.device}")
    return mesh


def knn_query_sharded(tree: CellList, queries, k: int,
                      mesh: SlabMesh | None = None):
    """Batched exact k-NN with the query set sharded over the mesh.

    Every rank passes the same cell list and the same queries; rank r
    answers the r-th of ``nd`` slices of ``round_up(ceil(Q / nd), 8)``
    queries (the last padded with zero rows) through
    :func:`..ops.knn.cell_knn_query`, so on the card through the candidate
    kernels where "auto" takes them. The answers are gathered, and every
    rank returns (distances [Q, k] float32, indices [Q, k] int32) as numpy.
    This is the reference's per-query thread fan-out
    (kdtree/src/cpp/pybind.cpp:164-172) lifted from threads to ranks.
    """
    mesh = _tree_mesh(tree, mesh)
    nd, s = mesh.size, mesh.rank

    queries = np.asarray(queries, np.float32)
    Q = queries.shape[0]
    qloc = round_up(max((Q + nd - 1) // nd, 1), 8)
    qpad = np.zeros((nd * qloc, 3), np.float32)
    qpad[:Q] = queries

    res = _knn.cell_knn_query(tree, qpad[s * qloc:(s + 1) * qloc], k)
    d = torch.cat(_all_gather(mesh, res.distances))
    i = torch.cat(_all_gather(mesh, res.indices))
    return d[:Q].cpu().numpy(), i[:Q].cpu().numpy()
