"""Dense-window deposition for radii above the tile engine's last bucket.

PyTorch port of :mod:`nbodyhpc_tpu.ops.splat_dense`. The reference renders
arbitrarily large points (unbounded ``gl_PointSize``, reference:
rasterization/shaders/triangle.vert:43-44,63); the tile engine
(``ops/splat_cuda.py``) stops at 15 px, so larger radii take this pass.

On a card, :func:`splat_volume_dense` runs the kernels of
``csrc/splat_dense.cu`` (:func:`dense_deposit`): the rows are binned by
tiles of the volume (their extent is the source's), and each tile
accumulates the rows that meet it in shared memory, each row over its own
footprint. The JAX module has no
Pallas kernel here; the kernel replaces none.

On the CPU it runs the plain twin :func:`dense_reference`, which is also
the kernel's oracle:

- Each particle's footprint is evaluated densely on a static F^3 window
  (F = 2*halfwidth + 1) by :func:`.splat.footprint_values`, so per-voxel
  values are the oracle's own.
- The window origin is clamped inside the grid (the volume is padded so
  every axis is >= F). Every formula in ``footprint_values`` is elementwise
  in absolute voxel coordinates, so a clamped window still covers exactly
  footprint ∩ grid, and the voxels it adds outside the footprint get zero.
- Windows are accumulated with ``index_add_``, in particle order.
"""
from __future__ import annotations


import torch

from .. import _build
from ..utils import profiling
from .splat import (
    FOUR_THIRDS_PI,
    MAX_SUBSAMPLE,
    as_f32,
    footprint_values,
    require as _require,
    required_halfwidth,
)

#: the dense kernel's counters: voxels its interior runs filled, voxels it
#: counted one by one (the shells); kept only while a profiler records
DENSE_COUNTERS = ("splat.dense.run_voxels", "splat.dense.shell_voxels")

#: geometric halfwidth ladder; bucket R covers pixel radii <= R - 3
#: (required_halfwidth = ceil(rpx) + 3)
HALF_BUCKETS = (12, 20, 36, 68, 132, 260)


def dense_halfwidth(max_rpx: float) -> int:
    """Smallest bucket halfwidth covering ``max_rpx``; the exact halfwidth
    when beyond the ladder (unbounded radii)."""
    need = required_halfwidth(max_rpx)
    for r in HALF_BUCKETS:
        if need <= r:
            return r
    return need


def _default_chunk(F: int) -> int:
    """Particles per footprint-evaluation chunk: bounds the (chunk, F, F, F)
    transient to ~16 MiB of float32."""
    c = max(1, (1 << 22) // (F * F * F))
    p = 1
    while p * 2 <= min(c, 256):
        p *= 2
    return p


def splat_volume_dense(positions_px, weights, radii_px, grid,
                       subsample: int = 4, vol0=None,
                       max_radius_px: float | None = None) -> torch.Tensor:
    """Render (or accumulate onto ``vol0``) the dense large-radius pass.

    Takes pixel-space positions/radii. Returns the (gx, gy, gz) float32
    field on the inputs' device: on a card :func:`dense_deposit` adds onto
    ``vol0`` in place; on the CPU :func:`dense_reference`, whose window is
    picked from :data:`HALF_BUCKETS` via ``max_radius_px`` (computed, one
    device sync, when not given).
    """
    gx, gy, gz = (int(v) for v in grid)
    positions_px = as_f32(positions_px)
    dev = positions_px.device
    weights = as_f32(weights, dev)
    radii_px = as_f32(radii_px, dev)
    n = positions_px.shape[0]
    if vol0 is None:
        vol0 = torch.zeros((gx, gy, gz), dtype=torch.float32, device=dev)
    if n == 0:
        return vol0
    if dev.type == "cuda":
        return dense_deposit(positions_px, weights, radii_px, vol0, subsample)
    if max_radius_px is None:
        max_radius_px = float(radii_px.max())
    return dense_reference(positions_px, weights, radii_px, vol0, subsample,
                           max_radius_px)


def dense_reference(positions_px, weights, radii_px, vol0, subsample: int,
                    max_radius_px: float) -> torch.Tensor:
    """Plain twin of the dense kernel: every row on one static window from
    :data:`HALF_BUCKETS`, in chunks from a host loop (see the module's
    docstring). ``vol0`` is updated in place and returned when no axis
    needs padding (every axis >= F), so the pass holds no second
    grid-sized buffer."""
    gx, gy, gz = vol0.shape
    dev = vol0.device
    n = positions_px.shape[0]
    R = dense_halfwidth(max_radius_px)
    F = 2 * R + 1
    chunk = _default_chunk(F)

    # pad every axis to >= F so a clamped window always fits inside
    gxp, gyp, gzp = max(gx, F), max(gy, F), max(gz, F)
    vol = vol0
    if (gxp, gyp, gzp) != (gx, gy, gz):
        vol = torch.zeros((gxp, gyp, gzp), dtype=torch.float32, device=dev)
        vol[:gx, :gy, :gz] = vol0
    lim = torch.tensor([gxp - F, gyp - F, gzp - F], dtype=torch.int32,
                       device=dev)
    off = torch.arange(F, dtype=torch.int64, device=dev)
    flat_vol = vol.view(-1)
    for s in range(0, n, chunk):
        p = positions_px[s:s + chunk]
        b0 = torch.floor(p).to(torch.int32) - R
        cb = torch.minimum(b0.clamp_min(0), lim)
        _, vals = footprint_values(p, weights[s:s + chunk],
                                   radii_px[s:s + chunk], R, subsample,
                                   base=cb)
        cb = cb.long()
        ix = cb[:, 0:1] + off
        iy = cb[:, 1:2] + off
        iz = cb[:, 2:3] + off
        flat = ((ix[:, :, None, None] * gyp + iy[:, None, :, None]) * gzp
                + iz[:, None, None, :])
        flat_vol.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    if vol is vol0:
        return vol
    return vol[:gx, :gy, :gz].contiguous()


def dense_deposit(positions_px, weights, radii_px, vol,
                  subsample: int) -> torch.Tensor:
    """Add the rows' footprints to ``vol`` (a contiguous float32 (gx, gy,
    gz) tensor on the card) in place, by the kernels of
    ``csrc/splat_dense.cu``; returns ``vol``.

    Per voxel the value is :func:`dense_reference`'s; only the order of the
    sums differs (each tile's columns in the tile list's order, then one
    add into the volume). Bound by the voxels the spheres hold: each tile
    of the volume is summed in shared memory, one thread a column with
    plain adds, and written once. Along a column a row's interior voxels
    form one run, found by exact tests at its ends and filled with the
    row's factor; only the shell around it takes the per-voxel subcell
    count (see the source). The binning reads one number back, the length
    of the tile lists (one device sync). One span,
    ``nbodyhpc.render.dense.bin``, times the per-row factors and the
    binning; counter ``splat.dense.launches``. While a profiler records,
    the kernel also counts on the card the voxels its runs filled and those
    it counted one by one, :data:`DENSE_COUNTERS`, which
    :func:`~nbodyhpc_tpu_torch.utils.profiling.counters` reads back; with
    no profiler the kernel counts nothing.
    """
    dev = vol.device
    _require(dev.type == "cuda", f"dense_deposit: unsupported device {dev}")
    _require(all(t.device == dev for t in (positions_px, weights, radii_px)),
             "dense_deposit: all tensors must be on one device")
    _require(vol.dtype == torch.float32 and vol.dim() == 3
             and vol.is_contiguous(),
             "dense_deposit: vol must be a contiguous float32 (gx, gy, gz) "
             "tensor")
    _require(1 <= subsample <= MAX_SUBSAMPLE,
             f"dense_deposit: subsample must be in [1, {MAX_SUBSAMPLE}]")
    n = positions_px.shape[0]
    _require(positions_px.shape == (n, 3) and weights.shape == (n,)
             and radii_px.shape == (n,),
             "dense_deposit: positions must be [n, 3], weights and radii [n]")
    if n == 0:
        return vol
    grid = tuple(vol.shape)
    lib = _build.load().lib
    ntiles = lib.splat_dense_tiles(*grid)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with profiling.span("nbodyhpc.render.dense.bin"):
        pos = positions_px.contiguous()
        rad = radii_px.contiguous()
        # each row's factor: footprint_values's w / (4/3 pi rp^3), or the
        # raw weight of a sub-pixel row
        volume = FOUR_THIRDS_PI * (rad * rad * rad)
        val = torch.where(rad < 0.5, weights, weights / volume).contiguous()
        cnt = torch.empty(ntiles, dtype=torch.int32, device=dev)
        off = torch.empty(ntiles + 1, dtype=torch.int64, device=dev)
        err = lib.splat_dense_count(pos.data_ptr(), rad.data_ptr(),
                                    val.data_ptr(), n, *grid, cnt.data_ptr(),
                                    off.data_ptr(), stream)
        _build.check(err, "splat_dense_count launch")
        total = int(off[-1])
        if total == 0:
            return vol
        rows = torch.empty(total, dtype=torch.int32, device=dev)
        err = lib.splat_dense_fill(pos.data_ptr(), rad.data_ptr(),
                                   val.data_ptr(), n, *grid, off.data_ptr(),
                                   cnt.data_ptr(), rows.data_ptr(), stream)
        _build.check(err, "splat_dense_fill launch")
    counts = profiling.device_counts(DENSE_COUNTERS, dev)
    err = lib.splat_dense(pos.data_ptr(), rad.data_ptr(), val.data_ptr(),
                          off.data_ptr(), rows.data_ptr(), subsample,
                          vol.data_ptr(), *grid,
                          None if counts is None else counts.data_ptr(),
                          stream)
    profiling.count("splat.dense.launches")
    _build.check(err, "splat_dense launch")
    return vol
