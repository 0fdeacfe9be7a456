"""Dense-window deposition for radii above the tile engine's last bucket.

PyTorch port of :mod:`nbodyhpc_tpu.ops.splat_dense`. The reference renders
arbitrarily large points (unbounded ``gl_PointSize``, reference:
rasterization/shaders/triangle.vert:43-44,63); the tile engine
(``ops/splat_cuda.py``) stops at 15 px, so larger radii take this pass:

- Each particle's footprint is evaluated densely on a static F^3 window
  (F = 2*halfwidth + 1) by :func:`.splat.footprint_values`, so per-voxel
  values are the oracle's own.
- The window origin is clamped inside the grid (the volume is padded so
  every axis is >= F). Every formula in ``footprint_values`` is elementwise
  in absolute voxel coordinates, so a clamped window still covers exactly
  footprint ∩ grid, and the voxels it adds outside the footprint get zero.
- Windows are accumulated with ``index_add_``, in particle order.

The JAX module has no Pallas kernel here, and neither does the port: large
radii are a tail population, and plain torch is the whole pass.
"""
from __future__ import annotations

import torch

from .splat import as_f32, footprint_values, required_halfwidth

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

    Takes pixel-space positions/radii. The footprint halfwidth is picked
    from :data:`HALF_BUCKETS` via ``max_radius_px`` (computed, one device
    sync, when not given). Returns the (gx, gy, gz) float32 field on the
    inputs' device. ``vol0`` is updated in place and returned when no axis
    needs padding (every axis >= F), so the pass holds no second
    grid-sized buffer.
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
    if max_radius_px is None:
        max_radius_px = float(radii_px.max())
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
