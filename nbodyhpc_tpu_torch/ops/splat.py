"""Mass-conserving anti-aliased sphere-splat deposition (reference semantics).

PyTorch port of :mod:`nbodyhpc_tpu.ops.splat`, the semantic oracle of the
rasterizer. It reproduces the deposition math of the reference's shader pair
(reference: rasterization/shaders/triangle.vert:26-70 and
triangle.frag:14-46) and its per-slice volume loop
(rasterization/src/cpp/point_renderer.cpp:825-950):

In pixel units (``Ppx = position * pixels_per_unit``, ``rpx = radius * ppu``):

- A particle is *sub-pixel* when ``rpx < 0.5``: its full weight goes into the
  single voxel containing it, tie-broken to the lower slice by the z-select
  ``z in (slice_lower, slice_upper]`` (triangle.vert:47-60).
- Otherwise it renders on every slice with ``|z_offset_px| <= rpx + 1`` (the
  ``gl_ClipDistance`` cull); on a slice at distance ``z_offset`` it covers the
  square of pixels whose centers fall within half-side
  ``ceil(plane_radius_px) + 1`` of the particle, where
  ``plane_radius = sqrt(r^2 - z_offset^2)``. Each covered voxel receives
  ``weight / (4/3 pi rpx^3) * overlap`` with ``overlap`` the fraction of the
  voxel's S^3 sub-cell centers inside the sphere (triangle.frag:25-45).

Voxel (ix, iy, iz) covers ``[ix, ix+1) x [iy, iy+1) x [iz, iz+1)`` in pixel
space; output axis order is (x, y, z).

Every expression keeps the JAX oracle's float32 association order, in
particular the subcell compare ``az < r2 - (ax + ay)``, so the two agree
exactly below 4 px. At larger radii XLA may contract that chain into FMAs
and flip a knife-edge subcell compare: the tests budget at most one S^-3
quantum per voxel there (``tests/test_splat_dense.py::_quantum_atol``).

Functions take float32 tensors (numpy arrays are accepted and land on the
CPU) and return tensors on the inputs' device. The splat engine's plain
deposit (``ops/splat_cuda.py::deposit_reference``) is built on
:func:`footprint_terms`.
"""
from __future__ import annotations

import math

import torch

FOUR_THIRDS_PI = 4.0 / 3.0 * math.pi
#: largest subsample factor the splat kernels take (``kMaxS`` of
#: ``csrc/splat_common.h``)
MAX_SUBSAMPLE = 16


def require(cond: bool, msg: str) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``: the kernel wrappers'
    argument checks."""
    if not cond:
        raise ValueError(msg)


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor (numpy arrays and lists land on ``device``,
    default the CPU; tensors keep their device unless one is given)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def required_halfwidth(max_rpx: float) -> int:
    """Static footprint half-extent (in voxels) covering any particle with
    pixel radius <= max_rpx: the coverage square needs ceil(plane_r)+1 pixels
    beyond the base pixel, and the z-cull admits |z_offset| <= rpx + 1."""
    return int(math.ceil(max(max_rpx, 0.0))) + 3


def _subcell_centers(subsample: int, device) -> torch.Tensor:
    # made on the CPU: a CUDA division by a Python scalar multiplies by its
    # rounded reciprocal, which is not the quotient unless S is a power of 2
    return ((torch.arange(subsample, dtype=torch.float32) + 0.5)
            / subsample).to(device)


def _subcell_fraction(count, subsample: int) -> torch.Tensor:
    """count / S^3 in float32, the true quotient on every device (a tensor
    divisor, so CUDA does not multiply by a rounded reciprocal)."""
    s3 = torch.full((), float(subsample**3), device=count.device)
    return count.float() / s3


def footprint_terms(ppx, rpx, base, size: int, subsample: int):
    """Weight-free terms of every particle on a ``size``^3 window at ``base``.

    Parameters
    ----------
    ppx : (C, 3) float32 — positions in pixel units.
    rpx : (C,) float32 — radii in pixel units.
    base : (C, 3) int32 — window lower corner voxels. Every formula is
        elementwise in absolute voxel coordinates, so the window may sit
        anywhere; voxels outside the true footprint get zero terms.
    size : int — window extent per axis.
    subsample : int — S, the anti-aliasing subsample factor.

    Returns
    -------
    overlap : (C, F, F, F) float32 — S^3 sub-cell fraction inside the sphere.
    cover : (C, F, F, F) bool — coverage square and z-cull.
    sub_mask : (C, F, F, F) bool — the sub-pixel voxel (if any).
    """
    F = size
    dev = ppx.device
    px, py, pz = ppx[:, 0], ppx[:, 1], ppx[:, 2]
    off = torch.arange(F, dtype=torch.int32, device=dev)
    vx = base[:, 0:1] + off[None, :]  # (C, F)
    vy = base[:, 1:2] + off[None, :]
    vz = base[:, 2:3] + off[None, :]
    vxf, vyf, vzf = vx.float(), vy.float(), vz.float()

    # --- big-particle gates (triangle.vert:41-45,61-63) ---
    zoff = pz[:, None] - (vzf + 0.5)  # (C, F)
    zclip = zoff.abs() <= rpx[:, None] + 1.0  # gl_ClipDistance cull
    r_col = rpx[:, None]
    plane_r = torch.sqrt(torch.clamp_min(r_col * r_col - zoff * zoff, 0.0))
    half = torch.ceil(plane_r) + 1.0  # (C, F) half point-size in pixels
    cx = vxf + 0.5 - px[:, None]  # (C, F) center offsets
    cy = vyf + 0.5 - py[:, None]
    # pixel covered iff center in [p - half, p + half)
    cov_x = (cx[:, :, None] >= -half[:, None, :]) & (cx[:, :, None] < half[:, None, :])
    cov_y = (cy[:, :, None] >= -half[:, None, :]) & (cy[:, :, None] < half[:, None, :])
    cover = (
        cov_x[:, :, None, :] & cov_y[:, None, :, :] & zclip[:, None, None, :]
    )  # (C, Fx, Fy, Fz)

    # --- overlap: fraction of S^3 sub-cell centers inside the sphere ---
    u = _subcell_centers(subsample, dev)
    ax = px[:, None, None] - vxf[:, :, None] - u  # (C, F, S) corner deltas
    ay = py[:, None, None] - vyf[:, :, None] - u
    az = pz[:, None, None] - vzf[:, :, None] - u
    ax, ay, az = ax * ax, ay * ay, az * az
    r2 = (rpx * rpx)[:, None, None, None, None]
    count = torch.zeros(cover.shape, dtype=torch.int32, device=dev)
    for a in range(subsample):
        for b in range(subsample):
            # (C, Fx, Fy, 1, 1): compare az < r^2 - (ax + ay), hoisting the
            # z-independent part (the JAX oracle and kernel share this order)
            m = ax[:, :, a][:, :, None, None, None] + ay[:, :, b][:, None, :, None, None]
            inside = az[:, None, None, :, :] < r2 - m
            count += inside.sum(-1, dtype=torch.int32)
    overlap = _subcell_fraction(count, subsample)

    # --- sub-pixel voxel (triangle.vert:47-60) ---
    sub_x = vx == torch.floor(px).to(torch.int32)[:, None]
    sub_y = vy == torch.floor(py).to(torch.int32)[:, None]
    # z in (slice_lower, slice_upper] with slice = [vz, vz+1) pixels
    sub_z = (pz[:, None] > vzf) & (pz[:, None] <= vzf + 1.0)
    sub_mask = (
        sub_x[:, :, None, None] & sub_y[:, None, :, None] & sub_z[:, None, None, :]
    )
    return overlap, cover, sub_mask


def footprint_values(ppx, w, rpx, halfwidth: int, subsample: int, base=None):
    """Per-particle footprint contributions on a static (F, F, F) window,
    F = 2 * halfwidth + 1.

    ``base`` : (C, 3) int32, optional — explicit window origins (the dense
    large-radius pass clamps them inside the grid). Default:
    ``floor(ppx) - halfwidth`` (centered).

    Returns ``base`` (C, 3) int32 and ``vals`` (C, F, F, F) float32, the
    deposition into voxel ``base + offset``.
    """
    R = halfwidth
    if base is None:
        base = torch.floor(ppx).to(torch.int32) - R
    overlap, cover, sub_mask = footprint_terms(ppx, rpx, base, 2 * R + 1,
                                               subsample)
    volume = FOUR_THIRDS_PI * (rpx * rpx * rpx)  # pixel-unit sphere volume
    big_val = (w / volume)[:, None, None, None] * overlap * cover
    sub_val = w[:, None, None, None] * sub_mask
    is_sub = rpx < 0.5
    return base, torch.where(is_sub[:, None, None, None], sub_val, big_val)


def footprint_values_2d(ppx, w, rpx, ppu: float, halfwidth: int,
                        subsample: int):
    """Single-slice (2D) contributions, reproducing ``render_points``'s plane
    parameters plane_depth=0, lower/upper = -/+0.5 *units*
    (rasterization/src/cpp/point_renderer.cpp:606-657): big particles deposit
    overlap with a 1-pixel-thick slab centered at z=0 (fragment corner z=-0.5,
    triangle.frag:25), sub-pixel particles select on z in (-0.5, 0.5] units.

    Returns (base (C,2) int32, vals (C, F, F) float32).
    """
    R = halfwidth
    F = 2 * R + 1
    dev = ppx.device
    px, py, pz = ppx[:, 0], ppx[:, 1], ppx[:, 2]
    base = torch.floor(ppx[:, :2]).to(torch.int32) - R
    off = torch.arange(F, dtype=torch.int32, device=dev)
    vx = base[:, 0:1] + off[None, :]
    vy = base[:, 1:2] + off[None, :]
    vxf, vyf = vx.float(), vy.float()

    zoff = pz  # plane depth 0
    zclip = zoff.abs() <= rpx + 1.0
    plane_r = torch.sqrt(torch.clamp_min(rpx * rpx - zoff * zoff, 0.0))
    half = torch.ceil(plane_r) + 1.0  # (C,)
    cx = vxf + 0.5 - px[:, None]
    cy = vyf + 0.5 - py[:, None]
    cov_x = (cx >= -half[:, None]) & (cx < half[:, None])
    cov_y = (cy >= -half[:, None]) & (cy < half[:, None])
    cover = cov_x[:, :, None] & cov_y[:, None, :] & zclip[:, None, None]

    u = _subcell_centers(subsample, dev)
    ax = px[:, None, None] - vxf[:, :, None] - u  # (C, F, S)
    ay = py[:, None, None] - vyf[:, :, None] - u
    az = (pz + 0.5)[:, None] - u  # (C, S): fragment z corner at -0.5 px
    ax, ay, az = ax * ax, ay * ay, az * az
    r2 = rpx * rpx
    # loop over (x, z) sub-cells, vectorize y over (F, S), with the shared
    # association az < r2 - (ax + ay)
    count = torch.zeros(cover.shape, dtype=torch.int32, device=dev)
    for a in range(subsample):
        rab = r2[:, None, None, None] - (
            ax[:, :, a][:, :, None, None] + ay[:, None, :, :]
        )
        for c in range(subsample):
            inside = az[:, c][:, None, None, None] < rab
            count += inside.sum(-1, dtype=torch.int32)
    overlap = _subcell_fraction(count, subsample)

    volume = FOUR_THIRDS_PI * (rpx * rpx * rpx)
    big_val = (w / volume)[:, None, None] * overlap * cover

    is_sub = rpx < 0.5
    zu = pz * (1.0 / ppu)
    zsel = (zu > -0.5) & (zu <= 0.5)
    sub_mask = (
        (vx == torch.floor(px).to(torch.int32)[:, None])[:, :, None]
        & (vy == torch.floor(py).to(torch.int32)[:, None])[:, None, :]
    )
    sub_val = (w * zsel)[:, None, None] * sub_mask
    return base, torch.where(is_sub[:, None, None], sub_val, big_val)


def _scaled(positions, weights, radii, pixels_per_unit):
    positions = as_f32(positions)
    dev = positions.device
    return (positions * pixels_per_unit, as_f32(weights, dev),
            as_f32(radii, dev) * pixels_per_unit)


def splat_volume_oracle(positions, weights, radii, pixels_per_unit: float,
                        grid, subsample: int = 4, chunk: int = 256,
                        wrap=(False, False, False)) -> torch.Tensor:
    """Render a 3D density field (particles pre-augmented for periodicity, or
    ``wrap`` set for modulo wrapping). Returns a (gx, gy, gz) float32 tensor
    on the positions' device; chunks of ``chunk`` particles are accumulated
    with ``index_add_``."""
    gx, gy, gz = (int(v) for v in grid)
    ppx, w, rpx = _scaled(positions, weights, radii, pixels_per_unit)
    dev = ppx.device
    n = ppx.shape[0]
    out = torch.zeros(gx * gy * gz, dtype=torch.float32, device=dev)
    if n == 0:
        return out.view(gx, gy, gz)
    R = required_halfwidth(float(rpx.max()))
    off = torch.arange(2 * R + 1, dtype=torch.int64, device=dev)

    def axis_idx(v, g, do_wrap):
        if do_wrap:
            return torch.remainder(v, g), torch.ones_like(v, dtype=torch.bool)
        return v.clamp(0, g - 1), (v >= 0) & (v < g)

    for s in range(0, n, chunk):
        base, vals = footprint_values(ppx[s:s + chunk], w[s:s + chunk],
                                      rpx[s:s + chunk], R, subsample)
        base = base.long()
        ix, okx = axis_idx(base[:, 0:1] + off, gx, wrap[0])
        iy, oky = axis_idx(base[:, 1:2] + off, gy, wrap[1])
        iz, okz = axis_idx(base[:, 2:3] + off, gz, wrap[2])
        ok = okx[:, :, None, None] & oky[:, None, :, None] & okz[:, None, None, :]
        flat = ((ix[:, :, None, None] * gy + iy[:, None, :, None]) * gz
                + iz[:, None, None, :])
        vals = torch.where(ok, vals, 0.0)
        out.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out.view(gx, gy, gz)


def splat_2d_oracle(positions, weights, radii, pixels_per_unit: float, grid,
                    subsample: int = 4, chunk: int = 256) -> torch.Tensor:
    """Render a single 2D slice. Returns a (gx, gy) float32 tensor."""
    gx, gy = (int(v) for v in grid)
    ppx, w, rpx = _scaled(positions, weights, radii, pixels_per_unit)
    dev = ppx.device
    n = ppx.shape[0]
    out = torch.zeros(gx * gy, dtype=torch.float32, device=dev)
    if n == 0:
        return out.view(gx, gy)
    R = required_halfwidth(float(rpx.max()))
    off = torch.arange(2 * R + 1, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        base, vals = footprint_values_2d(
            ppx[s:s + chunk], w[s:s + chunk], rpx[s:s + chunk],
            float(pixels_per_unit), R, subsample,
        )
        base = base.long()
        vx = base[:, 0:1] + off
        vy = base[:, 1:2] + off
        ok = ((vx >= 0) & (vx < gx))[:, :, None] & ((vy >= 0) & (vy < gy))[:, None, :]
        flat = vx.clamp(0, gx - 1)[:, :, None] * gy + vy.clamp(0, gy - 1)[:, None, :]
        vals = torch.where(ok, vals, 0.0)
        out.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out.view(gx, gy)
