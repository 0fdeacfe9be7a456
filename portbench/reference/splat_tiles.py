"""Plain reference of the sphere-splat volume render on tiles of the field,
fast where radii are large.

The semantics are ``reference/splat.py``'s (the upstream renderer's, in
pixel units ``p = x * ppu``, ``rp = r * ppu``): a sub-pixel particle puts
its weight in the voxel holding it, z tie-broken to the lower slice; any
other gives a voxel ``w / (4/3 pi rp^3)`` times the fraction of its S^3
sub-cell centres inside the sphere, where its centre lies in the slice's
covering square (half side ``ceil(sqrt(rp^2 - dz^2)) + 1``) and
``|dz| <= rp + 1``; periodic clones as there.

What differs is where each particle is evaluated. ``reference/splat.py``
evaluates every particle that meets a tile on its whole (2R + 1)^3 window
(R = ceil(rp) + 3), ~3e5 voxels at 30 px. Here a particle is evaluated on
a window of ``W = min(2R + 1, T)`` voxels a side, its own window moved
inside the tile: every formula is in absolute voxel coordinates, so that
window covers the particle's footprint within the tile, and its voxels are
all the tile's. A sub-pixel particle is one index.

Everything is computed in ``dtype`` (float32 for the reference, a lower
precision for the control), in batches of one window size. Plain torch
only; TF32 is set off, though nothing here multiplies matrices.
"""
from __future__ import annotations

import torch

from portbench.reference.splat import FOUR_THIRDS_PI, periodic_images

ELEMS = 1 << 24  # sub-cell compares held at once


def box_values(p, w, rp, base, W: int, S: int):
    """[C, W, W, W] values of particles with ``rp >= 0.5`` on the W^3
    voxels at ``base`` (int64 [C, 3])."""
    dt, dev = p.dtype, p.device
    off = torch.arange(W, device=dev)
    v = [(base[:, a:a + 1] + off).to(dt) for a in range(3)]     # [C, W]
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    dz = pz - (v[2] + 0.5)
    zcull = dz.abs() <= rp[:, None] + 1.0
    half = torch.ceil(torch.sqrt(torch.clamp_min(
        rp[:, None] * rp[:, None] - dz * dz, 0.0))) + 1.0      # [C, Wz]
    cx, cy = v[0] + 0.5 - px, v[1] + 0.5 - py
    inx = (cx[:, :, None] >= -half[:, None, :]) & (cx[:, :, None] < half[:, None, :])
    iny = (cy[:, :, None] >= -half[:, None, :]) & (cy[:, :, None] < half[:, None, :])
    cover = inx[:, :, None, :] & iny[:, None, :, :] & zcull[:, None, None, :]
    u = ((torch.arange(S, dtype=torch.float32) + 0.5) / S).to(dev, dt)
    ax = (px[:, :, None] - v[0][:, :, None] - u) ** 2             # [C, W, S]
    ay = (py[:, :, None] - v[1][:, :, None] - u) ** 2
    az = (pz[:, :, None] - v[2][:, :, None] - u) ** 2
    r2 = (rp * rp)[:, None, None, None, None]
    count = torch.zeros(cover.shape, dtype=torch.int32, device=dev)
    for a in range(S):
        for b in range(S):
            m = (ax[:, :, a][:, :, None, None, None]
                 + ay[:, :, b][:, None, :, None, None])
            count += (az[:, None, None, :, :] < r2 - m).sum(
                -1, dtype=torch.int32)
    frac = count.to(dt) / torch.full((), float(S ** 3), dtype=dt, device=dev)
    return (w / (FOUR_THIRDS_PI * (rp * rp * rp)))[:, None, None, None] \
        * frac * cover


def render_tiles(pos, w, r, ppu: float, grid: int, box, subsample: int,
                 corners, T: int, dtype=torch.float32):
    """The field on the T^3 tiles at ``corners`` (each inside the grid;
    voxel (i, j, k) holds x in [i, i + 1) / ppu), as a list of [T, T, T]
    tensors in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pos, w, r = (torch.as_tensor(t).to(dtype) for t in (pos, w, r))
    pos, w, r = periodic_images(pos, w, r, box)
    p, rp = pos * ppu, r * ppu
    R = torch.ceil(rp).long() + 3
    fl = torch.floor(p).long()
    lo, hi = fl - R[:, None], fl + R[:, None]
    sub = rp < 0.5
    dev = p.device
    out = []
    for c in corners:
        c0 = torch.as_tensor(c, device=dev)
        meets = ((hi >= c0) & (lo < c0 + T)).all(1)
        tile = torch.zeros(T ** 3, dtype=dtype, device=dev)
        # sub-pixel particles: the voxel holding each, z in (vz, vz + 1]
        j = torch.nonzero(meets & sub).squeeze(1)
        v = torch.stack([fl[j, 0], fl[j, 1],
                         torch.ceil(p[j, 2]).long() - 1], 1) - c0
        pz, vz = p[j, 2], (v[:, 2] + c0[2]).to(dtype)
        ok = ((v >= 0) & (v < T)).all(1) & (pz > vz) & (pz <= vz + 1.0)
        tile.index_add_(0, ((v[:, 0] * T + v[:, 1]) * T + v[:, 2])[ok],
                        w[j][ok])
        # the others: each on its own window moved inside the tile
        sel = torch.nonzero(meets & ~sub).squeeze(1)
        Rs = R[sel]
        for Rv in torch.unique(Rs).tolist():
            ids = sel[Rs == Rv]
            W = min(2 * Rv + 1, T)
            base = torch.minimum(torch.maximum(fl[ids] - Rv, c0),
                                 c0 + (T - W))
            chunk = max(1, ELEMS // (W ** 3 * subsample))
            off = torch.arange(W, device=dev)
            for s in range(0, ids.numel(), chunk):
                j, b = ids[s:s + chunk], base[s:s + chunk]
                vals = box_values(p[j], w[j], rp[j], b, W, subsample)
                t = [b[:, a:a + 1] - c0[a] + off for a in range(3)]
                flat = ((t[0][:, :, None, None] * T
                         + t[1][:, None, :, None]) * T
                        + t[2][:, None, None, :])
                tile.index_add_(0, flat.reshape(-1), vals.reshape(-1))
        out.append(tile.view(T, T, T))
    return out
