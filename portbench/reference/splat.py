"""Plain reference of the sphere-splat volume render, on tiles of the field.

The upstream renderer's semantics (wendazhou/nbodyhpc
rasterization/shaders/triangle.vert:26-70 and triangle.frag:14-46, its
per-slice volume loop point_renderer.cpp:825-950, its periodic images
vertex_utilities.cpp:13-43), in pixel units ``p = x * ppu``,
``rp = r * ppu``:

- ``rp < 0.5``: the whole weight goes into the voxel holding the particle,
  z tie-broken to the lower slice (``z in (k, k + 1]``);
- otherwise a voxel gets ``w / (4/3 pi rp^3)`` times the fraction of its
  S^3 sub-cell centres inside the sphere, where its centre lies in the
  slice's covering square (half side ``ceil(sqrt(rp^2 - dz^2)) + 1``,
  ``dz`` from the slice centre) and ``|dz| <= rp + 1``;
- with a periodic box, a particle with ``x + r > L`` on an axis is cloned
  at ``x - L`` and one with ``x - r < 0`` at ``x + L``, axis after axis.

Everything is computed in ``dtype`` (float32 for the reference, a lower
precision for the control), one particle footprint of its own size at a
time in batches, and only the voxels of the asked tiles are kept. Plain
torch only.
"""
from __future__ import annotations

import math

import torch

FOUR_THIRDS_PI = 4.0 / 3.0 * math.pi
ELEMS = 1 << 24  # sub-cell compares held at once


def periodic_images(pos, w, r, box):
    """The particles and their periodic clones (``box`` per axis, <= 0:
    open)."""
    for d in range(3):
        L = float(box[d])
        if L <= 0:
            continue
        x = pos[:, d]
        hi, lo = x + r > L, x - r < 0.0
        ps, ws, rs = [pos], [w], [r]
        for mask, shift in ((hi, -L), (lo, L)):
            p = pos[mask]
            p[:, d] += shift
            ps.append(p)
            ws.append(w[mask])
            rs.append(r[mask])
        pos, w, r = torch.cat(ps), torch.cat(ws), torch.cat(rs)
    return pos, w, r


def footprint(p, w, rp, R: int, S: int):
    """(base [C, 3], values [C, F, F, F]) of particles of half-width ``R``
    on their (2R + 1)^3 windows based at ``floor(p) - R``."""
    F = 2 * R + 1
    dt, dev = p.dtype, p.device
    base = torch.floor(p).long() - R
    off = torch.arange(F, device=dev)
    v = [(base[:, a:a + 1] + off).to(dt) for a in range(3)]     # [C, F]
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    dz = pz - (v[2] + 0.5)
    zcull = dz.abs() <= rp[:, None] + 1.0
    half = torch.ceil(torch.sqrt(torch.clamp_min(
        rp[:, None] * rp[:, None] - dz * dz, 0.0))) + 1.0      # [C, Fz]
    cx, cy = v[0] + 0.5 - px, v[1] + 0.5 - py
    inx = (cx[:, :, None] >= -half[:, None, :]) & (cx[:, :, None] < half[:, None, :])
    iny = (cy[:, :, None] >= -half[:, None, :]) & (cy[:, :, None] < half[:, None, :])
    cover = inx[:, :, None, :] & iny[:, None, :, :] & zcull[:, None, None, :]
    u = ((torch.arange(S, dtype=torch.float32) + 0.5) / S).to(dev, dt)
    ax = (px[:, :, None] - v[0][:, :, None] - u) ** 2             # [C, F, S]
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
    big = (w / (FOUR_THIRDS_PI * (rp * rp * rp)))[:, None, None, None] \
        * frac * cover
    fl = torch.floor(p).long()
    sub = ((base[:, 0:1] + off == fl[:, 0:1])[:, :, None, None]
           & (base[:, 1:2] + off == fl[:, 1:2])[:, None, :, None]
           & ((pz > v[2]) & (pz <= v[2] + 1.0))[:, None, None, :])
    vals = torch.where((rp < 0.5)[:, None, None, None],
                       w[:, None, None, None] * sub, big)
    return base, vals


def render_tiles(pos, w, r, ppu: float, grid: int, box, subsample: int,
                 corners, T: int, dtype=torch.float32):
    """The field on the T^3 tiles at ``corners`` (voxel (i, j, k) holds
    x in [i, i + 1) / ppu), as a list of [T, T, T] tensors in ``dtype``."""
    pos, w, r = (torch.as_tensor(t).to(dtype) for t in (pos, w, r))
    pos, w, r = periodic_images(pos, w, r, box)
    p, rp = pos * ppu, r * ppu
    R = torch.ceil(rp).long() + 3
    fl = torch.floor(p).long()
    lo, hi = fl - R[:, None], fl + R[:, None]
    dev = p.device
    out = []
    for c in corners:
        c0 = torch.as_tensor(c, device=dev)
        sel = torch.nonzero(((hi >= c0) & (lo < c0 + T)).all(1)).squeeze(1)
        tile = torch.zeros(T ** 3, dtype=dtype, device=dev)
        Rs = R[sel]
        for Rv in torch.unique(Rs).tolist():
            ids = sel[Rs == Rv]
            F = 2 * Rv + 1
            chunk = max(1, ELEMS // (F ** 3 * subsample))
            for s in range(0, ids.numel(), chunk):
                j = ids[s:s + chunk]
                base, vals = footprint(p[j], w[j], rp[j], Rv, subsample)
                off = torch.arange(F, device=dev)
                t = [base[:, a:a + 1] + off - c0[a] for a in range(3)]
                g = [base[:, a:a + 1] + off for a in range(3)]
                ok = [(t[a] >= 0) & (t[a] < T) & (g[a] >= 0) & (g[a] < grid)
                      for a in range(3)]
                keep = (ok[0][:, :, None, None] & ok[1][:, None, :, None]
                        & ok[2][:, None, None, :])
                flat = ((t[0].clamp(0, T - 1)[:, :, None, None] * T
                         + t[1].clamp(0, T - 1)[:, None, :, None]) * T
                        + t[2].clamp(0, T - 1)[:, None, None, :])
                tile.index_add_(0, flat[keep], vals[keep])
        out.append(tile.view(T, T, T))
    return out
