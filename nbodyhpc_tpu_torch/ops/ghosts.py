"""Periodic ghost-particle augmentation.

PyTorch port of :func:`nbodyhpc_tpu.ops.ghosts.augment_points_periodic`, the
functional mirror of the reference's vertex pre-processing (reference:
rasterization/src/cpp/vertex_utilities.cpp:13-43). It runs on whatever device
the tensors live on, so a render on the GPU never sends its particles back to
the host. The clone counts are data-dependent: each face mask costs one
device sync.
"""
from __future__ import annotations

import torch

from .splat import as_f32


def augment_points_periodic(positions, weights, radii, box_size):
    """Clone boundary-crossing particles across periodic faces.

    ``box_size`` is a 3-sequence; entries <= 0 disable periodicity for that
    dimension. Dimensions are processed in order, so clones of clones are
    made (a corner-crossing particle spawns up to 7 clones, more if a
    diameter exceeds the box). Within a dimension the hi-face clones come
    first, then the lo-face clones, each in ascending source index.

    Returns (positions, weights, radii) float32 tensors with the clones
    appended.
    """
    positions = as_f32(positions)
    dev = positions.device
    weights = as_f32(weights, dev)
    radii = as_f32(radii, dev)
    for dim in range(3):
        L = float(box_size[dim])
        if L <= 0:
            continue
        x = positions[:, dim]
        hi = x + radii > L
        lo = x - radii < 0.0
        ps, ws, rs = [positions], [weights], [radii]
        for mask, shift in ((hi, -L), (lo, +L)):
            p = positions[mask]
            p[:, dim] += shift
            ps.append(p)
            ws.append(weights[mask])
            rs.append(radii[mask])
        positions = torch.cat(ps)
        weights = torch.cat(ws)
        radii = torch.cat(rs)
    return positions, weights, radii
