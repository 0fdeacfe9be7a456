"""The least bytes of the render's dense pass (radii above 15 px).

Each dense row is read once (position, weight and radius, 20 B) and each
voxel its sphere covers is written once (4 B). The covered voxels, the
union of the spheres, are not counted: they are bounded above by the
smaller of the rows' sphere voxels (the program's counter
``render.dense_voxels``, the sum of ceil(4/3 pi rp^3)) and the grid's
voxels, and that bound is what is used. So the bytes are an upper bound on
the least bytes, and a roofline share from them an upper bound on the
pass's true share.
"""
from __future__ import annotations


def dense_bytes(rows: float, sphere_voxels: float, grid_voxels: int) -> float:
    return 20 * rows + 4 * min(sphere_voxels, grid_voxels)
