"""Rasterizer validation/demo CLI, mirroring the reference ``rasterizer_main``.

Reference behavior (rasterization/src/cpp/main.cpp:53-84): render a single
analytic sphere and check mass conservation (total deposited weight ~= 1),
the lit-voxel fraction and the central voxel value, optionally dumping a PNG
slice. ``--device cuda`` renders through the tile engine's kernels, ``cpu``
through the oracle.

Usage: ``python -m nbodyhpc_tpu_torch.cli.rasterizer_demo [--grid 128]
[--device cuda]``
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def render_single_sphere(grid: int, subsample: int, png: str | None,
                         device: str | None):
    from ..rasterizer import Container, get_point_renderer

    renderer = get_point_renderer(grid, subsample, Container(device=device))
    ppu = float(grid)
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    radius = 0.25
    r = np.array([radius], np.float32)

    t0 = time.perf_counter()
    vol = renderer.render_points_volume(pos, w, r, grid, ppu)
    dt = time.perf_counter() - t0

    total = float(vol.sum())
    center = float(vol[grid // 2, grid // 2, grid // 2])
    density = 1.0 / (4.0 / 3.0 * math.pi * radius**3) / ppu**3
    lit = int(np.count_nonzero(vol))
    sphere_vox = 4.0 / 3.0 * math.pi * (radius * ppu) ** 3
    print(f"render: {dt:.3f} s  grid {grid}^3  subsample {subsample}  "
          f"device {renderer.container.device}")
    print(f"total weight: {total:.6f} (expect ~1)")
    print(f"center voxel: {center:.3e} (uniform density {density:.3e})")
    print(f"lit voxels: {lit} (sphere volume {sphere_vox:.0f})")
    ok = abs(total - 1.0) < 0.05
    if png:
        from ..utils.png import write_png_grayscale

        write_png_grayscale(png, np.log1p(vol[:, :, grid // 2]))
        print(f"wrote {png}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--subsample", type=int, default=4)
    ap.add_argument("--png", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda when present, else cpu)")
    args = ap.parse_args(argv)
    ok = render_single_sphere(args.grid, args.subsample, args.png,
                              args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
