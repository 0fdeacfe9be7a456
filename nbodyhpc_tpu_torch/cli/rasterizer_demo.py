"""Rasterizer validation/demo CLI, mirroring the reference ``rasterizer_main``.

Reference behavior (rasterization/src/cpp/main.cpp:53-159): render a single
analytic sphere and check mass conservation (total deposited weight ~= 1),
the lit-voxel fraction and the central voxel value, optionally dumping a PNG
slice — or render a packed ``Vertex{pos[3], weight, radius}`` binary file
and report the rendered/input mass ratio, whole or streamed in batches. It
renders on the card through the tile engine's kernels unless ``--device
cpu`` asks for the CPU (the oracle).

Usage: ``python -m nbodyhpc_tpu_torch.cli.rasterizer_demo [--file F]
[--stream ROWS] [--grid 128] [--device cuda]``
"""
from __future__ import annotations

import argparse
import contextlib
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


def stream_volume(renderer, path: str, num_slices: int, ppu: float,
                  batch_rows: int):
    """Render a particle file non-periodic in batches of ``batch_rows``
    records, summed on the renderer's device (deposition is linear) while
    the stream's reader thread loads the next batch, so files larger than
    host memory render. Returns (field: C-order (height, width,
    num_slices) tensor, None for an empty file; particles; input weight)."""
    from ..runtime import stream_particles

    vol, n, wsum = None, 0, 0.0
    with contextlib.closing(stream_particles(path, batch_rows)) as batches:
        for pos, w, r in batches:
            part = renderer._render_volume_device(pos, w, r, num_slices, ppu)
            vol = part if vol is None else vol.add_(part)
            del part  # the next batch's field is made without it
            n += len(w)
            wsum += float(w.sum())
    return vol, n, wsum


def render_points_from_file(path: str, grid: int, ppu: float, subsample: int,
                            periodic: bool, png: str | None,
                            stream_rows: int = 0, device: str | None = None):
    from ..rasterizer import Container, get_point_renderer

    renderer = get_point_renderer(grid, subsample, Container(device=device))
    if stream_rows:
        # periodic wrap needs whole-set ghosting, so it takes the bulk path
        if periodic:
            raise SystemExit("--stream does not support --periodic "
                             "(ghost augmentation needs the full set)")
        t0 = time.perf_counter()
        field, n, wsum = stream_volume(renderer, path, grid, ppu, stream_rows)
        if field is None:
            raise SystemExit(f"{path} contains no particles")
        vol = renderer._finish(field)  # the one copy to the host
        dt = time.perf_counter() - t0
        print(f"streamed {n} particles from {path} "
              f"(batches of {stream_rows})")
    else:
        from ..runtime import load_particles

        pos, w, r = load_particles(path)
        n, wsum = len(pos), float(w.sum())
        print(f"loaded {n} particles from {path}")
        period = (grid / ppu,) * 3 if periodic else (-1.0,) * 3
        t0 = time.perf_counter()
        vol = renderer.render_points_volume(pos, w, r, grid, ppu, period)
        dt = time.perf_counter() - t0
    ratio = float(vol.sum()) / wsum
    print(f"render: {dt:.3f} s ({n/dt/1e6:.2f} Mparticles/s)")
    print(f"mass conservation rendered/input: {ratio:.6f}")
    if png:
        from ..utils.png import write_png_grayscale

        write_png_grayscale(png, np.log1p(vol[:, :, vol.shape[2] // 2]))
        print(f"wrote {png}")
    return abs(ratio - 1.0) < 0.1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--file", type=str, default=None,
                    help="packed float32 (x,y,z,weight,radius) records")
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--pixels-per-unit", type=float, default=None)
    ap.add_argument("--subsample", type=int, default=4)
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--png", type=str, default=None)
    ap.add_argument("--stream", type=int, default=0, metavar="ROWS",
                    help="render --file in prefetched batches of ROWS "
                         "records (bounded host memory; non-periodic only)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; cpu for the CPU)")
    args = ap.parse_args(argv)

    ppu = args.pixels_per_unit if args.pixels_per_unit else float(args.grid)
    if args.file:
        ok = render_points_from_file(args.file, args.grid, ppu, args.subsample,
                                     args.periodic, args.png, args.stream,
                                     args.device)
    else:
        ok = render_single_sphere(args.grid, args.subsample, args.png,
                                  args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
