"""Step kind ``render_volume_hsml``: the ``render_volume`` call, with each
particle splatted at the smoothing length its generator gives.

One ``rasterizer.render_points_volume`` call a step, numpy arrays in and
the numpy F-order field out, unit weights. The generator is one with
``snapshot(config, seed, device)`` (``inputs/halo_model.py``): positions,
radii in box units, and the halo centres, largest halo first.

Traffic keys: ``grid`` (voxels per axis), ``periodic``, ``subsample``.

Check: ``render_volume``'s tiles of 16^3 voxels (uniform, on particles
drawn by mass, on the largest radii, the far corners, the slab-covering
diagonal) and one on each of the ``HALO_TILES`` most massive halos'
centres, held after the window to ``reference/splat_tiles.py``, which
evaluates each particle only on a tile's voxels and so stays fast at 30 px
radii. ``field_err`` is the largest relative gap over the kept voxels,
``|got - want| / (|want| + FLOOR * mean |want|)``: halo cores hold ~1e6
times the mean voxel, so ``render_volume``'s gap over the mean voxel would
read the cores' float32 rounding, larger than a 1% fault in a void.

``counters()``: each step's ``render.dense_rows`` and
``render.dense_voxels`` from the program's counters (absent in a program
that lacks them).

``warm()`` ends the process (exit 1, a message on stderr) when its two
renders have not returned within ``WARM_LIMIT_S``: a program that takes
that long a render cannot fill a window with steps, and a render that
evaluates each dense row on one window sized by the batch's largest
radius takes minutes here.
"""
from __future__ import annotations

import os
import sys
import threading

import numpy as np
import torch

from nbodyhpc_tpu_torch.rasterizer import render_points_volume
from nbodyhpc_tpu_torch.utils import profiling
from portbench.reference import splat_tiles as ref
from portbench.steps import render_volume as base

HALO_TILES = 4
FLOOR = 1e-3  # of the mean reference voxel, under the relative gap
COUNTERS = ("render.dense_rows", "render.dense_voxels")
# the two warm renders, the kernels' build included, take 8-15 s on an
# H100; a program's first failure here should come well inside a run's time
WARM_LIMIT_S = 45.0


def plant_fault(kind: str) -> None:
    """Break the render this step kind drives (``harness.FAULTS``), in this
    loaded copy of the module only: ``altered``, one x-slab of the field
    1% off; ``half``, half of the particles left out."""
    global render_points_volume
    real = render_points_volume

    def render(pos, w, r, *a, **kw):
        if kind == "half":
            n = pos.shape[0] // 2
            return real(pos[:n], w[:n], r[:n], *a, **kw)
        field = real(pos, w, r, *a, **kw)
        field[field.shape[0] // 2] *= 1.01
        return field

    render_points_volume = render


def _too_slow() -> None:
    print(f"render_volume_hsml: the warm renders took over {WARM_LIMIT_S} "
          "s; the window could not hold its steps", file=sys.stderr,
          flush=True)
    os._exit(1)


class Step(base.Step):

    def __init__(self, config, traffic, generator, seed, device):
        super().__init__(config, traffic, generator, seed, device)
        self.render = render_points_volume
        self.last = {}

    def _make(self, config, generator, seed):
        snap = generator.snapshot(config, seed, self.device)
        pos, r = snap.pos, snap.hsml
        rpx = r * self.ppu
        corners = self._corners(pos, rpx, seed)
        T, g = self.T, self.grid
        for c in snap.centres[:HALO_TILES]:
            px = torch.floor(c * self.ppu).long().cpu().numpy() - T // 2
            corners.append(tuple(int(v) for v in np.clip(px, 0, g - T)))
        host = tuple(t.cpu().numpy() for t in (pos, torch.ones_like(r), r))
        return host, corners

    def warm(self) -> None:
        timer = threading.Timer(WARM_LIMIT_S, _too_slow)
        timer.daemon = True
        timer.start()
        try:
            super().warm()
        finally:
            timer.cancel()

    def run(self, i: int) -> int:
        before = profiling.counters()
        n = super().run(i)
        after = profiling.counters()
        self.last = {k: after[k] - before.get(k, 0) for k in COUNTERS
                     if k in after}
        return n

    def counters(self) -> dict:
        return dict(self.last)

    def reference(self, s: int, dtype=torch.float32):
        (pos, w, r), corners = self.sets[s]
        dev = self.device
        box = (self.box,) * 3 if self.periodic else (-1.0,) * 3
        return ref.render_tiles(
            torch.from_numpy(pos).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(r).to(dev), self.ppu, self.grid, box, self.S,
            corners, self.T, dtype)

    def check(self, limits, control=None):
        """([(name, value, limit)], steps failed). ``control``: a dtype in
        which the reference stands in for the program."""
        kept = self.kept
        if control is not None:
            kept = [(s, [t.float().cpu() for t in self.reference(s, control)])
                    for s in range(2)]
        refs = {s: torch.stack([t.double().cpu() for t in self.reference(s)])
                for s in {s for s, _ in kept}}
        errs = []
        for s, tiles in kept:
            want = refs[s]
            got = torch.stack(tiles).double()
            floor = FLOOR * want.abs().mean()
            e = float(((got - want).abs() / (want.abs() + floor)).max())
            errs.append(e if e == e else float("inf"))
        err = max(errs) if errs else float("inf")
        failed = sum(not (e <= limits["field_err"]) for e in errs)
        return [("field_err", err, limits["field_err"])], failed
