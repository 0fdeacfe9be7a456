"""Step kind ``render_volume``: one ``rasterizer.render_points_volume`` call,
numpy arrays in and the numpy F-order field out, as the upstream API
returns it.

Traffic keys: ``grid`` (voxels per axis), ``periodic``, ``subsample``.
Configuration keys: ``box``, ``particles`` (read by the generator), and the
radius recipe ``radius_sigma``, ``radius_floor_px``: radii
``exp(sigma N(0, 1))`` times the mean spacing ``grid / n^(1/3)`` pixels,
floored, unit weights.

Check: every step keeps the field on the same tiles of 16^3 voxels per
input set, drawn from the seed: uniform corners, corners on randomly drawn
particles (so dense regions weigh by their mass), the largest particles,
the box's two far corners, where periodic images land, and a scattered
diagonal of ``grid / 16`` tiles whose x, y and z ranges each cover every
voxel index once, so a fault confined to a slab of the field, along any
axis and however thin, lands in a kept tile (102 tiles at 1024^3). The
whole field is not compared: the reference takes about 45 ms a tile on
the card, 3.3 hours for the 262,144 tiles of 1024^3. After the window each
kept tile is held to the plain reference (``reference/splat.py``).
``field_err`` is the largest absolute gap over all kept voxels divided by
the mean reference voxel.
"""
from __future__ import annotations

import numpy as np
import torch

from nbodyhpc_tpu_torch.rasterizer import render_points_volume
from portbench.harness import step_seed
from portbench.reference import splat as ref

TILE = 16
UNIFORM_TILES, MASS_TILES, LARGEST_TILES = 16, 16, 4


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


class Step:
    unit = "particles"

    def __init__(self, config, traffic, generator, seed, device):
        self.render = render_points_volume
        self.device = device
        self.grid = int(traffic["grid"])
        self.S = int(traffic["subsample"])
        self.periodic = bool(traffic["periodic"])
        self.box = float(config["box"])
        self.ppu = self.grid / self.box
        self.T = min(TILE, self.grid)
        self.sets = [self._make(config, generator, step_seed(seed, s))
                     for s in range(2)]
        self.kept = []

    def _make(self, config, generator, seed):
        dev = self.device
        pos = generator.make(config, "particles", seed, dev)
        n = pos.shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(seed, 1))
        spacing_px = self.grid / n ** (1.0 / 3.0)
        rpx = torch.clamp_min(
            torch.exp(config["radius_sigma"]
                      * torch.randn(n, generator=gen, device=dev))
            * spacing_px, config["radius_floor_px"])
        r = rpx / self.ppu
        corners = self._corners(pos, rpx, seed)
        host = tuple(t.cpu().numpy() for t in (pos, torch.ones_like(r), r))
        return host, corners

    def _corners(self, pos, rpx, seed):
        g, T = self.grid, self.T
        rng = np.random.Generator(np.random.Philox(step_seed(seed, 2)))
        px = torch.floor(pos * self.ppu).long().cpu().numpy()
        picks = [rng.integers(0, g - T + 1, 3)
                 for _ in range(UNIFORM_TILES)]
        for j in rng.integers(0, pos.shape[0], MASS_TILES):
            picks.append(px[j] - T // 2)
        for j in torch.topk(rpx, min(LARGEST_TILES, rpx.numel())).indices:
            picks.append(px[int(j)] - T // 2)
        picks += [np.zeros(3, np.int64), np.full(3, g - T)]
        slabs = np.arange(g // T) * T
        picks += list(np.stack([slabs, rng.permutation(slabs),
                                rng.permutation(slabs)], 1))
        return [tuple(int(v) for v in np.clip(c, 0, g - T)) for c in picks]

    def params(self) -> dict:
        return {"particles": int(self.sets[0][0][0].shape[0]),
                "voxels": self.grid ** 3}

    def run(self, i: int) -> int:
        (pos, w, r), corners = self.sets[i % 2]
        with torch.profiler.record_function("portbench.render"):
            field = self.render(pos, w, r, self.ppu, (self.grid,) * 3,
                                periodic=self.periodic,
                                subsample_factor=self.S)
        T = self.T
        self.kept.append((i % 2, [
            torch.from_numpy(np.array(field[x:x + T, y:y + T, z:z + T]))
            for x, y, z in corners]))
        return pos.shape[0]

    def warm(self) -> None:
        for i in range(2):
            self.run(i)
        self.kept.clear()

    def counters(self) -> dict:
        return {}

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
        refs = {s: [t.double().cpu() for t in self.reference(s)]
                for s in {s for s, _ in kept}}
        errs = []
        for s, tiles in kept:
            want = torch.stack(refs[s])
            got = torch.stack(tiles).double()
            e = float((got - want).abs().max() / want.abs().mean())
            errs.append(e if e == e else float("inf"))
        err = max(errs) if errs else float("inf")
        failed = sum(not (e <= limits["field_err"]) for e in errs)
        return [("field_err", err, limits["field_err"])], failed
