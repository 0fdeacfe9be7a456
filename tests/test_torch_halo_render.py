"""The benchmark's halo snapshot (``portbench/inputs/halo_model.py``) and the
render of it through the port, on the CPU at small lattices.

- The generator repeats for a seed, and is clustered on the port's own
  cell grid.
- Its analytic smoothing lengths track an exact k = 32 k-NN (the
  benchmark's float64 reference).
- ``render_points_volume`` through the tile engine's plain versions, dense
  pass included, agrees with both plain tile references, which agree with
  each other.
- The wrappers' subsample limit is the kernels' own, and
  ``render.dense_voxels`` counts the dense rows' spheres.

Torch and numpy only.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch import rasterizer
from nbodyhpc_tpu_torch.core.cells import build_cell_list
from nbodyhpc_tpu_torch.ops import splat, splat_cuda as sc
from nbodyhpc_tpu_torch.ops import splat_dense as sd
from nbodyhpc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import knn as ref_knn  # noqa: E402
from portbench.reference import splat as ref_splat  # noqa: E402
from portbench.reference import splat_tiles as ref_tiles  # noqa: E402

HM = harness.load_module(harness.HERE / "inputs" / "halo_model.py")
BOX = 25.0


def _config(lattice: int, n_max: int, mesh: int) -> dict:
    """The deployment's file at a small lattice: the largest halo capped to
    fit, the background mesh a quarter of the lattice as at 256^3."""
    cfg = harness.read_json(ROOT / "portbench/configs/camels-halos.json")
    cfg.update(particles=lattice ** 3, halo_n_max=n_max, background_mesh=mesh)
    return cfg


@pytest.fixture(scope="module")
def snap32():
    return HM.snapshot(_config(32, 4096, 8), 2 ** 31 + 7, "cpu")


def test_generator_repeats_for_a_seed(snap32):
    cfg = _config(32, 4096, 8)
    again = HM.snapshot(cfg, 2 ** 31 + 7, "cpu")
    other = HM.snapshot(cfg, 2 ** 31 + 8, "cpu")
    assert snap32.pos.shape == (32 ** 3, 3) and snap32.hsml.shape == (32 ** 3,)
    for a, b in zip(snap32, again):
        assert torch.equal(a, b)
    assert not torch.equal(snap32.pos, other.pos)
    assert float(snap32.pos.min()) >= 0 and float(snap32.pos.max()) < BOX
    assert int(snap32.sizes.sum()) == 32 ** 3 // 2
    assert int(snap32.sizes.max()) <= 4096 and int(snap32.sizes.min()) >= 1
    assert torch.equal(HM.make(cfg, "particles", 2 ** 31 + 7, "cpu"),
                       snap32.pos)


def test_generator_is_clustered(snap32):
    """The fullest cell of the port's grid (occupancy 8) holds at least
    20 times the mean."""
    cells = build_cell_list(snap32.pos, boxsize=BOX, occupancy=8)
    mean = snap32.pos.shape[0] / cells.ncells
    assert cells.max_cell_count >= 20 * mean, (cells.max_cell_count, mean)


def test_smoothing_lengths_track_an_exact_knn(snap32):
    """The analytic h against the distance to the 32nd neighbour (self
    included, as a k = 32 self-query gives it), float64, on a sample."""
    g = torch.Generator().manual_seed(1)
    idx = torch.randperm(snap32.pos.shape[0], generator=g)[:2000]
    pts = snap32.pos.double()
    d, _ = ref_knn.knn(pts, pts[idx], 32, BOX)
    ratio = (snap32.hsml[idx].double() / d[:, 31]).numpy()
    assert 0.8 <= float(np.median(ratio)) <= 1.25
    assert float(((ratio >= 0.5) & (ratio <= 2.0)).mean()) >= 0.9


def test_render_of_a_halo_snapshot_matches_both_references():
    """An 8^3 snapshot into 48^3: 75 rows above 15 px take the dense pass.
    The port's field on tiles at the largest radius, the largest halo and
    two corners against ``reference/splat.py`` and
    ``reference/splat_tiles.py``; the two references agree to float32
    sums in another order."""
    snap = HM.snapshot(_config(8, 128, 2), 123, "cpu")
    g, T = 48, 16
    ppu = g / BOX
    rpx = snap.hsml * ppu
    assert int((rpx > 15).sum()) > 10
    w = torch.ones_like(snap.hsml)
    pr = rasterizer.PointRenderer(rasterizer.Container(device="cpu"), g, g,
                                  4, engine="cuda")
    field = pr.render_points_volume(snap.pos.numpy(), w.numpy(),
                                    snap.hsml.numpy(), g, ppu, (BOX,) * 3)

    def corner(p):
        return tuple(int(v) for v in np.clip(
            np.floor(p.numpy() * ppu) - T // 2, 0, g - T))

    corners = [corner(snap.pos[int(torch.argmax(rpx))]),
               corner(snap.centres[0]), (0, 0, 0), (g - T,) * 3]
    args = (snap.pos, w, snap.hsml, ppu, g, (BOX,) * 3, 4, corners, T)
    old = ref_splat.render_tiles(*args)
    new = ref_tiles.render_tiles(*args)
    for (x, y, z), a, b in zip(corners, old, new):
        torch.testing.assert_close(b, a, rtol=2e-6, atol=1e-7)
        got = torch.from_numpy(np.array(field[x:x + T, y:y + T, z:z + T]))
        torch.testing.assert_close(got, b, rtol=2e-5, atol=1e-6)
    assert float(new[1].max()) > 100 * float(new[2].mean()) > 0


def test_max_subsample_matches_the_kernels():
    """The wrappers' subsample check is the kernels' own limit."""
    src = (ROOT / "nbodyhpc_tpu_torch/csrc/splat_common.h").read_text()
    m = re.search(r"constexpr int kMaxS = (\d+);", src)
    assert int(m.group(1)) == splat.MAX_SUBSAMPLE
    assert sc.MAX_SUBSAMPLE == sd.MAX_SUBSAMPLE == splat.MAX_SUBSAMPLE


def test_dense_voxels_counts_the_dense_spheres():
    """``render.dense_voxels`` adds, per render, the sum over the dense rows
    of ceil(4/3 pi rp^3), from the partition's one read."""
    rng = np.random.default_rng(9)
    g, n = 40, 3000
    pos = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    rpx = torch.from_numpy(rng.uniform(0.2, 12.0, n).astype(np.float32))
    rpx[:12] = torch.from_numpy(rng.uniform(15.5, 24.0, 12).astype(np.float32))
    part = sc.prepartition(pos, torch.ones(n), rpx / g, float(g), (g,) * 3)
    rp = (rpx / g) * np.float32(g)
    dense = rp[rp > 15.0]
    want = int(torch.ceil(sc.FOUR_THIRDS_PI * (dense * dense * dense)).sum())
    assert part.n_huge == 12 and part.dense_voxels == want
    assert part.max_rpx == float(rp.max())
    before = profiling.counters().get("render.dense_voxels", 0)
    sc.splat_volume(part, None, None, float(g), (g,) * 3)
    assert profiling.counters()["render.dense_voxels"] - before == want
