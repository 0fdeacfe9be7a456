"""The plain references agree with the port at tiny sizes on the CPU, and
each metric reader reads a hand-made trace as it should."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch import rasterizer
from nbodyhpc_tpu_torch.kdtree import KDTree
from portbench import harness, trace
from portbench.reference import knn as ref_knn
from portbench.reference import splat as ref_splat


def _particles(n, seed, box):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=g) * box
    w = 0.5 + torch.rand(n, generator=g)
    rpx = torch.exp(0.8 * torch.randn(n, generator=g)) * 2.0
    rpx[: n // 10] = 0.3 * torch.rand(n // 10, generator=g)   # sub-pixel
    rpx[-3:] = torch.tensor([16.0, 17.5, 21.0])                # dense tail
    return pos, w, rpx


@pytest.mark.parametrize("engine", ["oracle", "cuda"])
@pytest.mark.parametrize("periodic", [True, False])
def test_render_tiles_match_the_port(engine, periodic):
    grid, box, T = 24, 3.0, 8
    ppu = grid / box
    pos, w, rpx = _particles(600, 5, box)
    r = rpx / ppu
    renderer = rasterizer.PointRenderer(
        rasterizer.Container(device="cpu"), grid, grid, 4, engine=engine)
    L = (box,) * 3 if periodic else (-1.0,) * 3
    field = renderer.render_points_volume(pos.numpy(), w.numpy(), r.numpy(),
                                          grid, ppu, L)
    corners = [(x, y, z) for x in range(0, grid, T) for y in range(0, grid, T)
               for z in range(0, grid, T)]
    tiles = ref_splat.render_tiles(pos, w, r, ppu, grid, L, 4, corners, T)
    for (x, y, z), t in zip(corners, tiles):
        got = torch.from_numpy(np.array(field[x:x + T, y:y + T, z:z + T]))
        torch.testing.assert_close(got, t, rtol=2e-5, atol=1e-6)
    assert float(sum(t.sum() for t in tiles)) > 0


@pytest.mark.parametrize("clustered", [False, True])
def test_knn_matches_the_port(clustered):
    g = torch.Generator().manual_seed(3)
    n, box = 20000, 2.0
    pts = torch.rand((n, 3), generator=g) * box
    if clustered:  # half the points in a small blob, leaving voids
        pts[: n // 2] = (0.5 + 0.05 * torch.randn((n // 2, 3), generator=g)) % box
    q = torch.rand((9000, 3), generator=g) * box
    d, i = KDTree(pts, boxsize=box).query_device(q, k=16, engine="kernel")
    d_ref, i_ref = ref_knn.knn(pts, q, 16, box)
    from portbench.steps import knn_query_device as kq

    dist_err, index_err = kq.rank_errors(d, i, d_ref, pts, q, box)
    assert dist_err < 1e-5 and index_err < 1e-5
    assert (i_ref >= 0).all()


def _records():
    """Two render spans of 1 s in a 3 s window: kernels 0.2 s and a
    0.5 s copy to the host in each."""
    s = 10 ** 9
    rec = trace.Records(params={"particles": 10, "voxels": 100})
    rec.window = (0, 3 * s)
    rec.spans = {"render": [(0, s), (2 * s, 3 * s)]}
    for t in (0, 2 * s):
        rec.device += [("deposit_kernel", "kernel", t + s // 10, t + 3 * s // 10),
                       ("Memcpy DtoH (Device -> Pageable)", "copy_d2h",
                        t + s // 2, t + s)]
    rec.device.sort(key=lambda e: e[2])
    rec.host = [(0, s, "aten::copy_"), (s, 2 * s, "aten::sort"),
                (2 * s, 3 * s, "aten::copy_")]
    return rec


def test_readers_on_a_hand_made_trace():
    rec = _records()
    read = {m: harness.load_module(harness.HERE / "metrics" / f"{m}.py").read
            for m in ("render.to_host_ms", "render.kernel_roofline",
                      "device_idle.render", "device_idle.knn")}
    assert read["render.to_host_ms"](rec) == pytest.approx(500.0)
    least = (20 * 10 + 4 * 100) / 3.35e12 * 1e3
    assert read["render.kernel_roofline"](rec) == pytest.approx(
        100 * least / 200.0)
    assert rec.busy_s() == pytest.approx(1.4)
    assert read["device_idle.render"](rec) == pytest.approx(
        100 * (1 - 1.4 / 3))
    assert read["device_idle.knn"](rec) is None
    b = trace.breakdown(rec)
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", 1.0]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(1.1)    # 1.0 s to 2.1 s
    assert gaps["aten::copy_"] == pytest.approx(0.5)   # the spans' gaps
