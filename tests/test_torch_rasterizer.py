"""The rasterizer API of the PyTorch port against the JAX package (CPU).

The API cases of ``tests/test_splat.py`` run through both packages
(parametrized on ``api``), then the port's fields are held against the JAX
package's on the same seeded inputs, through the oracle (the CPU's engine)
and through the tile engine (``engine="cuda"``, plain versions on the CPU).
The port's entry points default to the card, so its cases here install a
CPU default container or name ``device="cpu"``.
"""
import math
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import nbodyhpc_tpu.rasterizer as jras
import nbodyhpc_tpu_torch.rasterizer as tras
from nbodyhpc_tpu.ops import ghosts as jghosts
from nbodyhpc_tpu_torch.ops import ghosts as tghosts
from test_splat_dense import _quantum_atol

RTOL, ATOL = 1e-6, 1e-7
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cpu_default(monkeypatch):
    """The port's default container on the CPU for one test: its entry
    points run on the card unless asked otherwise."""
    cpu = tras.Container(device="cpu")
    tras._get_point_renderer_impl.cache_clear()
    monkeypatch.setattr(tras, "get_default_container", lambda: cpu)
    yield cpu
    tras._get_point_renderer_impl.cache_clear()


@pytest.fixture(params=["jax", "torch"])
def api(request):
    if request.param == "jax":
        return types.SimpleNamespace(ras=jras, ghosts=jghosts, cpu={})
    request.getfixturevalue("cpu_default")
    return types.SimpleNamespace(ras=tras, ghosts=tghosts,
                                 cpu={"device": "cpu"})


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_analytic_sphere_mass_conservation(api):
    # reference main.cpp:53-84: total deposited mass ~ weight
    ppu = 32.0
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.2], np.float32)
    vol = api.ras.render_points_volume(pos, w, r, ppu, 32)
    assert vol.shape == (32, 32, 32)
    assert abs(vol.sum() - 1.0) < 0.02
    density = 1.0 / (4.0 / 3.0 * math.pi * 0.2**3) / ppu**3
    assert abs(vol[16, 16, 16] - density) / density < 0.05
    lit = np.count_nonzero(vol) / vol.size
    rpx = 0.2 * ppu
    inner = 4.0 / 3.0 * math.pi * rpx**3 / vol.size
    outer = 4.0 / 3.0 * math.pi * (rpx + 1.5) ** 3 / vol.size
    assert inner <= lit <= outer


def test_subpixel_snap_and_z_tiebreak(api):
    ppu = 8.0
    pos = np.array([[0.3, 0.6, 0.55], [0.25, 0.25, 0.5]], np.float32)
    w = np.array([2.0, 3.0], np.float32)
    r = np.array([0.01, 0.01], np.float32)
    vol = api.ras.render_points_volume(pos, w, r, ppu, 8)
    assert vol.sum() == pytest.approx(5.0)
    assert vol[2, 4, 4] == pytest.approx(2.0)
    assert vol[2, 2, 3] == pytest.approx(3.0)  # tie -> lower slice
    assert np.count_nonzero(vol) == 2


def test_periodic_mass_conservation_corner(api):
    ppu = 24.0
    pos = np.array([[0.02, 0.02, 0.02]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.15], np.float32)
    vol_np = api.ras.render_points_volume(pos, w, r, ppu, 24, periodic=False)
    vol_p = api.ras.render_points_volume(pos, w, r, ppu, 24, periodic=True)
    assert vol_np.sum() < 0.30
    assert abs(vol_p.sum() - 1.0) < 0.02
    assert vol_p[-2:, -2:, -2:].sum() > 0


def test_periodic_equals_manual_ghosts(api):
    rng = np.random.Generator(np.random.Philox(7))
    n = 20
    ppu = 16.0
    pos = rng.random((n, 3)).astype(np.float32)
    w = np.ones(n, np.float32)
    r = (rng.random(n).astype(np.float32) * 0.1 + 0.02)
    vol_p = api.ras.render_points_volume(pos, w, r, ppu, 16, periodic=True)
    gp, gw, gr = api.ghosts.augment_points_periodic(pos, w, r, (1.0,) * 3)
    vol_g = api.ras.render_points_volume(_np(gp), _np(gw), _np(gr), ppu, 16,
                                         periodic=False)
    np.testing.assert_allclose(vol_p, vol_g, rtol=1e-5, atol=1e-6)


def test_period_normalization_variants(api):
    pos = np.array([[0.05, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.1], np.float32)
    rpv = api.ras.render_points_volume
    a = rpv(pos, w, r, 16.0, 16, periodic=True)
    b = rpv(pos, w, r, 16.0, 16, periodic=1.0)
    c = rpv(pos, w, r, 16.0, 16, periodic=(1.0, 1.0, 1.0))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    d = rpv(pos, w, r, 16.0, 16, periodic=(1.0, -1.0, -1.0))
    np.testing.assert_allclose(d.sum(), 1.0, atol=0.02)


def test_output_shapes_and_order(api):
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.1], np.float32)
    vol = api.ras.render_points_volume(pos, w, r, 8.0, (8, 12, 16))
    assert vol.shape == (8, 12, 16)
    assert vol.flags["F_CONTIGUOUS"] and vol.dtype == np.float32
    img = api.ras.render_points(pos, w, r, 8.0, (8, 12))
    assert img.shape == (8, 12)
    assert img.flags["F_CONTIGUOUS"] and img.dtype == np.float32


def test_anisotropic_axis_mapping(api):
    pos = np.array([[0.1, 0.3, 0.7]], np.float32)  # -> voxel (1, 4, 11)
    w = np.array([1.0], np.float32)
    r = np.array([0.001], np.float32)
    vol = api.ras.render_points_volume(pos, w, r, 16.0, (4, 8, 16))
    assert vol[1, 4, 11] == pytest.approx(1.0)
    assert vol.sum() == pytest.approx(1.0)


def test_height_width_unpack_order(api):
    """get_point_renderer unpacks (height, width) like the reference
    (__init__.py:60-84): the first extent spans position x."""
    pr = api.ras.get_point_renderer((8, 12))
    assert (pr.height, pr.width) == (8, 12)
    pos = np.array([[0.9, 0.1, 0.5]], np.float32)
    vol = pr.render_points_volume(pos, np.ones(1, np.float32),
                                  np.full(1, 0.01, np.float32), 4, 8.0)
    assert vol.shape == (8, 12, 4)
    assert vol[7, 0, 3] == pytest.approx(1.0)


def test_render_points_2d_subpixel(api):
    ppu = 8.0
    pos = np.array([[0.3, 0.6, 0.2], [0.3, 0.3, 0.8]], np.float32)
    w = np.array([1.0, 1.0], np.float32)
    r = np.array([0.01, 0.01], np.float32)
    img = api.ras.render_points(pos, w, r, ppu, 8)
    assert img[2, 4] == pytest.approx(1.0)
    assert img.sum() == pytest.approx(1.0)


def test_render_points_2d_big_particle_slab(api):
    ppu = 16.0
    pos = np.array([[0.5, 0.5, 0.0]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.2], np.float32)
    img = api.ras.render_points(pos, w, r, ppu, 16)
    rpx = 0.2 * ppu
    expect = math.pi * rpx**2 / (4.0 / 3.0 * math.pi * rpx**3)
    assert abs(img.sum() - expect) / expect < 0.1


def test_input_validation(api):
    rpv = api.ras.render_points_volume
    w1 = np.ones(2, np.float32)
    with pytest.raises(ValueError):
        rpv(np.zeros((2, 2), np.float32), w1, w1, 8.0, 8)
    with pytest.raises(ValueError):
        rpv(np.zeros((2, 3), np.float32), w1, np.ones(3, np.float32), 8.0, 8)
    with pytest.raises(ValueError):
        rpv(np.zeros((2, 3), np.float32), np.ones((2, 1), np.float32), w1,
            8.0, 8)


def test_validation_layer(api):
    c = api.ras.Container(enable_validation_layers=True, **api.cpu)
    pr = api.ras.PointRenderer(c, 8, 8)
    pos = np.array([[0.5, 0.5, 0.25], [0.2, np.nan, 0.1]], np.float32)
    w = np.ones(2, np.float32)
    r = np.full(2, 0.05, np.float32)
    with pytest.raises(ValueError, match="non-finite"):
        pr.render_points_volume(pos, w, r, 8, 8.0)
    pos[1, 1] = 0.5
    vol = pr.render_points_volume(pos, w, r, 8, 8.0)
    assert np.isfinite(vol).all()


def test_renderer_cache(api):
    r1 = api.ras.get_point_renderer((16, 16))
    r2 = api.ras.get_point_renderer((16, 16))
    r3 = api.ras.get_point_renderer((16, 16), subsample_factor=2)
    assert r1 is r2
    assert r1 is not r3


def test_validation_layer_checks_output():
    """A finite input can still render a non-finite field (an overflowing
    weight): the port's validation layer checks the output too."""
    pr = tras.PointRenderer(tras.Container(enable_validation_layers=True,
                                           device="cpu"), 8, 8)
    pos = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]], np.float32)
    w = np.full(2, 3e38, np.float32)
    r = np.full(2, 0.01, np.float32)
    with pytest.raises(ValueError, match="rendered field"):
        pr.render_points_volume(pos, w, r, 8, 8.0)


def test_no_card_no_default_container(monkeypatch):
    """Without a card, the default container and a Container() naming no
    device raise, naming device="cpu"; they never quietly take the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tras.get_default_container.cache_clear()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tras.Container()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tras.Container(enable_validation_layers=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tras.get_default_container()
    assert tras.Container(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("render", ["render_points_volume", "render_points"])
def test_no_card_module_renders_raise(monkeypatch, render):
    """The module-level renders go through the default container: without a
    card they raise rather than return a CPU result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tras.get_default_container.cache_clear()
    tras._get_point_renderer_impl.cache_clear()
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    one = np.ones(1, np.float32)
    fn = getattr(tras, render)
    grid = 8 if render == "render_points" else (8, 8, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(pos, one, one * 0.1, 8.0, grid)


def test_container_device_and_engine_choice():
    c = tras.Container(device="cpu")
    assert c.device == torch.device("cpu") and not c.validation
    assert tras.PointRenderer(c, 4, 4)._use_engine() is False
    assert tras.PointRenderer(c, 4, 4, engine="cuda")._use_engine() is True
    with pytest.raises(ValueError, match="engine"):
        tras.PointRenderer(c, 4, 4, engine="pallas")


def _workload(n, seed, ppu, rpx_hi):
    rng = np.random.Generator(np.random.Philox(seed))
    pos = rng.random((n, 3)).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    rpx = rng.uniform(0.05, rpx_hi, n).astype(np.float32)
    return pos, w, (rpx / ppu).astype(np.float32)


@pytest.mark.parametrize("periodic,rpx_hi", [(False, 3.9), (True, 3.9),
                                             (True, 9.0)])
def test_volume_matches_jax(periodic, rpx_hi, cpu_default):
    ppu = 24.0
    pos, w, r = _workload(60, 41, ppu, rpx_hi)
    want = jras.render_points_volume(pos, w, r, ppu, 24, periodic=periodic)
    got = tras.render_points_volume(pos, w, r, ppu, 24, periodic=periodic)
    assert got.flags["F_CONTIGUOUS"]
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL + _quantum_atol(w, r * ppu))


def test_engine_route_volume_matches_jax():
    """engine="cuda" on the CPU: ghosts, fused partition, align and deposit
    plain versions, dense tail — against the JAX oracle render."""
    ppu = 32.0
    pos, w, r = _workload(120, 43, ppu, 17.0)
    want = jras.render_points_volume(pos, w, r, ppu, (32, 24, 28),
                                     periodic=True)
    pr = tras.PointRenderer(tras.Container(device="cpu"), 24, 32,
                            engine="cuda")
    got = pr.render_points_volume(pos, w, r, 28, ppu,
                                  period=(1.0, 0.75, 0.875))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL + _quantum_atol(w, r * ppu))


@pytest.mark.parametrize("engine", ["auto", "cuda"])
def test_render_points_2d_matches_jax(engine):
    """The port's 2D render, through the 2D oracle (auto on the CPU) and
    through the engine's one-voxel slab, against the JAX 2D oracle —
    including sub-pixel particles exactly on the +-0.5-unit z bounds."""
    ppu = 16.0
    rng = np.random.Generator(np.random.Philox(47))
    n = 80
    pos = np.stack([rng.random(n), rng.random(n) * 1.5,
                    (rng.random(n) - 0.5) * 1.2], 1).astype(np.float32)
    pos[:4, 2] = (-0.5, 0.5, -0.5, 0.5)
    w = (rng.random(n) + 0.5).astype(np.float32)
    rpx = rng.uniform(0.05, 3.9, n).astype(np.float32)
    rpx[:4] = 0.1
    r = (rpx / ppu).astype(np.float32)
    want = jras.render_points(pos, w, r, ppu, (16, 24))
    pr = tras.PointRenderer(tras.Container(device="cpu"), 24, 16,
                            engine=engine)
    got = pr.render_points(pos, w, r, ppu)
    assert got.shape == (16, 24) and got.flags["F_CONTIGUOUS"]
    # the slab's half-pixel z shift rounds once in float32: round-off only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _slab_fields():
    """(field, rows) cases of the slab copy; values with a sign and -0.0."""
    rng = np.random.Generator(np.random.Philox(53))

    def field(*shape):
        a = (rng.random(shape) - 0.5).astype(np.float32)
        a.flat[0] = -0.0
        return torch.from_numpy(a)

    return {
        "rows-not-dividing-nz": (field(5, 4, 7), 3),
        "one-slice-volume": (field(5, 4, 1), 2),
        "2d-field": (field(6, 5), 2),
        "render-points-view": (field(6, 5, 1)[:, :, 0], 2),
        "strided-view": (field(6, 5, 3)[:, :, 1], 4),
        "slab-larger-than-field": (field(4, 3, 5), 100),
    }


@pytest.mark.parametrize("case", sorted(_slab_fields()))
def test_slab_copy_bit_equal_to_one_copy(case):
    """The copy to the host in slabs (a card's path, here on CPU tensors
    with forced slab rows) against the one permute and copy, bit for bit;
    the CPU path itself stages nothing."""
    from nbodyhpc_tpu_torch.utils import profiling

    field, rows = _slab_fields()[case]
    rev = tuple(range(field.dim() - 1, -1, -1))
    want = field.permute(rev).contiguous().numpy().transpose(rev)
    n = field.shape[-1]

    def slabs():
        return profiling.counters().get("render.to_host.slabs", 0)

    before = slabs()
    got = tras._to_fortran_slabs(field, rows)
    assert slabs() - before == math.ceil(n / min(rows, n))
    before = slabs()
    one = tras._to_fortran(field)
    assert slabs() == before
    for a in (got, one):
        assert a.flags["F_CONTIGUOUS"] and a.dtype == np.float32
        assert a.shape == tuple(field.shape)
        np.testing.assert_array_equal(a.view(np.uint32), want.view(np.uint32))


def test_rasterizer_demo_cli():
    from nbodyhpc_tpu_torch.cli import rasterizer_demo

    assert rasterizer_demo.main(["--grid", "16", "--device", "cpu"]) == 0


def test_port_imports_no_jax():
    code = ("import sys, nbodyhpc_tpu_torch.rasterizer, "
            "nbodyhpc_tpu_torch.interop, nbodyhpc_tpu_torch.ops.splat_cuda, "
            "nbodyhpc_tpu_torch.cli.rasterizer_demo, "
            "nbodyhpc_tpu_torch.kdtree, nbodyhpc_tpu_torch.ops.knn_device, "
            "nbodyhpc_tpu_torch.ops.knn_cuda, nbodyhpc_tpu_torch.ops.ball, "
            "nbodyhpc_tpu_torch.utils.stats, nbodyhpc_tpu_torch.utils.philox, "
            "nbodyhpc_tpu_torch.cli.kdtree_bench, nbodyhpc_tpu_torch.runtime, "
            "nbodyhpc_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'nbodyhpc_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
    imp = re.compile(r"^\s*(import|from)\s+(jax|nbodyhpc_tpu)\b", re.M)
    for path in (REPO / "nbodyhpc_tpu_torch").rglob("*.py"):
        assert not imp.search(path.read_text()), path
