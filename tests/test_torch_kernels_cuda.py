"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper GPU and ``nvcc`` (marker ``cuda``)
and skips without a CUDA device. The file imports torch only, so it runs on
a machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch.ops import splat_cuda as sc

pytestmark = pytest.mark.cuda

# atomics reorder float sums; the kernels build with --fmad=false
RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for sm_90a)")
    return torch.device("cuda")


def _particles(n, seed, rpx_hi=15.0):
    rng = np.random.Generator(np.random.Philox(seed))
    pos = rng.random((n, 3)).astype(np.float32)
    rpx = rng.uniform(0.5, rpx_hi, n).astype(np.float32)
    rpx[: n // 10] = rng.uniform(0.05, 0.45, n // 10)  # sub-pixel
    w = (rng.random(n) + 0.5).astype(np.float32)
    return [torch.from_numpy(a) for a in (pos, w, rpx)]


def _partition(device, n=6000, g=64, seed=5):
    """Particles over a (g, 200, g) grid: several y tiles per bucket."""
    pos, w, rpx = (t.to(device) for t in _particles(n, seed))
    pos[:, 1] *= 200 / g
    return sc.prepartition(pos, w, rpx / g, float(g), (g, 200, g))


def test_align_kernel_bit_equal_to_plain(cuda):
    part = _partition(cuda)
    for bi, geom in enumerate(sc.BUCKETS):
        r0, r1 = part.wtabs[bi][0], part.wtabs[bi][-1]
        srcf, srci, starts, cnts, aoff = sc._prep_body(
            part.pos_px[r0:r1], part.w[r0:r1], part.rpx[r0:r1],
            part.key[r0:r1] - part.kbases[bi], part.grid, geom)
        args = (starts, cnts, aoff, srcf, srci)
        assert int((cnts > 0).sum()) > 1  # multi-tile
        nrows = int(((cnts + geom.CH - 1) // geom.CH).sum()) * geom.CH
        before = sc.align.launches
        kf, ki = sc.align(*args, geom.CH, geom.HALO, nrows)
        assert sc.align.launches == before + 1
        rf, ri = sc.align_reference(*args, geom.CH, geom.HALO, nrows)
        torch.cuda.synchronize()
        assert torch.equal(kf.view(torch.int32), rf.view(torch.int32))
        assert torch.equal(ki, ri)


@pytest.mark.parametrize("subsample", [4, 2])
@pytest.mark.parametrize("bi", range(len(sc.BUCKETS)))
def test_deposit_kernel_matches_plain(cuda, bi, subsample):
    geom = sc.BUCKETS[bi]
    part = _partition(cuda)
    stream = sc.bucket_stream(part, bi)
    assert stream is not None
    attrs, _, nch = stream
    shape = part.grid
    before = sc.deposit.launches
    vk = sc.deposit(attrs, nch, torch.zeros(shape, device=cuda), geom,
                    subsample)
    assert sc.deposit.launches == before + 1
    vr = sc.deposit_reference(attrs, nch, torch.zeros(shape, device=cuda),
                              geom, subsample)
    torch.cuda.synchronize()
    assert float(vr.sum()) > 0
    torch.testing.assert_close(vk, vr, rtol=RTOL, atol=ATOL)


def _deposit_pairs(device, ppx, w, rpx, grid, subsample, zero_every=0):
    """Every non-empty bucket of the particles (pixel units) through the
    kernel and the plain version, each into a zeroed ``grid`` volume.
    ``zero_every``: zero the weights of every n-th aligned row first (pad
    rows that still carry positions). Returns [(geom, kernel, plain)]."""
    part = sc.prepartition(ppx.to(device), w.to(device), rpx.to(device), 1.0,
                           grid)
    out = []
    for bi, geom in enumerate(sc.BUCKETS):
        stream = sc.bucket_stream(part, bi)
        if stream is None:
            continue
        attrs, _, nch = stream
        if zero_every:
            attrs[4:6, ::zero_every] = 0.0
        before = sc.deposit.launches
        vk = sc.deposit(attrs, nch, torch.zeros(grid, device=device), geom,
                        subsample)
        assert sc.deposit.launches == before + 1
        vr = sc.deposit_reference(attrs, nch,
                                  torch.zeros(grid, device=device), geom,
                                  subsample)
        out.append((geom, vk, vr))
    torch.cuda.synchronize()
    assert len(out) == len(sc.BUCKETS)
    return out


def _spread(n, rng, subsample=None):
    """n radii over every bucket and sub-pixel, float32; on the 1/(2S)
    lattice when ``subsample`` is given."""
    rpx = np.concatenate([rng.uniform(0.05, 0.45, n // 8),
                          rng.uniform(0.5, 15.0, n - n // 8)])
    if subsample is not None:
        q = 2 * subsample
        rpx = np.maximum(np.round(rpx * q), 1) / q
    return torch.from_numpy(rpx.astype(np.float32))


@pytest.mark.parametrize("subsample", [1, 3, 4, 16])
def test_deposit_kernel_knife_edge_lattice(cuda, subsample):
    """Positions and radii on the 1/(2S) subcell lattice, where subcell
    compares tie, on a non-cubic grid with gz % 4 != 0."""
    grid = (40, 36, 30)
    rng = np.random.Generator(np.random.Philox(21 + subsample))
    n = 800
    q = 2 * subsample
    ppx = torch.from_numpy(
        (rng.integers(0, 30 * q, (n, 3)) / q).astype(np.float32))
    w = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    for geom, vk, vr in _deposit_pairs(cuda, ppx, w, _spread(n, rng, subsample),
                                       grid, subsample):
        assert float(vr.sum()) > 0, geom
        torch.testing.assert_close(vk, vr, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", [(37, 45, 30), (36, 44, 32)])
def test_deposit_kernel_particles_straddling_every_face(cuda, grid):
    """Particles centred within a radius of each of the six faces, inside
    and outside the grid; gz % 4 != 0 and gz % 4 == 0."""
    rng = np.random.Generator(np.random.Philox(31))
    n = 1200
    g = np.array(grid, np.float64)
    pos = rng.random((n, 3)) * g
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    pos[np.arange(n), axis] = side * g[axis] + rng.uniform(-6.0, 6.0, n)
    ppx = torch.from_numpy(pos.astype(np.float32))
    w = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    for geom, vk, vr in _deposit_pairs(cuda, ppx, w, _spread(n, rng), grid, 4):
        torch.testing.assert_close(vk, vr, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("subsample", [4, 3])
def test_deposit_kernel_skips_zero_weight_rows(cuda, subsample):
    grid = (48, 40, 36)
    rng = np.random.Generator(np.random.Philox(41))
    n = 1500
    ppx = torch.from_numpy((rng.random((n, 3)) * grid).astype(np.float32))
    w = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    for geom, vk, vr in _deposit_pairs(cuda, ppx, w, _spread(n, rng), grid,
                                       subsample, zero_every=3):
        torch.testing.assert_close(vk, vr, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("subsample", [4, 3])
@pytest.mark.parametrize("gz", [102, 136])
def test_deposit_kernel_bit_equal_without_overlap(cuda, gz, subsample):
    """Windows 34 px apart never overlap, so each voxel receives one
    contribution and no sum is reordered: the kernel must equal the plain
    version bit for bit, and a single wrong subcell count would show."""
    grid = (136, 136, gz)
    rng = np.random.Generator(np.random.Philox(51 + gz + subsample))
    cells = np.stack(np.meshgrid(*(np.arange(g // 34) for g in grid),
                                 indexing="ij"), -1).reshape(-1, 3)
    n = cells.shape[0]
    pos = 17.0 + 34.0 * cells + rng.uniform(-0.5, 0.5, (n, 3))
    ppx = torch.from_numpy(pos.astype(np.float32))
    w = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    rpx = torch.from_numpy(np.resize(
        np.array([0.3, 1.7, 2.6, 3.4, 4.5, 6.2, 9.5, 14.8]), n
    ).astype(np.float32) + rng.uniform(0.0, 0.1, n).astype(np.float32))
    for geom, vk, vr in _deposit_pairs(cuda, ppx, w, rpx, grid, subsample):
        assert float(vr.sum()) > 0, geom
        assert torch.equal(vk.view(torch.int32), vr.view(torch.int32)), geom


def test_engine_on_card_matches_cpu(cuda):
    g = 48
    pos, w, rpx = _particles(3000, 9, rpx_hi=17.0)
    r = rpx / g
    want = sc.splat_volume(pos, w, r, float(g), (g, g, g))
    got = sc.splat_volume(pos.to(cuda), w.to(cuda), r.to(cuda), float(g),
                          (g, g, g))
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


def test_wrappers_check_inputs_on_card(cuda):
    part = _partition(cuda, n=500)
    attrs, _, nch = sc.bucket_stream(part, 0)
    vol = torch.zeros(part.grid, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sc.deposit(attrs.t().contiguous().t(), nch, vol, sc.G6)
    with pytest.raises(ValueError, match="subsample"):
        sc.deposit(attrs, nch, vol, sc.G6, subsample=17)
    with pytest.raises(ValueError, match="float32"):
        sc.deposit(attrs, nch, vol.double(), sc.G6)


def test_rasterizer_on_card_matches_cpu(cuda):
    """The API on a CUDA container (kernel engine, 3D and the 2D one-voxel
    slab) against the same calls on the CPU through the plain versions."""
    from nbodyhpc_tpu_torch.rasterizer import Container, PointRenderer

    pos, w, rpx = _particles(2000, 13, rpx_hi=9.0)
    pos[:, 2] -= 0.5
    r = rpx / 32
    card = PointRenderer(Container(device=cuda), 32, 32)
    cpu = PointRenderer(Container(device="cpu"), 32, 32, engine="cuda")
    before = sc.deposit.launches
    vol = card.render_points_volume(pos, w, r, 24, 32.0, (1.0, 1.0, 0.75))
    img = card.render_points(pos, w, r, 32.0)
    assert sc.deposit.launches > before
    np.testing.assert_allclose(
        vol, cpu.render_points_volume(pos, w, r, 24, 32.0, (1.0, 1.0, 0.75)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(img, cpu.render_points(pos, w, r, 32.0),
                               rtol=RTOL, atol=ATOL)
