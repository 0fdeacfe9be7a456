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
from nbodyhpc_tpu_torch.ops.splat_dense import DENSE_COUNTERS
from nbodyhpc_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# atomics reorder float sums; the kernels build with --fmad=false
RTOL, ATOL = 2e-5, 1e-6


def _launches(kernel: str) -> int:
    return profiling.counters().get(f"{kernel}.launches", 0)


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
        srcf, starts, cnts, aoff = sc._prep_body(
            part.pos_px[r0:r1], part.w[r0:r1], part.rpx[r0:r1],
            part.key[r0:r1] - part.kbases[bi], part.grid, geom)
        args = (starts, cnts, aoff, srcf)
        assert int((cnts > 0).sum()) > 1  # multi-tile
        nrows = int(((cnts + geom.CH - 1) // geom.CH).sum()) * geom.CH
        before = _launches("splat.align")
        kf = sc.align(*args, geom.CH, nrows)
        assert _launches("splat.align") == before + 1
        rf = sc.align_reference(*args, geom.CH, nrows)
        torch.cuda.synchronize()
        assert kf.shape == (sc.NF, nrows)
        assert torch.equal(kf.view(torch.int32), rf.view(torch.int32))


@pytest.mark.parametrize("subsample", [4, 2])
@pytest.mark.parametrize("bi", range(len(sc.BUCKETS)))
def test_deposit_kernel_matches_plain(cuda, bi, subsample):
    geom = sc.BUCKETS[bi]
    part = _partition(cuda)
    stream = sc.bucket_stream(part, bi)
    assert stream is not None
    attrs, nch = stream
    shape = part.grid
    before = _launches("splat.deposit")
    vk = sc.deposit(attrs, nch, torch.zeros(shape, device=cuda), geom,
                    subsample)
    assert _launches("splat.deposit") == before + 1
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
        attrs, nch = stream
        if zero_every:
            attrs[4:6, ::zero_every] = 0.0
        before = _launches("splat.deposit")
        vk = sc.deposit(attrs, nch, torch.zeros(grid, device=device), geom,
                        subsample)
        assert _launches("splat.deposit") == before + 1
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
    attrs, nch = sc.bucket_stream(part, 0)
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
    before = _launches("splat.deposit")
    vol = card.render_points_volume(pos, w, r, 24, 32.0, (1.0, 1.0, 0.75))
    img = card.render_points(pos, w, r, 32.0)
    assert _launches("splat.deposit") > before
    np.testing.assert_allclose(
        vol, cpu.render_points_volume(pos, w, r, 24, 32.0, (1.0, 1.0, 0.75)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(img, cpu.render_points(pos, w, r, 32.0),
                               rtol=RTOL, atol=ATOL)


def test_finish_copies_through_pinned_slabs(cuda):
    """A 256^3 render's copy to the host, in one slab and in 16, bit-equal
    to the one pageable copy; the profiler sees pinned copies only, and a
    second call allocates no pinned memory."""
    import math

    from nbodyhpc_tpu_torch.rasterizer import (SLAB_BYTES, Container,
                                               PointRenderer,
                                               _to_fortran_slabs)

    g = 256
    pos, w, rpx = _particles(200_000, 17, rpx_hi=6.0)
    pr = PointRenderer(Container(device=cuda), g, g)
    field = pr._render_volume_device(pos, w, rpx / g, g, float(g))
    want = field.permute(2, 1, 0).contiguous().cpu().numpy().transpose(
        2, 1, 0).view(np.uint32)
    assert want.any()

    def slabs():
        return profiling.counters().get("render.to_host.slabs", 0)

    def copies():
        before = slabs()
        one = pr._finish(field)
        assert slabs() - before == math.ceil(field.numel() * 4 / SLAB_BYTES)
        many = _to_fortran_slabs(field, 16)
        assert slabs() - before == math.ceil(field.numel() * 4
                                             / SLAB_BYTES) + g // 16
        for a in (one, many):
            assert a.flags["F_CONTIGUOUS"] and a.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.uint32), want)

    copies()
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        copies()
        torch.cuda.synchronize()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    d2h = {e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "DtoH" in e.name}
    assert "Memcpy DtoH (Device -> Pinned)" in d2h, d2h
    assert not any("Pageable" in name for name in d2h), d2h


def test_volume_render_returns_pinned_host_memory(cuda):
    """A card volume comes back as a view of pinned memory from torch's
    caching host allocator, bit-equal to the field's one copy; once that
    array is freed, the next render of its size allocates no host memory."""
    from nbodyhpc_tpu_torch import rasterizer as tras

    g = 256
    pos, w, rpx = _particles(200_000, 19, rpx_hi=6.0)
    pr = tras.PointRenderer(tras.Container(device=cuda), g, g)
    field = pr._render_volume_device(pos, w, rpx / g, g, float(g))
    want = field.permute(2, 1, 0).contiguous().cpu().numpy().transpose(2, 1, 0)
    got = pr._finish(field)
    assert got.flags["F_CONTIGUOUS"] and torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    del got
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    vol = pr.render_points_volume(pos, w, rpx / g, g, float(g))
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert vol.flags["F_CONTIGUOUS"] and torch.from_numpy(vol).is_pinned()
    np.testing.assert_allclose(vol, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the dense large-radius pass (csrc/splat_dense.cu)
# ---------------------------------------------------------------------------


def _dense_rows(case, rng):
    """(positions px [n, 3], weights [n], radii px [n], grid) of one case."""
    if case == "large":  # 15-60 px, all inside a 96^3 grid
        n, grid = 300, (96, 96, 96)
        pos = rng.uniform(0, 96, (n, 3))
        rpx = rng.uniform(15, 60, n)
    elif case == "faces":  # windows cut by every face, some centres outside
        n, grid = 400, (70, 83, 66)
        pos = rng.uniform(-20, 1, (n, 3)) + rng.integers(0, 2, (n, 3)) * (
            np.array(grid) + 19)
        rpx = rng.uniform(15, 40, n)
    elif case == "small_grid":  # every axis below the window F
        n, grid = 120, (20, 37, 11)
        pos = rng.uniform(-5, 40, (n, 3))
        rpx = rng.uniform(15, 45, n)
    elif case == "signed_weights":
        n, grid = 300, (64, 72, 80)
        pos = rng.uniform(0, 64, (n, 3))
        rpx = rng.uniform(15, 30, n)
    else:  # one halo core: radii from sub-pixel to 30 px around one point
        n, grid = 600, (72, 64, 96)
        pos = 35.0 + rng.normal(0, 2.0, (n, 3))
        rpx = np.exp(rng.uniform(np.log(0.2), np.log(30), n))
    w = rng.uniform(0.5, 1.5, n)
    if case == "signed_weights":
        w[::3] = 0.0
        w[1::3] *= -1.0
    return [torch.from_numpy(a.astype(np.float32)) for a in (pos, w, rpx)] + [
        grid]


def _dense_pair(cuda, pos, w, rpx, grid, subsample=4):
    """(kernel, plain twin, plain twin with |w|), all on the card."""
    from nbodyhpc_tpu_torch.ops import splat_dense as sd

    pos, w, rpx = (t.to(cuda) for t in (pos, w, rpx))
    before = _launches("splat.dense")
    got = sd.splat_volume_dense(pos, w, rpx, grid, subsample,
                                vol0=torch.zeros(grid, device=cuda))
    assert _launches("splat.dense") == before + 1
    mr = float(rpx.max())
    want = sd.dense_reference(pos, w, rpx, torch.zeros(grid, device=cuda),
                              subsample, mr)
    mag = sd.dense_reference(pos, w.abs(), rpx,
                             torch.zeros(grid, device=cuda), subsample, mr)
    torch.cuda.synchronize()
    return got, want, mag


@pytest.mark.parametrize("case", ["large", "faces", "small_grid",
                                  "signed_weights", "halo_core"])
def test_dense_kernel_matches_plain(cuda, case):
    """The kernel against its plain twin. Each voxel's terms are the
    twin's to the bit; only the order of the sums differs (shared-memory
    atomics, then one add into the volume, against the twin's index_add
    in chunk order), so a voxel may differ by the rounding of a float32 sum
    of its n terms in two orders: here 16 sqrt(n) ulps of the sum of their
    magnitudes, and exactly 0 where no row reaches."""
    pos, w, rpx, grid = _dense_rows(case, np.random.default_rng(7))
    got, want, mag = _dense_pair(cuda, pos, w, rpx, grid)
    assert float(mag.sum()) > 0
    tol = 16 * np.sqrt(pos.shape[0]) * torch.finfo(torch.float32).eps * mag
    assert bool(((got - want).abs() <= tol).all()), float(
        ((got - want).abs() - tol).max())
    assert torch.equal(got == 0, want == 0) or case == "signed_weights"


@pytest.mark.parametrize("subsample", [4, 3])
def test_dense_kernel_bit_equal_without_overlap(cuda, subsample):
    """Rows whose windows never meet: one term a voxel, so the kernel is
    bit-equal to its twin (S = 3 takes the kernel's runtime-S path)."""
    rng = np.random.default_rng(3)
    centres = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                       -1).reshape(-1, 3) * 44.0 + 22.0
    pos = torch.from_numpy((centres + rng.uniform(-0.5, 0.5, centres.shape))
                           .astype(np.float32))
    rpx = torch.from_numpy(rng.uniform(15.2, 18.0, 27).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 27).astype(np.float32))
    got, want, _ = _dense_pair(cuda, pos, w, rpx, (132, 132, 132), subsample)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_dense_kernel_adds_onto_the_volume(cuda):
    """Through the render's engine: the dense rows add onto the buckets'
    deposits in place, and ``render.dense_voxels`` counts their spheres."""
    import math

    g = 80
    rng = np.random.default_rng(11)
    pos, w, rpx = _particles(4000, 21, rpx_hi=12.0)
    rpx[:40] = torch.from_numpy(rng.uniform(15.5, 35.0, 40).astype(np.float32))
    r = rpx / g
    c0 = profiling.counters()
    got = sc.splat_volume(pos.to(cuda), w.to(cuda), r.to(cuda), float(g),
                          (g,) * 3)
    c1 = profiling.counters()
    want = sc.splat_volume(pos, w, r, float(g), (g,) * 3)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
    rp = (r * np.float32(g)).numpy()
    dense = rp[rp > 15.0]
    assert c1["render.dense_rows"] - c0.get("render.dense_rows", 0) == 40
    assert c1["splat.dense.launches"] - c0.get("splat.dense.launches", 0) == 1
    want_vox = sum(math.ceil(float(np.float32(sc.FOUR_THIRDS_PI)
                                   * np.float32(v * v * v))) for v in dense)
    got_vox = c1["render.dense_voxels"] - c0.get("render.dense_voxels", 0)
    assert abs(got_vox - want_vox) <= len(dense)


def test_dense_kernel_rows_off_the_grid(cuda):
    """Rows whose windows miss the grid, and rows of zero weight, bin into
    no tile: the wrapper reads an empty list and launches no deposit."""
    from nbodyhpc_tpu_torch.ops import splat_dense as sd

    pos = torch.tensor([[-60.0, 5.0, 5.0], [5.0, 90.0, 5.0], [8.0, 8.0, 8.0]],
                       device=cuda)
    w = torch.tensor([1.0, 1.0, 0.0], device=cuda)
    rpx = torch.tensor([20.0, 30.0, 16.0], device=cuda)
    vol = torch.full((32, 40, 24), 0.5, device=cuda)
    before = _launches("splat.dense")
    out = sd.splat_volume_dense(pos, w, rpx, vol.shape, 4, vol0=vol)
    torch.cuda.synchronize()
    assert out is vol and bool((vol == 0.5).all())
    assert _launches("splat.dense") == before


@pytest.mark.parametrize("subsample", [4, 3, 5])
def test_dense_kernel_runs_across_tile_and_grid_faces(cuda, subsample):
    """Rows whose interior runs cross the kernel's z tile faces (centres
    within a radius of a multiple of 64) and the grid's faces: held to the
    plain twin within 16 sqrt(n) ulps, as ``test_dense_kernel_matches_plain``
    (S = 3 and 5 take the kernel's runtime-S path)."""
    rng = np.random.default_rng(23 + subsample)
    n, grid = 240, (80, 72, 150)
    rpx = rng.uniform(15, 30, n)
    pos = rng.uniform(0, 1, (n, 3)) * np.array([80.0, 72.0, 1.0])
    face = rng.choice([0.0, 64.0, 128.0, 150.0], n)
    pos[:, 2] = face + rng.uniform(-1, 1, n) * rpx
    w = rng.uniform(0.5, 1.5, n)
    pos, w, rpx = (torch.from_numpy(a.astype(np.float32))
                   for a in (pos, w, rpx))
    got, want, mag = _dense_pair(cuda, pos, w, rpx, grid, subsample)
    assert float(mag.sum()) > 0
    tol = 16 * np.sqrt(n) * torch.finfo(torch.float32).eps * mag
    assert bool(((got - want).abs() <= tol).all()), float(
        ((got - want).abs() - tol).max())
    assert torch.equal(got == 0, want == 0)


def _dense_render(cuda):
    """A render through the public API whose dense rows are 20-30 px:
    (renderer, positions, weights, radii, grid)."""
    from nbodyhpc_tpu_torch.rasterizer import Container, PointRenderer

    g = 96
    rng = np.random.default_rng(29)
    pos, w, rpx = _particles(3000, 31, rpx_hi=12.0)
    rpx[:30] = torch.from_numpy(rng.uniform(20.0, 30.0, 30).astype(np.float32))
    return PointRenderer(Container(device=cuda), g, g), pos, w, rpx / g, g


def _dense_counts():
    c = profiling.counters()
    return tuple(c.get(k, 0) for k in DENSE_COUNTERS)


def test_dense_kernel_counts_runs_while_traced(cuda):
    """Under a profiler the dense kernel counts the voxels its interior
    runs filled and those it counted one by one; ``counters()`` reads them
    back, and on 20-30 px rows the runs hold most voxels."""
    pr, pos, w, r, g = _dense_render(cuda)
    run0, shell0 = _dense_counts()
    launches = _launches("splat.dense")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        pr.render_points_volume(pos, w, r, g, float(g))
    run1, shell1 = _dense_counts()
    assert _launches("splat.dense") == launches + 1
    assert run1 - run0 > shell1 - shell0 > 0


def test_dense_kernel_counts_nothing_untraced(cuda):
    """With no profiler the kernel gets no counts buffer: the counters stay
    as they were, and no buffer waits to be read back."""
    pr, pos, w, r, g = _dense_render(cuda)
    before = _dense_counts()
    launches = _launches("splat.dense")
    pr.render_points_volume(pos, w, r, g, float(g))
    assert _launches("splat.dense") == launches + 1
    assert profiling.device_counts(DENSE_COUNTERS, cuda) is None
    assert not any(written for _, written in profiling._device.values())
    assert _dense_counts() == before
