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
