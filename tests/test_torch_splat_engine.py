"""The PyTorch port's splat tile engine (``ops/splat_cuda.py``) against the
JAX engine and oracle (CPU).

On the CPU the engine's kernel wrappers run their plain versions
(``align_reference``, ``deposit_reference``); the kernels themselves are
held against those on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``). Inputs are made with numpy from a seeded Philox
generator. Tolerances as in ``tests/test_torch_splat.py``: float32 round-off
below 4 px, plus one S^-3 subcell quantum per voxel at 4 px and above.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbodyhpc_tpu.ops import ghosts as jghosts
from nbodyhpc_tpu.ops import splat_pallas as jsp
from nbodyhpc_tpu.ops.splat import splat_volume_oracle as joracle
from nbodyhpc_tpu_torch import _build
from nbodyhpc_tpu_torch import interop
from nbodyhpc_tpu_torch.ops import ghosts as tghosts
from nbodyhpc_tpu_torch.ops import splat_cuda as sc
from nbodyhpc_tpu_torch.utils import profiling
from test_splat_dense import _quantum_atol

RTOL, ATOL = 1e-6, 1e-7


def _launches(kernel: str) -> int:
    return profiling.counters().get(f"{kernel}.launches", 0)


def _rng(seed):
    return np.random.Generator(np.random.Philox(seed))


def _mixed(n_per, seed, grid, ppu, dense=0):
    """Particles spanning sub-pixel, all six buckets and (optionally) the
    dense tail; positions uniform in the grid's box."""
    rng = _rng(seed)
    bands = [(0.05, 0.45), (0.5, 2.0), (2.05, 2.95), (3.05, 3.95),
             (4.05, 4.95), (5.05, 6.95), (7.05, 14.5)]
    rpx = np.concatenate([rng.uniform(lo, hi, n_per) for lo, hi in bands]
                         + [rng.uniform(15.5, 17.0, dense)])
    n = rpx.shape[0]
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    perm = rng.permutation(n)
    return pos[perm], w[perm], (rpx[perm] / ppu).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_buckets_match_jax():
    assert len(sc.BUCKETS) == len(jsp.BUCKETS)
    for tg, jg in zip(sc.BUCKETS, jsp.BUCKETS):
        for field in sc._Geom._fields:
            assert getattr(tg, field) == getattr(jg, field), (tg, field)
    assert (sc.TX, sc.TZ) == (jsp.TX, jsp.TZ)
    # the port's stream is the JAX stream's float channels without the spare
    assert sc.NF == jsp.NF - 1
    for r in (0.3, 2.0, 2.5, 6.0, 15.0, 40.0):
        assert [g.F for g in sc.bucket_ladder(r)] == [
            g.F for g in jsp.bucket_ladder(r)]
    grid = (300, 250, 130)
    for tg, jg in zip(sc.BUCKETS, jsp.BUCKETS):
        assert sc._grid_pad(grid, tg) == jsp._grid_pad(grid, jg)
        assert sc._ntiles(grid, tg) == jsp._ntiles(grid, jg)
    assert sc._fused_bases(grid) == jsp._fused_bases(grid)
    assert sc._fused_boundaries(grid) == jsp._fused_boundaries(grid)


def test_pair_keys_and_radius_class_match_jax():
    rng = _rng(3)
    n = 3000
    grid = (256, 250, 140)
    ppx = (rng.random((n, 3)) * np.array([280.0, 270.0, 160.0])
           - 12.0).astype(np.float32)
    rpx = (rng.random(n) ** 2 * 20.0 + 0.05).astype(np.float32)
    w = (rng.random(n) + 0.1).astype(np.float32)
    w[::37] = 0.0
    for tg, jg in zip(sc.BUCKETS, jsp.BUCKETS):
        tk, tb = sc._pair_keys(_t(ppx), _t(rpx), _t(w), grid, tg)
        jk, jb = jsp._pair_keys(jnp.asarray(ppx), jnp.asarray(rpx),
                                jnp.asarray(w), grid, jg)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        sc._radius_class(_t(rpx)).numpy(),
        np.asarray(jsp._radius_class(jnp.asarray(rpx))))


def _g8_batch():
    """A tile-sorted multi-tile G8 batch (8 tiles), with the ineligible rows
    keyed past the last tile, as the JAX fused path hands it to _prep_body."""
    rng = _rng(7)
    n, ppu = 600, 64.0
    grid = (256, 240, 128)
    box = np.array([g / ppu for g in grid], np.float32)
    ppx = ((rng.random((n, 3)) * box).astype(np.float32) * np.float32(ppu))
    rpx = rng.uniform(2.05, 2.95, n).astype(np.float32)
    rpx[:40] = rng.uniform(0.1, 0.45, 40)  # sub-pixel: ineligible for G8
    w = (rng.random(n) + 0.5).astype(np.float32)
    key, _ = jsp._pair_keys(jnp.asarray(ppx), jnp.asarray(rpx),
                            jnp.asarray(w), grid, jsp.G8)
    key = np.asarray(key)
    order = np.argsort(key, kind="stable")
    return (grid, ppx[order], w[order], rpx[order], key[order].astype(np.int32))


def _jax_prep(grid, ppx, w, rpx, key):
    ntiles = jsp._ntiles(grid, jsp.G8)
    need = ppx.shape[0] + jsp.G8.CH * ntiles + jsp.ACHUNK + jsp.G8.CH
    np_pad = (need + jsp.ACHUNK - 1) // jsp.ACHUNK * jsp.ACHUNK
    out = jsp._prep_batch(
        jnp.asarray(ppx), jnp.asarray(w), jnp.asarray(rpx), grid=grid,
        np_pad=np_pad, geom=jsp.G8, nxt=None, key_in=jnp.asarray(key),
        xt0=jnp.int32(0))
    return np_pad, ntiles, [np.asarray(a) for a in out]


def test_prep_channels_and_offsets_match_jax():
    grid, ppx, w, rpx, key = _g8_batch()
    _, ntiles, (jf, _, jst, jcn, jao) = _jax_prep(grid, ppx, w, rpx, key)
    tf, tst, tcn, tao = sc._prep_body(_t(ppx), _t(w), _t(rpx), _t(key),
                                      grid, sc.G8)
    n = ppx.shape[0]
    assert ntiles == 8 and int((tcn > 0).sum()) > 1  # multi-tile
    np.testing.assert_array_equal(tst.numpy(), jst)
    np.testing.assert_array_equal(tcn.numpy(), jcn)
    np.testing.assert_array_equal(tao.numpy(), jao)
    assert tf.shape == (sc.NF, n)
    np.testing.assert_array_equal(tf.numpy().view(np.int32),
                                  jf[:sc.NF, :n].view(np.int32))


def test_align_reference_bit_equal_to_jax_align_kernel():
    """align_reference against JAX _prep_batch + _run_align (Pallas
    interpret mode) on one multi-tile G8 batch. The port's aligned stream
    ends at the last real chunk; the JAX stream's rows past it are never
    read by the deposit."""
    grid, ppx, w, rpx, key = _g8_batch()
    np_pad, ntiles, (jf, ji, jst, jcn, jao) = _jax_prep(grid, ppx, w, rpx,
                                                        key)
    dstf = jnp.zeros((jsp.NF, np_pad), jnp.float32)
    dsti = jnp.concatenate([
        jnp.full((1, np_pad), ntiles - 1, jnp.int32),
        jnp.full((2, np_pad), jsp.G8.HALO, jnp.int32),
        jnp.zeros((1, np_pad), jnp.int32),
    ])
    af, ai = jsp._run_align(
        jnp.asarray(jst), jnp.asarray(jcn), jnp.asarray(jao),
        jnp.asarray(jf), jnp.asarray(ji), dstf, dsti, np_pad=np_pad,
        ntiles=ntiles, interpret=True, geom=jsp.G8)
    af, ai = np.asarray(af), np.asarray(ai)
    ch = sc.G8.CH
    nrows = int(((jcn + ch - 1) // ch).sum()) * ch
    tf = sc.align(_t(jst), _t(jcn), _t(jao), _t(jf[:sc.NF]), ch, nrows)
    assert tf.shape == (sc.NF, nrows)
    np.testing.assert_array_equal(tf.numpy().view(np.int32),
                                  af[:sc.NF, :nrows].view(np.int32))
    # every CH-chunk holds one tile: the offsets lay the tiles' CH-rounded
    # runs end to end, and the JAX kernel's tile channel agrees chunk by chunk
    aligned = (jcn + ch - 1) // ch * ch
    np.testing.assert_array_equal(jao, np.cumsum(aligned) - aligned)
    chunk_tile = np.repeat(np.arange(ntiles), aligned // ch)
    assert chunk_tile.size * ch == nrows and len(set(chunk_tile)) > 1
    np.testing.assert_array_equal(ai[0, :nrows].reshape(-1, ch),
                                  np.broadcast_to(chunk_tile[:, None],
                                                  (chunk_tile.size, ch)))


def test_prepartition_matches_jax():
    grid = (256, 48, 40)
    ppu = 64.0
    pos, w, r = _mixed(60, 123, grid, ppu, dense=6)
    w[::41] = 0.0        # trash: zero weight
    pos[1] = (-2.0, 0.1, 0.1)  # trash: footprint off-grid
    jp = jsp.prepartition(jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r),
                          ppu, grid)
    tp = sc.prepartition(_t(pos), _t(w), _t(r), ppu, grid)
    np.testing.assert_array_equal(tp.key.numpy(), np.asarray(jp.key))
    np.testing.assert_array_equal(tp.pos_px.numpy(), np.asarray(jp.pos_px))
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.rpx.numpy(), np.asarray(jp.rpx))
    assert tp.wtabs == jp.wtabs and tp.kbases == jp.kbases
    assert (tp.dense_off, tp.n_huge) == (jp.dense_off, jp.n_huge)
    assert tp.max_rpx == pytest.approx(jp.max_rpx)


def test_engine_matches_jax_oracle_all_buckets_periodic():
    grid = (48, 40, 44)
    ppu = 48.0
    box = tuple(g / ppu for g in grid)
    pos, w, r = _mixed(14, 5, grid, ppu, dense=3)
    jp, jw, jr = jghosts.augment_points_periodic(pos, w, r, box)
    want = joracle(jp, jw, jr, ppu, grid)
    tp, tw, tr = tghosts.augment_points_periodic(pos, w, r, box)
    launches = (_launches("splat.align"), _launches("splat.deposit"))
    got = sc.splat_volume(tp, tw, tr, ppu, grid)
    assert (_launches("splat.align"),
            _launches("splat.deposit")) == launches  # plain
    part = sc.prepartition(tp, tw, tr, ppu, grid)
    assert all(t[-1] > t[0] for t in part.wtabs) and part.n_huge > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL + _quantum_atol(jw, jr * ppu))


def test_engine_matches_jax_pallas_engine_g8():
    """The case of test_splat_pallas.test_deposit_align_kernel_smoke_g8:
    the port engine against the JAX engine (Pallas interpret mode)."""
    rng = _rng(7)
    n, ppu = 12, 8.0
    grid = (16, 12, 16)
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = ((2.1 + rng.random(n) * 0.8) / ppu).astype(np.float32)
    want = np.asarray(jsp.splat_volume(pos, w, r, ppu, grid, interpret=True))
    got = sc.splat_volume(_t(pos), _t(w), _t(r), ppu, grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_partition_from_jax_drives_engine():
    grid = (40, 36, 40)
    ppu = 40.0
    pos, w, r = _mixed(10, 77, grid, ppu, dense=2)
    jp = jsp.prepartition(jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r),
                          ppu, grid)
    part = interop.partition_from_jax(
        np.asarray(jp.pos_px), np.asarray(jp.w), np.asarray(jp.rpx),
        np.asarray(jp.key), jp.grid, jp.wtabs, jp.kbases, jp.dense_off,
        jp.n_huge, jp.max_rpx, device="cpu")
    assert part.key.dtype == torch.int32 and part.pos_px.dtype == torch.float32
    got = sc.splat_volume(part, None, None, ppu, grid)
    want = joracle(pos, w, r, ppu, grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL + _quantum_atol(w, r * ppu))
    with pytest.raises(ValueError, match="grid"):
        sc.splat_volume(part, None, None, ppu, (40, 36, 41))


def test_particles_to_device():
    pos = np.zeros((3, 3), np.float64)
    tp, tw, tr = interop.particles_to_device(pos, [1, 2, 3], np.ones(3), "cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in (tp, tw, tr))


def test_wrappers_reject_unsupported_devices_and_shapes():
    """For tensors not on the CPU the wrappers launch the kernel or raise;
    they never fall back to the plain version."""
    meta = torch.device("meta")
    z = torch.zeros(4, dtype=torch.int32, device=meta)
    f = torch.zeros((sc.NF, 8), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sc.align(z, z, z, f, sc.G8.CH, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        sc.deposit(f, 0, torch.zeros((4, 4, 4), device=meta), sc.G8)
    with pytest.raises(ValueError, match="one device"):
        sc.align(torch.zeros(4, dtype=torch.int32), z, z, f, sc.G8.CH, 0)
    with pytest.raises(ValueError, match="different devices"):
        sc.deposit(f, 0, torch.zeros((4, 4, 4)), sc.G8)
    with pytest.raises(ValueError, match="attrs"):
        sc.deposit(torch.zeros((sc.NF, 8)), 1, torch.zeros((4, 4, 4)), sc.G8)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing nvcc is an error naming the build command, not a fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc .*-gencode arch=compute_90a"):
        _build.build(out_dir=tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()
