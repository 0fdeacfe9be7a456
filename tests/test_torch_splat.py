"""The PyTorch port's splat oracle, periodic ghosts and dense pass against
the JAX package (CPU).

Inputs are made with numpy from a seeded Philox generator and fed to both
packages. Tolerances: below 4 px the port must match the JAX oracle exactly
up to float32 round-off (rtol 1e-6, atol 1e-7); at 4 px and above, XLA may
FMA-contract the subcell compare of the JAX side, so one S^-3 quantum per
voxel is budgeted on top (``test_splat_dense._quantum_atol``) and no more.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbodyhpc_tpu.ops import ghosts as jghosts
from nbodyhpc_tpu.ops import splat as jsplat
from nbodyhpc_tpu.ops import splat_dense as jdense
from nbodyhpc_tpu_torch.ops import ghosts as tghosts
from nbodyhpc_tpu_torch.ops import splat as tsplat
from nbodyhpc_tpu_torch.ops import splat_dense as tdense
from test_splat_dense import _quantum_atol

RTOL, ATOL = 1e-6, 1e-7


def _rng(seed):
    return np.random.Generator(np.random.Philox(seed))


def _particles(n, seed, grid, ppu, rpx_lo, rpx_hi):
    rng = _rng(seed)
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    rpx = (rpx_lo + rng.random(n) * (rpx_hi - rpx_lo)).astype(np.float32)
    return pos, w, (rpx / ppu).astype(np.float32)


def _assert_matches(got, want, w, rpx):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(
        got, np.asarray(want), rtol=RTOL, atol=ATOL + _quantum_atol(w, rpx)
    )


def test_halfwidth_ladders_match():
    for rpx in (0.0, 0.4, 2.5, 7.0, 15.5, 33.0, 300.0):
        assert tsplat.required_halfwidth(rpx) == jsplat.required_halfwidth(rpx)
        assert tdense.dense_halfwidth(rpx) == jdense.dense_halfwidth(rpx)
    assert tdense.HALF_BUCKETS == jdense.HALF_BUCKETS
    for F in (25, 41, 73, 521):
        assert tdense._default_chunk(F) == jdense._default_chunk(F)


@pytest.mark.parametrize("rpx_lo,rpx_hi,explicit_base", [
    (0.05, 3.5, False),   # sub-pixel and small: exact
    (4.0, 9.0, False),    # quantum regime
    (1.0, 6.0, True),     # shifted explicit window base
])
def test_footprint_values_match_jax(rpx_lo, rpx_hi, explicit_base):
    rng = _rng(11)
    n, R, S = 40, 12, 4
    ppx = (rng.random((n, 3)) * 30.0 + 5.0).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    rpx = (rpx_lo + rng.random(n) * (rpx_hi - rpx_lo)).astype(np.float32)
    base = None
    if explicit_base:
        base = (np.floor(ppx).astype(np.int32) - R
                + rng.integers(-2, 3, (n, 3)).astype(np.int32))
    jb, jv = jsplat.footprint_values(
        jnp.asarray(ppx), jnp.asarray(w), jnp.asarray(rpx), R, S,
        base=None if base is None else jnp.asarray(base))
    tb, tv = tsplat.footprint_values(
        torch.from_numpy(ppx), torch.from_numpy(w), torch.from_numpy(rpx), R,
        S, base=None if base is None else torch.from_numpy(base))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _assert_matches(tv, jv, w, rpx)


@pytest.mark.parametrize("grid,rpx_lo,rpx_hi,subsample", [
    ((16, 12, 20), 0.05, 3.9, 4),   # sub-pixel through G10: exact
    ((20, 20, 16), 4.0, 8.0, 4),    # quantum regime
    ((16, 16, 16), 0.3, 3.0, 2),    # non-default subsample
])
def test_volume_oracle_matches_jax(grid, rpx_lo, rpx_hi, subsample):
    ppu = float(grid[0])
    pos, w, r = _particles(60, 5, grid, ppu, rpx_lo, rpx_hi)
    want = jsplat.splat_volume_oracle(pos, w, r, ppu, grid, subsample)
    got = tsplat.splat_volume_oracle(pos, w, r, ppu, grid, subsample)
    assert got.shape == grid and got.dtype == torch.float32
    _assert_matches(got, want, w, r * ppu)


def test_volume_oracle_wrap_matches_jax():
    grid = (12, 12, 12)
    ppu = 12.0
    pos, w, r = _particles(30, 9, grid, ppu, 0.2, 3.5)
    wrap = (True, False, True)
    want = jsplat.splat_volume_oracle(pos, w, r, ppu, grid, wrap=wrap)
    got = tsplat.splat_volume_oracle(pos, w, r, ppu, grid, wrap=wrap)
    _assert_matches(got, want, w, r * ppu)


@pytest.mark.parametrize("rpx_lo,rpx_hi", [(0.05, 3.9), (4.0, 7.0)])
def test_2d_oracle_matches_jax(rpx_lo, rpx_hi):
    grid = (24, 16)
    ppu = 16.0
    rng = _rng(17)
    n = 80
    pos = np.stack([rng.random(n) * 1.5, rng.random(n),
                    (rng.random(n) - 0.5) * 0.4], 1).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    r = ((rpx_lo + rng.random(n) * (rpx_hi - rpx_lo)) / ppu).astype(np.float32)
    want = jsplat.splat_2d_oracle(pos, w, r, ppu, grid)
    got = tsplat.splat_2d_oracle(pos, w, r, ppu, grid)
    assert got.shape == grid
    _assert_matches(got, want, w, r * ppu)


@pytest.mark.parametrize("box", [(1.0, 1.0, 1.0), (1.0, -1.0, 1.0),
                                 (-1.0, -1.0, -1.0), (0.8, 1.0, 1.2)])
def test_ghosts_match_jax_row_for_row(box):
    rng = _rng(31)
    n = 400
    pos = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    r = (rng.random(n) * 0.15 + 0.01).astype(np.float32)
    hp, hw, hr = jghosts.augment_points_periodic(pos, w, r, box)
    tp, tw, tr = tghosts.augment_points_periodic(pos, w, r, box)
    np.testing.assert_array_equal(tp.numpy(), hp)
    np.testing.assert_array_equal(tw.numpy(), hw)
    np.testing.assert_array_equal(tr.numpy(), hr)


def test_ghosts_corner_chains_and_double_face():
    """Clones of clones at corners, and a 2r > L particle cloning both faces
    of one dimension, in the exact JAX order."""
    pos = np.array([
        [0.01, 0.01, 0.01],   # triple corner: 7 clones
        [0.99, 0.5, 0.02],    # edge: 3 clones
        [0.5, 0.5, 0.5],      # interior: none
        [0.5, 0.02, 0.98],    # edge: 3 clones
        [0.45, 0.5, 0.5],     # 2r > L: crosses BOTH x faces
    ], np.float32)
    r = np.array([0.05, 0.05, 0.01, 0.05, 0.6], np.float32)
    w = np.arange(1, 6, dtype=np.float32)
    hp, hw, hr = jghosts.augment_points_periodic(pos, w, r, (1.0, 1.0, 1.0))
    tp, tw, tr = tghosts.augment_points_periodic(
        torch.from_numpy(pos), torch.from_numpy(w), torch.from_numpy(r),
        (1.0, 1.0, 1.0))
    assert tp.shape == hp.shape
    np.testing.assert_array_equal(tp.numpy(), hp)
    np.testing.assert_array_equal(tw.numpy(), hw)
    np.testing.assert_array_equal(tr.numpy(), hr)


@pytest.mark.parametrize("grid,rpx_lo,rpx_hi,with_vol0", [
    ((40, 36, 40), 8.0, 18.0, False),  # clamping at the grid edges
    ((16, 12, 16), 10.0, 31.0, False),  # window larger than the grid
    ((24, 24, 24), 8.0, 12.0, True),   # accumulate onto vol0
])
def test_dense_matches_jax(grid, rpx_lo, rpx_hi, with_vol0):
    ppu = float(grid[0])
    pos, w, r = _particles(12, 7, grid, ppu, rpx_lo, rpx_hi)
    vol0 = None
    if with_vol0:
        vol0 = np.asarray(jsplat.splat_volume_oracle(pos, w, r * 0.1, ppu,
                                                     grid), np.float32)
    want = jdense.splat_volume_dense(
        pos * ppu, w, r * ppu, grid,
        vol0=None if vol0 is None else jnp.asarray(vol0))
    got = tdense.splat_volume_dense(
        pos * ppu, w, r * ppu, grid,
        vol0=None if vol0 is None else torch.from_numpy(vol0.copy()))
    assert got.shape == grid
    # same footprint function, same particle order: only XLA's contraction
    # of the JAX side can differ, by at most the quantum
    _assert_matches(got, want, w, r * ppu)
