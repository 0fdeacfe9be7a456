"""The deposit kernel's shortcuts (``csrc/splat_deposit.cu``), pinned on the
CPU against the oracle's ``footprint_terms``.

The kernel decides most voxels without the S^3 subcell loop and visits only
a covered box of each window. A torch mirror of each step, written here the
way the kernel computes it, must reproduce the oracle exactly:

- the interior/exterior test and the sorted-row count give the oracle's
  subcell count (``overlap * S^3``) bit for bit;
- every voxel the oracle's gates admit lies in the kernel's (x, y) box, and
  along each column the admitted slices form one interval holding the
  kernel's start slice;
- a sub-pixel particle's one voxel is where the kernel puts it.

Inputs are made with numpy from a seeded Philox generator: uniform random
ones, and ones on the 1/(2S) subcell lattice, where subcell compares tie.
"""
import math

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch.ops import splat_cuda as sc
from nbodyhpc_tpu_torch.ops.splat import footprint_terms

SUBSAMPLES = (1, 2, 4, 8)


def _particles(geom, subsample, kind, seed):
    """Positions in [0, 48) px and radii in the bucket's (RMIN, RMAX]
    (non-sub-pixel), float32; "lattice" puts both on the 1/(2S) lattice."""
    n = int(min(max(2**17 // geom.F**3, 8), 256))
    rng = np.random.Generator(np.random.Philox(seed))
    lo, hi = max(geom.RMIN, 0.5), geom.RMAX
    if kind == "lattice":
        q = 2 * subsample
        pos = rng.integers(0, 48 * q, (n, 3)) / q
        m_lo = math.ceil(lo * q) if geom.RMIN < 0.5 else math.floor(lo * q) + 1
        rpx = rng.integers(m_lo, int(hi * q) + 1, n) / q
    else:
        pos = rng.uniform(0.0, 48.0, (n, 3))
        rpx = rng.uniform(lo, hi, n)
        rpx = np.where(rpx > lo, rpx, hi)
    ppx = torch.from_numpy(pos.astype(np.float32))
    r = torch.from_numpy(rpx.astype(np.float32))
    base = torch.ceil(ppx - (geom.F / 2 + 0.5)).to(torch.int32)
    return ppx, r, base


def _axis(ppx, base, F):
    off = torch.arange(F, dtype=torch.int32)
    return (base[:, :, None] + off).float()  # (C, 3, F) voxel coordinates


def _below(s, x, S):
    """The kernel's count_below: sorted values ``s`` (..., S) below ``x``."""
    if S == 4:
        b1 = s[..., 1] < x
        b2 = torch.where(b1, s[..., 2], s[..., 0]) < x
        return 2 * b1.int() + b2.int() + (b1 & b2 & (s[..., 3] < x)).int()
    base = torch.zeros(x.shape, dtype=torch.int64)
    n = S
    while n > 1:
        h = n >> 1
        probe = torch.gather(s, -1, (base + h)[..., None])[..., 0]
        base = torch.where(probe < x, base + h, base)
        n -= h
    last = torch.gather(s, -1, base[..., None])[..., 0]
    return (base + (last < x)).int()


def _kernel_count(ppx, rpx, base, F, S):
    """The kernel's subcell count per window voxel (C, F, F, F), and its
    interior and exterior masks."""
    v = _axis(ppx, base, F)
    u = (torch.arange(S, dtype=torch.float32) + 0.5) / S
    sq = []
    for d in range(3):
        t = (ppx[:, d, None] - v[:, d])[:, :, None] - u  # (C, F, S)
        sq.append(t * t)
    ax, ay, az = sq
    r2 = (rpx * rpx)[:, None, None]
    rab_lo = r2 - (ax.amax(-1)[:, :, None] + ay.amax(-1)[:, None, :])
    rab_hi = r2 - (ax.amin(-1)[:, :, None] + ay.amin(-1)[:, None, :])
    interior = az.amax(-1)[:, None, None, :] < rab_lo[..., None]
    exterior = az.amin(-1)[:, None, None, :] >= rab_hi[..., None]
    s = az.sort(-1).values[:, None, None, :, :]  # (C, 1, 1, Fz, S)
    s = s.expand(-1, F, F, -1, -1)
    count = torch.zeros(interior.shape, dtype=torch.int32)
    for a in range(S):
        for b in range(S):
            rab = r2 - (ax[:, :, a][:, :, None] + ay[:, :, b][:, None, :])
            count += _below(s, rab[..., None].expand(-1, -1, -1, F), S)
    count = torch.where(interior, S**3, torch.where(exterior, 0, count))
    return count, interior, exterior


@pytest.mark.parametrize("kind", ["random", "lattice"])
@pytest.mark.parametrize("subsample", SUBSAMPLES)
@pytest.mark.parametrize("bi", range(len(sc.BUCKETS)))
def test_shortcut_count_bit_equal_to_oracle(bi, subsample, kind):
    geom = sc.BUCKETS[bi]
    ppx, rpx, base = _particles(geom, subsample, kind, 100 + 10 * bi + subsample)
    overlap, _, _ = footprint_terms(ppx, rpx, base, geom.F, subsample)
    want = (overlap * subsample**3).round().int()
    assert torch.equal(want.float() / subsample**3, overlap)
    got, interior, exterior = _kernel_count(ppx, rpx, base, geom.F, subsample)
    assert torch.equal(got, want)
    shell = ~(interior | exterior)
    assert bool(interior.any())
    # one subcell per voxel (S = 1) leaves nothing undecided
    assert bool(shell.any()) == (subsample > 1)
    # the shortcut is what the kernel skips the loop for
    assert bool((want[interior] == subsample**3).all())
    assert bool((want[exterior] == 0).all())


def _is_interval(mask):
    """Per row of the last axis: the True entries are contiguous."""
    idx = torch.arange(mask.shape[-1])
    n = mask.sum(-1)
    first = torch.where(mask, idx, mask.shape[-1]).amin(-1)
    last = torch.where(mask, idx, -1).amax(-1)
    return (n == 0) | (last - first + 1 == n)


@pytest.mark.parametrize("kind", ["random", "lattice"])
@pytest.mark.parametrize("bi", range(len(sc.BUCKETS)))
def test_covered_box_and_z_walk_hold_every_gated_voxel(bi, kind):
    geom = sc.BUCKETS[bi]
    F = geom.F
    ppx, rpx, base = _particles(geom, 4, kind, 300 + bi)
    _, cover, _ = footprint_terms(ppx, rpx, base, F, 4)
    v = _axis(ppx, base, F)
    pz = ppx[:, 2]
    r2 = rpx * rpx
    # H: the square's half-side at the slice floor(pz) ...
    zc = pz - (torch.floor(pz) + 0.5)
    H = torch.ceil(torch.sqrt(torch.clamp_min(r2 - zc * zc, 0.0))) + 1.0
    # ... is the widest of any slice
    zoff = pz[:, None] - (v[:, 2] + 0.5)
    half = torch.ceil(torch.sqrt(torch.clamp_min(
        r2[:, None] - zoff * zoff, 0.0))) + 1.0
    assert bool((half <= H[:, None]).all())
    box = []
    for d in range(2):
        c = (v[:, d] + 0.5) - ppx[:, d, None]
        ins = (c >= -H[:, None]) & (c < H[:, None])  # (C, F)
        assert bool(_is_interval(ins).all())
        # the kernel's conservative start range holds the interval
        lo = torch.floor(ppx[:, d] - H).int() - 1
        hi = torch.ceil(ppx[:, d] + H).int() + 1
        vi = v[:, d].int()
        assert bool((~ins | ((vi >= lo[:, None]) & (vi <= hi[:, None]))).all())
        box.append(ins)
    in_box = box[0][:, :, None, None] & box[1][:, None, :, None]
    assert bool(cover.any())
    assert bool((~cover | in_box).all())
    # along each column: one interval, holding the clamped start slice
    assert bool(_is_interval(cover).all())
    zs = (torch.floor(pz).int() - base[:, 2]).clamp(0, F - 1).long()
    at_start = torch.gather(
        cover, 3, zs[:, None, None, None].expand(-1, F, F, 1))[..., 0]
    assert bool((at_start | ~cover.any(-1)).all())


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_subpixel_voxel_is_the_kernels(kind):
    rng = np.random.Generator(np.random.Philox(7))
    n = 512
    if kind == "lattice":
        pos = rng.integers(0, 48 * 8, (n, 3)) / 8
    else:
        pos = rng.uniform(0.0, 48.0, (n, 3))
    ppx = torch.from_numpy(pos.astype(np.float32))
    rpx = torch.from_numpy(rng.uniform(0.05, 0.45, n).astype(np.float32))
    F = sc.G6.F
    base = torch.ceil(ppx - (F / 2 + 0.5)).to(torch.int32)
    _, _, sub = footprint_terms(ppx, rpx, base, F, 4)
    want = torch.zeros_like(sub)
    vox = torch.stack([torch.floor(ppx[:, 0]).int(),
                       torch.floor(ppx[:, 1]).int(),
                       torch.ceil(ppx[:, 2]).int() - 1], 1) - base
    assert bool(((vox >= 0) & (vox < F)).all())
    want[torch.arange(n), vox[:, 0], vox[:, 1], vox[:, 2]] = True
    assert torch.equal(sub, want)
