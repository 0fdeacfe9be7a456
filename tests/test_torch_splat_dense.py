"""The port's dense kernel (``csrc/splat_dense.cu``) fills a column's
interior run of a sphere without counting its voxels. The geometry that
rule rests on, against the port's ``footprint_values`` on the CPU.

Along one column of one z tile, for rows of 15-45 px placed near the
kernel's tile faces:

* the voxels whose value is exactly the row's factor form one interval;
* the kernel's interior test (``splat::interior``: the first and the last
  subcell offsets alone) holds on one interval of the walked slices, and
  every exact voxel lies inside it;
* where the exact voxels hold both ends of that interval, they are all of
  it: the gates pass on the whole run when they pass at its ends, so the
  run may be filled with the factor by plain adds;
* the kernel's guess of the run's ends from ``sqrtf(rab_lo)`` lies within
  the exact tests ``run_end`` may take, so the run is found on nearly every
  column that has one (elsewhere the kernel counts every slice).

The card tests of ``test_torch_kernels_cuda.py`` hold the kernel itself to
the plain pass.
"""
import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch.ops import splat as ts

TZ = 64  # kTZ of csrc/splat_dense.cu: a tile's extent in z
# run_end (csrc/splat_dense.cu) from its guess b: with b interior it tests
# b, b - 1, b - 2 as the low end (kEndSteps = 3 tests); with b outside it
# tests b + 1, b + 2, b + 3; the high end mirrors it
INSIDE_REACH, OUTSIDE_REACH = 2, 3


def _column_rows(p, r, vx, vy, S):
    """The kernel's per-column quantities (splat::column_rows and the row
    walk of dense_kernel) in float32: rab_lo, rab_hi, ulo, uhi."""
    u = (torch.arange(S, dtype=torch.float32) + 0.5) / S
    ax = (p[0] - vx.to(torch.float32))[:, None] - u
    ay = (p[1] - vy.to(torch.float32))[:, None] - u
    ax, ay = ax * ax, ay * ay
    r2 = r * r
    rab_lo = r2 - (ax.max(1).values + ay.max(1).values)
    rab_hi = r2 - (ax.min(1).values + ay.min(1).values)
    return rab_lo, rab_hi, u[0], u[S - 1]


def _ends(mask, vz):
    """Each row's least and greatest ``vz`` where ``mask`` holds, and
    whether it holds anywhere."""
    any_ = mask.any(1)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(mask, vz, big).min(1).values
    hi = torch.where(mask, vz, -big).max(1).values
    return lo, hi, any_


def _intervals(mask):
    """Whether each row of ``mask`` holds on one interval (or nowhere)."""
    rises = (mask[:, 1:] & ~mask[:, :-1]).sum(1) + mask[:, 0]
    return rises <= 1


@pytest.mark.parametrize("subsample", [4, 3])
def test_dense_kernel_run_rule_matches_footprint(subsample):
    rng = np.random.Generator(np.random.Philox(41 + subsample))
    pairs = taken = fallback = 0
    for _ in range(6):
        r = torch.tensor(rng.uniform(15.0, 45.0), dtype=torch.float32)
        xy = rng.uniform(0.0, 200.0, 2)
        z = TZ * rng.integers(1, 4) + rng.uniform(-float(r), float(r))
        p = torch.tensor([*xy, z], dtype=torch.float32)
        w = torch.tensor([rng.uniform(0.5, 1.5)], dtype=torch.float32)
        R = ts.required_halfwidth(float(r))
        base, vals = ts.footprint_values(p[None], w, r[None], R, subsample)
        fac = w / (ts.FOUR_THIRDS_PI * (r * r * r))
        F = 2 * R + 1
        exact = (vals[0] == fac).reshape(F * F, F)  # (column, z)
        off = torch.arange(F)
        vx = (base[0, 0] + off)[:, None].expand(F, F).reshape(-1)
        vy = (base[0, 1] + off)[None, :].expand(F, F).reshape(-1)
        vz = (base[0, 2] + off)[None, :].expand(F * F, F)
        assert bool(_intervals(exact).all())

        rab_lo, rab_hi, ulo, uhi = _column_rows(p, r, vx, vy, subsample)
        dz = p[2] - vz.to(torch.float32)
        a, b = dz - ulo, dz - uhi
        interior = (torch.maximum(a * a, b * b) < rab_lo[:, None])
        assert not bool((exact & ~interior).any())
        s = torch.sqrt(torch.clamp_min(rab_lo, 0.0))
        ze = torch.ceil(torch.sqrt(torch.clamp_min(rab_hi, 0.0))).long() + 3
        fz = int(torch.floor(p[2]))
        for tz in range(int(vz[0, 0]) // TZ, int(vz[0, -1]) // TZ + 1):
            # the walk of dense_kernel: slices [zl, zh] of the tile
            zl = torch.clamp_min(fz - ze.clamp_max(R), tz * TZ)[:, None]
            zh = torch.clamp_max(fz + ze.clamp_max(R), tz * TZ + TZ - 1)
            zh = zh[:, None]
            walked = (vz >= zl) & (vz <= zh) & (rab_hi > 0)[:, None]
            in_tile = (vz >= tz * TZ) & (vz < tz * TZ + TZ)
            assert not bool((exact & in_tile & ~walked).any())
            run = interior & walked & (rab_lo > 0)[:, None]
            assert bool(_intervals(run).all())
            lo, hi, has = _ends(run, vz)
            want = exact & walked
            at = torch.stack([lo, hi], 1) - vz[:, :1]
            at_ends = want.gather(1, at.clamp(0, F - 1)).all(1)
            fill = has & at_ends
            assert torch.equal(want[fill], run[fill])

            # interior_run's guess, then run_end's reach from it
            ga = torch.maximum(torch.floor((p[2] - ulo) - s).long() + 1,
                               zl[:, 0])
            gb = torch.minimum(torch.ceil((p[2] - uhi) + s).long() - 1,
                               zh[:, 0])
            reach_lo = torch.where(ga < lo, lo - ga <= OUTSIDE_REACH,
                                   (ga <= hi) & (ga - lo <= INSIDE_REACH))
            reach_hi = torch.where(gb > hi, gb - hi <= OUTSIDE_REACH,
                                   (gb >= lo) & (hi - gb <= INSIDE_REACH))
            found = fill & (ga <= gb) & reach_lo & reach_hi
            pairs += int((rab_hi > 0).sum())
            taken += int(found.sum())
            fallback += int((want.any(1) & ~found).sum())
    assert pairs >= 2000
    # the run is found on nearly every column that holds an exact voxel
    assert fallback <= 0.01 * (taken + fallback), (taken, fallback)
