"""Splat tile engine: the volume render's kernels on an NVIDIA Hopper GPU.

PyTorch/CUDA port of :mod:`nbodyhpc_tpu.ops.splat_pallas`. Per radius
bucket the pipeline is:

1. **Fused partition** (:func:`prepartition`). Positions and radii are scaled
   to pixel units once and materialized; every particle gets one key, the
   (radius class, tile) pair of the tile containing its footprint window base
   ``ceil(p - (F/2 + 0.5))``. One stable ``torch.sort`` of the key plus one
   gather groups the whole set by class, then by tile. The key is computed
   once and carried; nothing downstream recomputes it from positions.
2. **Channels** (:func:`_prep_body`): the bucket's slice becomes a structure
   of arrays — float32 ``[8, n]`` (px py pz rpx w_norm w_raw is_sub spare)
   and int32 ``[4, n]`` (tile bx_ext bz_ext by_local) — plus per-tile
   ``starts``/``cnts`` and CH-aligned offsets ``aoff``. Today's deposit
   reads only the float channels; the int channels (tile-local window
   bases) are what a shared-memory tile accumulator will address by.
3. **Align** (:func:`align`, kernel ``csrc/splat_align.cu``): the ragged
   per-tile runs are copied to CH-aligned offsets and each tile's last chunk
   is padded with inert rows, so every CH-row chunk holds one tile.
4. **Deposit** (:func:`deposit`, kernel ``csrc/splat_deposit.cu``): one CUDA
   block per real chunk walks each particle's covered columns (not its whole
   F^3 window), decides interior and exterior voxels without the subcell
   loop, and adds each aligned group of 4 z-voxels with one float4 atomic
   straight into the logical (gx, gy, gz) volume, dropping voxels outside
   the grid.

Radii above the last bucket (15 px) take the dense pass
(:mod:`.splat_dense`) on the partition's tail.

The deposit writes the logical volume directly, so there is no tile-major
buffer and no counterpart of the JAX engine's ``_unpack_tiles`` halo fold.
Not ported either, being TPU or TPU-host artefacts: the HBM x-window plan and
its carry strips, lag-token pacing, ``_fold_geom``, ``_vma_of``, the stage
tracer, the bf16x3 MXU lane expansion, the lane-packing fields of the bucket
geometry, the ``_quant_rows`` shape ladder, batching and the deposit
ablation switch.

Each kernel wrapper runs its plain PyTorch version (:func:`align_reference`,
:func:`deposit_reference`) for tensors on the CPU, and for CUDA tensors
launches the kernel or raises. Each counts its kernel launches under the
counter ``splat.<kernel>.launches`` (:func:`..utils.profiling.count`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..utils import profiling
from .splat import FOUR_THIRDS_PI, as_f32, footprint_terms
from .splat_dense import splat_volume_dense

TX, TZ = 128, 64  # tile extent in x and z (y extent: the bucket's YTILE)
NF = 8            # float channels: px py pz rpx w_norm w_raw is_sub spare
NI = 4            # int channels: tile bx_ext bz_ext by_local
MAX_SUBSAMPLE = 16  # largest subsample factor the deposit kernel takes


class _Geom(NamedTuple):
    """Radius-bucket geometry: footprint window F per axis, y voxels per
    tile, x/z halo width of the tile-local bases, the pixel-radius interval
    (RMIN, RMAX] the bucket deposits, and CH, the rows of one aligned chunk
    (one deposit block)."""

    F: int
    YTILE: int
    HALO: int
    RMIN: float
    RMAX: float
    CH: int = 256


# The radius ladder of the JAX engine (splat_pallas.py:155-164). Window F
# covers the reference's point size 2*ceil(r) + 2, so bucket b covers
# r <= F/2 - 1. Sub-pixel particles (r < 0.5) ride the first bucket.
G6 = _Geom(F=6, YTILE=120, HALO=8, RMIN=-1.0, RMAX=2.0, CH=640)
G8 = _Geom(F=8, YTILE=120, HALO=8, RMIN=2.0, RMAX=3.0)
G10 = _Geom(F=10, YTILE=112, HALO=16, RMIN=3.0, RMAX=4.0, CH=384)
G12 = _Geom(F=12, YTILE=112, HALO=16, RMIN=4.0, RMAX=5.0, CH=640)
G16 = _Geom(F=16, YTILE=112, HALO=16, RMIN=5.0, RMAX=7.0)
G32 = _Geom(F=32, YTILE=96, HALO=32, RMIN=7.0, RMAX=15.0, CH=128)
BUCKETS = (G6, G8, G10, G12, G16, G32)


def bucket_ladder(max_rpx: float):
    """The contiguous bucket prefix covering radii up to ``max_rpx``. Radii
    above ``BUCKETS[-1].RMAX`` take the dense pass."""
    out = []
    for g in BUCKETS:
        out.append(g)
        if max_rpx <= g.RMAX:
            break
    return tuple(out)


def _grid_pad(g, geom=G8):
    gx, gy, gz = g
    yt = geom.YTILE
    return (
        (gx + TX - 1) // TX * TX,
        (gy + yt - 1) // yt * yt,
        (gz + TZ - 1) // TZ * TZ,
    )


def _ntiles(grid, geom=G8):
    gxp, gyp, gzp = _grid_pad(grid, geom)
    return (gxp // TX) * (gyp // geom.YTILE) * (gzp // TZ)


def _radius_class(rpx):
    """Radius class along the ladder: 0..len(BUCKETS)-1 for the kernel
    buckets, len(BUCKETS) for the dense tail."""
    cls = torch.zeros(rpx.shape, dtype=torch.int32, device=rpx.device)
    for g in BUCKETS:
        cls += rpx > g.RMAX
    return cls


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _pair_keys(ppx, rpx, w, grid, geom=G8):
    """[N] tile keys (``ntiles`` = ineligible), plus the window base
    ``b = ceil(ppx - (F/2 + 0.5))`` (int32 [N, 3]).

    Each particle belongs to exactly one tile: the one containing its
    (clamped) window base. Only radii in the bucket's (RMIN, RMAX] interval
    (plus sub-pixel particles for the base bucket) with a non-zero weight
    and a window not entirely off-grid are eligible, so the buckets
    partition the particle set. Off-grid spill is discarded at deposit time,
    as the reference clips it."""
    F, HALO, YT = geom.F, geom.HALO, geom.YTILE
    gxp, gyp, gzp = _grid_pad(grid, geom)
    nty, ntz = gyp // YT, gzp // TZ
    ntiles = (gxp // TX) * nty * ntz

    b = torch.ceil(ppx - (F / 2 + 0.5)).to(torch.int32)  # [N, 3]
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    tx = _floordiv(bx.clamp(0, gxp - 1), TX)
    ty0 = _floordiv(by.clamp(0, gyp - 1), YT)
    tz = _floordiv(bz.clamp(0, gzp - 1), TZ)

    in_bucket = (rpx > geom.RMIN) & (rpx <= geom.RMAX)
    if geom.RMIN < 0.5:
        in_bucket = in_bucket | (rpx < 0.5)  # sub-pixel rides the base bucket
    eligible = (
        (w != 0.0)
        & in_bucket
        & (bx >= -HALO) & (bx < gxp)
        & (bz >= -HALO) & (bz < gzp)
        & (by >= -F) & (by < gyp)
    )
    tid0 = (tx * nty + ty0) * ntz + tz
    key0 = torch.where(eligible, tid0, ntiles).to(torch.int32)
    return key0, b


def _fused_bases(grid):
    """Key space of the fused partition: per-bucket base key, then the
    dense-tail key, then the trash key (ineligible kernel-class particles:
    zero weight or footprint entirely off-grid)."""
    bases = []
    base = 0
    for g in BUCKETS:
        bases.append(base)
        base += _ntiles(grid, g)
    return bases, base, base + 1


def _fused_boundaries(grid):
    """Boundary keys of the partition: for each bucket the key at the start
    of each of its x-tile slabs (tile ids are x-major), then the dense-tail
    key and the trash key."""
    bases, dense_key, trash_key = _fused_bases(grid)
    vals = []
    for g, base in zip(BUCKETS, bases):
        gxp, gyp, gzp = _grid_pad(grid, g)
        m = (gyp // g.YTILE) * (gzp // TZ)
        for xt in range(gxp // TX):
            vals.append(base + xt * m)
    vals.append(dense_key)
    vals.append(trash_key)
    return vals


class FusedPartition(NamedTuple):
    """A particle set sorted by the fused (radius class, tile) key — the
    analog of the reference's CPU vertex pre-processing
    (vertex_utilities.cpp:7-43). Build with :func:`prepartition` (or
    :func:`nbodyhpc_tpu_torch.interop.partition_from_jax`) and pass it to
    :func:`splat_volume` in place of ``positions``."""

    pos_px: torch.Tensor  # [N, 3] float32 positions, pixel units, sorted
    w: torch.Tensor       # [N] float32 weights (trash rows zeroed)
    rpx: torch.Tensor     # [N] float32 radii, pixel units
    key: torch.Tensor     # [N] int32 fused key, ascending
    grid: tuple           # (gx, gy, gz) the partition was built for
    wtabs: tuple          # per bucket: first row of each x-tile slab, + end
    kbases: tuple         # per bucket: key base in the fused key space
    dense_off: int        # first row of the dense (> last rung) tail
    n_huge: int           # dense-tail population (excludes trash)
    max_rpx: float        # max pixel radius over the whole set


def _fused_partition(ppx, w, rpx, grid):
    """One stable sort by the combined (radius class, tile) key; returns the
    sorted (positions, weights, radii, key) and the row offsets of every
    :func:`_fused_boundaries` key. Trash rows keep their slot with weight 0.
    """
    bases, dense_key, trash_key = _fused_bases(grid)
    key0 = torch.full((ppx.shape[0],), -1, dtype=torch.int32,
                      device=ppx.device)
    for g, base in zip(BUCKETS, bases):
        kg, _ = _pair_keys(ppx, rpx, w, grid, g)
        key0 = torch.where(kg < _ntiles(grid, g), base + kg, key0)
    cls = _radius_class(rpx)
    key0 = torch.where(
        key0 < 0,
        torch.where(cls == len(BUCKETS), dense_key, trash_key).to(torch.int32),
        key0,
    )
    key, perm = torch.sort(key0, stable=True)
    ww = torch.where(key >= trash_key, 0.0, w[perm])
    bvals = torch.tensor(_fused_boundaries(grid), dtype=torch.int32,
                         device=ppx.device)
    offs = torch.searchsorted(key, bvals, out_int32=True)
    return ppx[perm], ww, rpx[perm], key, offs


def prepartition(positions, weights, radii, pixels_per_unit, grid):
    """Fused-partition particles for :func:`splat_volume` (see
    :class:`FusedPartition`), on the positions' device. Scaling to pixel
    units is materialized here, so every later window base is the single
    rounding ``ceil(ppx - C)`` — the tile keys and the deposit kernel's
    in-kernel bases agree bit for bit."""
    with profiling.span("nbodyhpc.render.partition"):
        return _prepartition(positions, weights, radii, pixels_per_unit, grid)


def _prepartition(positions, weights, radii, pixels_per_unit, grid):
    grid3 = tuple(int(v) for v in grid)
    positions = as_f32(positions)
    dev = positions.device
    n = positions.shape[0]
    ppx = positions * pixels_per_unit
    rpx = as_f32(radii, dev) * pixels_per_unit
    pos_c, w_c, r_c, key_c, offs = _fused_partition(
        ppx, as_f32(weights, dev), rpx, grid3
    )
    fo = offs.tolist() + [n]
    max_rpx = float(rpx.max()) if n else 0.0
    kbases, _, _ = _fused_bases(grid3)
    wtabs, cum = [], 0
    for g in BUCKETS:
        ntx_g = _grid_pad(grid3, g)[0] // TX
        wtabs.append(tuple(fo[cum:cum + ntx_g + 1]))
        cum += ntx_g
    return FusedPartition(
        pos_px=pos_c, w=w_c, rpx=r_c, key=key_c, grid=grid3,
        wtabs=tuple(wtabs), kbases=tuple(kbases), dense_off=fo[cum],
        n_huge=fo[cum + 1] - fo[cum], max_rpx=max_rpx,
    )


def _prep_body(pos_px, w, rpx, key, grid, geom=G8):
    """Channel derivation of one bucket's tile-sorted rows.

    ``key``: the rows' tile keys in the bucket's own numbering, ascending;
    keys outside [0, ntiles) mark rows no tile covers (zero weight, unit
    radius). Returns ``srcf`` float32 [8, n], ``srci`` int32 [4, n] and the
    per-tile ``starts``, ``cnts`` and CH-aligned ``aoff``, int32 [ntiles].
    """
    F, HALO, YTILE = geom.F, geom.HALO, geom.YTILE
    gxp, gyp, gzp = _grid_pad(grid, geom)
    nty, ntz = gyp // YTILE, gzp // TZ
    ntiles = (gxp // TX) * nty * ntz
    dev = pos_px.device
    px, py, pz = pos_px[:, 0], pos_px[:, 1], pos_px[:, 2]

    invalid = (key >= ntiles) | (key < 0)
    tile = key.clamp(0, ntiles - 1)
    ww = torch.where(invalid, 0.0, w)
    rr = torch.where(invalid, 1.0, rpx)

    tz = torch.remainder(tile, ntz)
    ty = torch.remainder(_floordiv(tile, ntz), nty)
    tx = _floordiv(tile, ntz * nty)

    C = F / 2 + 0.5
    bx = torch.ceil(px - C).to(torch.int32)
    by = torch.ceil(py - C).to(torch.int32)
    bz = torch.ceil(pz - C).to(torch.int32)

    is_sub = rr < 0.5
    vol = FOUR_THIRDS_PI * rr * rr * rr
    w_norm = torch.where(is_sub, 0.0, ww / torch.where(is_sub, 1.0, vol))
    w_raw = torch.where(is_sub, ww, 0.0)

    bx_ext = torch.where(invalid, HALO, bx - tx * TX + HALO)
    bz_ext = torch.where(invalid, HALO, bz - tz * TZ + HALO)
    by_loc = torch.where(invalid, 0, by - ty * YTILE)

    srcf = torch.stack([px, py, pz, rr, w_norm, w_raw, is_sub.float(),
                        torch.zeros_like(px)])
    srci = torch.stack([tile, bx_ext, bz_ext, by_loc]).to(torch.int32)

    starts = torch.searchsorted(
        key, torch.arange(ntiles + 1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    cnts = torch.diff(starts)
    aligned = (cnts + geom.CH - 1) // geom.CH * geom.CH
    aoff = torch.cumsum(aligned, 0, dtype=torch.int32) - aligned
    return srcf, srci, starts[:-1].contiguous(), cnts, aoff


# ---------------------------------------------------------------------------
# B1: align
# ---------------------------------------------------------------------------


def align_reference(starts, cnts, aoff, srcf, srci, ch: int, halo: int,
                    nrows: int):
    """Plain version of the align kernel: tile t's rows
    ``[starts[t], starts[t] + cnts[t])`` of ``srcf``/``srci`` go to
    ``[aoff[t], aoff[t] + cnts[t])``, and the rows up to the next multiple
    of ``ch`` become inert pads (float 0; int tile=t, halo, halo, 0).
    ``nrows`` is the total aligned row count."""
    dev = srcf.device
    ntiles = starts.shape[0]
    aligned = (cnts.long() + ch - 1) // ch * ch
    tile = torch.repeat_interleave(
        torch.arange(ntiles, device=dev), aligned, output_size=nrows
    )
    local = torch.arange(nrows, device=dev) - aoff.long()[tile]
    real = local < cnts.long()[tile]
    src = torch.where(real, starts.long()[tile] + local, 0)
    dstf = torch.where(real, srcf[:, src], 0.0)
    pad = torch.stack([tile, torch.full_like(tile, halo),
                       torch.full_like(tile, halo), torch.zeros_like(tile)])
    dsti = torch.where(real, srci[:, src].long(), pad).to(torch.int32)
    return dstf, dsti


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def align(starts, cnts, aoff, srcf, srci, ch: int, halo: int, nrows: int):
    """Aligned copy of the tile-sorted stream (see :func:`align_reference`).

    Kernel ``csrc/splat_align.cu`` for CUDA tensors; replaces
    ``nbodyhpc_tpu/ops/splat_pallas.py::_align_kernel``. Bound by memory
    bandwidth (12 x 4 bytes in and out per row); one block per tile, rows
    coalesced across threads. Returns (dstf float32 [8, nrows], dsti int32
    [4, nrows]).
    """
    dev = srcf.device
    _require(
        all(t.device == dev for t in (starts, cnts, aoff, srci)),
        "align: all tensors must be on one device",
    )
    if dev.type == "cpu":
        return align_reference(starts, cnts, aoff, srcf, srci, ch, halo,
                               nrows)
    _require(dev.type == "cuda", f"align: unsupported device {dev}")
    ntiles = starts.shape[0]
    for name, t, dt in (("starts", starts, torch.int32),
                        ("cnts", cnts, torch.int32),
                        ("aoff", aoff, torch.int32),
                        ("srcf", srcf, torch.float32),
                        ("srci", srci, torch.int32)):
        _require(t.dtype == dt, f"align: {name} must be {dt}, got {t.dtype}")
        _require(t.is_contiguous(), f"align: {name} must be contiguous")
    _require(starts.shape == cnts.shape == aoff.shape == (ntiles,),
             "align: starts/cnts/aoff must be [ntiles]")
    _require(srcf.dim() == 2 and srcf.shape[0] == NF
             and srci.shape == (NI, srcf.shape[1]),
             "align: srcf must be [8, n] and srci [4, n]")
    dstf = torch.empty((NF, nrows), dtype=torch.float32, device=dev)
    dsti = torch.empty((NI, nrows), dtype=torch.int32, device=dev)
    if nrows == 0 or ntiles == 0:
        return dstf, dsti
    lib = _build.load().lib
    err = lib.splat_align(
        starts.data_ptr(), cnts.data_ptr(), aoff.data_ptr(), srcf.data_ptr(),
        srci.data_ptr(), dstf.data_ptr(), dsti.data_ptr(), ntiles,
        srcf.shape[1], nrows, ch, halo, _stream(srcf),
    )
    profiling.count("splat.align.launches")
    _build.check(err, "splat_align launch")
    return dstf, dsti


# ---------------------------------------------------------------------------
# B2: deposit
# ---------------------------------------------------------------------------


def _deposit_chunk_rows(F: int, subsample: int) -> int:
    """Particles per plain-version evaluation: bounds the (rows, F, F, F, S)
    subcell transient to ~4M elements."""
    return max(1, min(4096, (1 << 22) // (F**3 * subsample)))


def deposit_reference(attrs, nchunks: int, vol, geom: _Geom,
                      subsample: int = 4):
    """Plain version of the deposit kernel, built on the oracle's
    :func:`.splat.footprint_terms`: every particle of the first
    ``nchunks * geom.CH`` rows of the aligned stream ``attrs`` (float32
    [8, rows]) deposits its F^3 window at ``ceil(p - (F/2 + 0.5))`` into
    ``vol`` (gx, gy, gz), in place; voxels outside the grid are dropped.
    Returns ``vol``."""
    F = geom.F
    gx, gy, gz = vol.shape
    a = attrs[:, :nchunks * geom.CH]
    a = a[:, (a[4] != 0.0) | (a[5] != 0.0)]  # pads deposit nothing
    ppx = a[0:3].T
    base = torch.ceil(ppx - (F / 2 + 0.5)).to(torch.int32)
    off = torch.arange(F, dtype=torch.int64, device=vol.device)
    flat_vol = vol.view(-1)
    step = _deposit_chunk_rows(F, subsample)
    for s in range(0, a.shape[1], step):
        e = s + step
        overlap, cover, sub = footprint_terms(ppx[s:e], a[3, s:e], base[s:e],
                                              F, subsample)
        wn = a[4, s:e, None, None, None]
        wr = a[5, s:e, None, None, None]
        is_sub = a[6, s:e, None, None, None] > 0.5
        vals = torch.where(is_sub, wr * sub, (wn * overlap) * cover)
        b = base[s:e].long()
        vx = b[:, 0:1] + off
        vy = b[:, 1:2] + off
        vz = b[:, 2:3] + off
        ok = (((vx >= 0) & (vx < gx))[:, :, None, None]
              & ((vy >= 0) & (vy < gy))[:, None, :, None]
              & ((vz >= 0) & (vz < gz))[:, None, None, :])
        flat = ((vx[:, :, None, None] * gy + vy[:, None, :, None]) * gz
                + vz[:, None, None, :])
        flat_vol.index_add_(0, flat[ok], vals[ok])
    return vol


def deposit(attrs, nchunks: int, vol, geom: _Geom, subsample: int = 4):
    """Deposit the first ``nchunks`` aligned chunks of ``attrs`` into ``vol``
    in place (see :func:`deposit_reference`); returns ``vol``.

    Kernel ``csrc/splat_deposit.cu`` for CUDA tensors; replaces
    ``nbodyhpc_tpu/ops/splat_pallas.py::_deposit_kernel``. Its least time
    is bound by bytes (28 per attribute row, 8 per voxel it changes); the
    kernel spends its time on instructions per gated voxel, so it visits
    only each particle's covered box, skips the S^3 subcell loop where the
    answer is all or nothing, and adds float4 groups. One block per chunk,
    so each block's atomics stay inside one tile of the volume.
    """
    dev = attrs.device
    _require(vol.device == dev, "deposit: attrs and vol on different devices")
    _require(vol.dtype == torch.float32 and vol.dim() == 3
             and vol.is_contiguous(),
             "deposit: vol must be a contiguous float32 (gx, gy, gz) tensor")
    _require(attrs.dtype == torch.float32 and attrs.dim() == 2
             and attrs.shape[0] == NF
             and attrs.shape[1] >= nchunks * geom.CH,
             "deposit: attrs must be float32 [8, >= nchunks * CH]")
    if dev.type == "cpu":
        return deposit_reference(attrs, nchunks, vol, geom, subsample)
    _require(dev.type == "cuda", f"deposit: unsupported device {dev}")
    _require(attrs.is_contiguous(), "deposit: attrs must be contiguous")
    _require(1 <= subsample <= MAX_SUBSAMPLE,
             f"deposit: subsample must be in [1, {MAX_SUBSAMPLE}]")
    _require(geom in BUCKETS, f"deposit: unknown bucket geometry {geom}")
    if nchunks == 0:
        return vol
    gx, gy, gz = vol.shape
    lib = _build.load().lib
    err = lib.splat_deposit(
        attrs.data_ptr(), attrs.shape[1], nchunks, geom.CH, geom.F,
        subsample, vol.data_ptr(), gx, gy, gz, _stream(attrs),
    )
    profiling.count("splat.deposit.launches")
    _build.check(err, "splat_deposit launch")
    return vol


# ---------------------------------------------------------------------------
# the render
# ---------------------------------------------------------------------------


def bucket_stream(part: FusedPartition, bi: int):
    """Bucket ``bi``'s aligned stream: returns (attrs float32 [8, rows],
    ints int32 [4, rows], nchunks), or None when the bucket is empty. One
    device sync (the aligned row count)."""
    geom = BUCKETS[bi]
    r0, r1 = part.wtabs[bi][0], part.wtabs[bi][-1]
    if r1 == r0:
        return None
    srcf, srci, starts, cnts, aoff = _prep_body(
        part.pos_px[r0:r1], part.w[r0:r1], part.rpx[r0:r1],
        part.key[r0:r1] - part.kbases[bi], part.grid, geom,
    )
    nchunks = int(((cnts + geom.CH - 1) // geom.CH).sum())
    alf, ali = align(starts, cnts, aoff, srcf, srci, geom.CH, geom.HALO,
                     nchunks * geom.CH)
    return alf, ali, nchunks


def splat_volume(positions, weights, radii, pixels_per_unit: float, grid,
                 subsample: int = 4, vol0=None) -> torch.Tensor:
    """Render a 3D density field with the tile engine.

    Same semantics as :func:`.splat.splat_volume_oracle` (non-periodic or
    pre-augmented particles). ``positions`` may be a :class:`FusedPartition`
    (``weights``/``radii`` then unused) to keep the partition sort out of
    repeated renders. Returns the (gx, gy, gz) float32 field on the
    particles' device: the kernels on a CUDA device, their plain versions
    on the CPU. With ``vol0`` (a contiguous float32 (gx, gy, gz) tensor on
    that device) the particles are added onto it, in place where the dense
    pass allows (see :func:`.splat_dense.splat_volume_dense`).
    """
    grid3 = tuple(int(v) for v in grid)
    if isinstance(positions, FusedPartition):
        part = positions
        if tuple(part.grid) != grid3:
            raise ValueError(f"FusedPartition built for grid {part.grid}, "
                             f"render asked for {grid3}")
    else:
        part = prepartition(positions, weights, radii, pixels_per_unit, grid3)
    vol = (torch.zeros(grid3, dtype=torch.float32, device=part.pos_px.device)
           if vol0 is None else vol0)
    with profiling.span("nbodyhpc.render.buckets"):
        for bi, geom in enumerate(BUCKETS):
            stream = bucket_stream(part, bi)
            if stream is not None:
                deposit(stream[0], stream[2], vol, geom, subsample)
                profiling.count("render.chunks", stream[2])
    profiling.count("render.dense_rows", part.n_huge)
    if part.n_huge:
        sl = slice(part.dense_off, part.dense_off + part.n_huge)
        with profiling.span("nbodyhpc.render.dense"):
            vol = splat_volume_dense(
                part.pos_px[sl], part.w[sl], part.rpx[sl], grid3, subsample,
                vol0=vol, max_radius_px=part.max_rpx,
            )
    return vol
