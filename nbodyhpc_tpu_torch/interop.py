"""State carried across from the JAX package.

This system has no learned weights: its state is the particle set and its
fused (radius class, tile) partition for the render, and the sorted cell
list for k-NN. These helpers take that state as numpy arrays — as
:mod:`nbodyhpc_tpu` produces it — and put it on a torch device, so a test
can feed the JAX package's exact sorted state into the port's engine and
check the engine apart from the sort or the build. Nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cells import CellList
from .ops.splat import as_f32
from .ops.splat_cuda import FusedPartition


def particles_to_device(positions, weights, radii, device):
    """(positions [N, 3], weights [N], radii [N]) as float32 tensors on
    ``device``."""
    return (as_f32(np.asarray(positions), device),
            as_f32(np.asarray(weights), device),
            as_f32(np.asarray(radii), device))


def partition_from_jax(pos_px, w, rpx, key, grid, wtabs, kbases, dense_off,
                       n_huge, max_rpx, device="cpu") -> FusedPartition:
    """The port's :class:`FusedPartition` from the fields of a JAX
    ``nbodyhpc_tpu.ops.splat_pallas.FusedPartition`` (arrays as numpy),
    on ``device``."""
    pos_t, w_t, r_t = particles_to_device(pos_px, w, rpx, device)
    return FusedPartition(
        pos_px=pos_t, w=w_t, rpx=r_t,
        key=torch.as_tensor(np.asarray(key), dtype=torch.int32,
                            device=device),
        grid=tuple(int(v) for v in grid),
        wtabs=tuple(tuple(int(v) for v in t) for t in wtabs),
        kbases=tuple(int(v) for v in kbases),
        dense_off=int(dense_off), n_huge=int(n_huge), max_rpx=float(max_rpx),
    )


def cell_list_from_jax(xyz, index, offsets, dims, lo, cell_size,
                       inv_cell_size, n, periodic, boxsize, max_cell_count,
                       device="cpu") -> CellList:
    """The port's :class:`CellList` from the fields of a JAX
    ``nbodyhpc_tpu.core.cells.CellList`` (arrays as numpy; ``offsets`` as
    ``offsets_host()`` gives it), on ``device``. ``index`` (uint32 in JAX)
    becomes int32."""
    def arr(a, dt):
        return None if a is None else np.asarray(a, dt)

    return CellList(
        xyz=as_f32(np.asarray(xyz), device),
        index=torch.as_tensor(np.asarray(index).astype(np.int32),
                              device=device),
        offsets=torch.as_tensor(np.asarray(offsets, np.int32),
                                device=device),
        dims=arr(dims, np.int32), lo=arr(lo, np.float32),
        cell_size=arr(cell_size, np.float32),
        inv_cell_size=arr(inv_cell_size, np.float32), n=int(n),
        periodic=bool(periodic), boxsize=arr(boxsize, np.float32),
        max_cell_count=int(max_cell_count),
    )
