"""State carried across from the JAX package.

This system has no learned weights: its state is the particle set and its
fused (radius class, tile) partition. These helpers take that state as numpy
arrays — as :mod:`nbodyhpc_tpu` produces it — and put it on a torch device,
so a test can feed the JAX package's exact sorted state into the port's
engine and check the engine apart from the sort. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

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
