"""Point validation, padding constants.

PyTorch port of :mod:`nbodyhpc_tpu.core.points` (reference: the pybind input
path ``make_positions_and_indices``, kdtree/src/cpp/pybind.cpp:14-56): an
(N, 3) point array is validated, and with a periodic box size every
coordinate must lie in ``[0, L]`` (pybind.cpp:42-46). Padding slots of the
sorted point storage hold :data:`PAD_SENTINEL`.
"""
from __future__ import annotations

import numpy as np
import torch

PAD_MULTIPLE = 128
#: Sentinel coordinate for padding points; large but finite so that squared
#: distances stay finite in float32. In periodic mode the min-image wrap maps
#: a sentinel displacement to exactly 0, so every scan masks padding by slot
#: or run length and never relies on the sentinel to lose.
PAD_SENTINEL = np.float32(3.0e18)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _check_box(boxsize):
    L = np.asarray(boxsize, dtype=np.float32)
    if np.any(L <= 0):
        raise ValueError("boxsize must be positive")
    return L


_OUT_OF_BOX = "points must be contained in the box [0, boxsize] when boxsize is given"


def validate_points(points, boxsize=None):
    """Validate an (N, 3) point set, returning it as contiguous float32.

    A tensor stays a tensor on its device (the box check then costs one
    scalar sync); anything else becomes a numpy array. Mirrors reference
    semantics (pybind.cpp:35-47): a 2D array with 3 columns; with a periodic
    ``boxsize`` every coordinate must satisfy ``0 <= x <= L``.
    """
    if isinstance(points, torch.Tensor):
        if points.dim() != 2 or points.shape[1] != 3:
            raise ValueError(
                f"points must have shape (N, 3), got {tuple(points.shape)}")
        points = points.to(torch.float32).contiguous()
        if boxsize is not None:
            L = torch.as_tensor(_check_box(boxsize), device=points.device)
            if points.shape[0] and bool(((points < 0) | (points > L)).any()):
                raise ValueError(_OUT_OF_BOX)
        return points
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must have shape (N, 3), got {points.shape}")
    points = np.ascontiguousarray(points, dtype=np.float32)
    if boxsize is not None:
        L = _check_box(boxsize)
        if np.any(points < 0) or np.any(points > L):
            raise ValueError(_OUT_OF_BOX)
    return points
