"""Public k-NN API mirroring ``nbodyhpc.kdtree``.

PyTorch port of :mod:`nbodyhpc_tpu.kdtree` (reference: kdtree/src/python/
nbodyhpc/kdtree/__init__.py:11-56 and pybind.cpp:196-216):
``KDTree(points, leafsize=128, max_threads=-1, boxsize=None)`` with
``.query(points, k=1, workers=1)`` returning (distances float32 ascending,
indices uint32), plus the ``n``/``size``/``periodic``/``boxsize`` properties.

Internally a sorted cell-list engine, routed by :mod:`..ops.knn_device`: on
a CUDA device, batches of 8192 queries or more go through the hand-written
candidate kernels (:mod:`..ops.knn_cuda`) and the exact ladder
(:mod:`..ops.knn`) finishes what they cannot certify; smaller batches and
CPU trees take the ladder. A tree built from numpy lives on the card unless
``device`` names another. ``engine="kernel"`` forces the kernel route, which
on the CPU runs the kernels' plain versions.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..core.cells import build_cell_list
from ..ops.knn import QueryStatistics
from ..ops.knn_device import ENGINES, cell_knn_query

__all__ = ["KDTree", "QueryStatistics", "ENGINES"]


def _group_size() -> int:
    """Ranks of the initialised ``torch.distributed`` world (1 without)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


class KDTree:
    """Spatial k-NN index with optional periodic boundary conditions.

    Parameters mirror the reference wrapper (kdtree/__init__.py:17-38):

    points : (N, 3) array or tensor
    leafsize : int
        Sets the target cell occupancy of the cell grid
        (``occupancy ~= leafsize / 16``).
    max_threads : int
        Accepted for compatibility.
    boxsize : float or 3-tuple, optional
        Periodic box size. Points must lie in ``[0, boxsize]``
        (reference: pybind.cpp:42-46 raises on out-of-box points).
    device : torch device, optional
        Where the tree lives and queries run. Default: a tensor's own
        device; otherwise the card (``"cuda"``), and without one it
        raises: a CPU run passes ``device="cpu"``.
    """

    def __init__(self, points, leafsize: int = 128, max_threads: int = -1,
                 boxsize=None, device=None, **kwargs):
        if len(kwargs) > 0:
            warnings.warn("Unrecognized keyword arguments: {}".format(kwargs))
        occupancy = max(2.0, float(leafsize) / 16.0)
        if device is None and isinstance(points, torch.Tensor):
            device = points.device
        self._tree = build_cell_list(points, boxsize=boxsize,
                                     occupancy=occupancy,
                                     device=default_device(device))

    # --- properties, reference pybind.cpp:212-215 ---
    @property
    def n(self) -> int:
        return self._tree.n

    @property
    def size(self) -> int:
        return self._tree.n

    @property
    def periodic(self) -> bool:
        return self._tree.periodic

    @property
    def boxsize(self):
        if self._tree.boxsize is None:
            return None
        b = self._tree.boxsize
        return float(b[0]) if np.all(b == b[0]) else tuple(float(v) for v in b)

    @property
    def device(self) -> torch.device:
        return self._tree.device

    def query(self, points, k: int = 1, workers: int = 1, **kwargs
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact k nearest neighbours of each query point (numpy in and
        out).

        Matches the reference contract (kdtree/__init__.py:40-56,
        pybind.cpp:90-189): queries of shape (..., 3) are flattened to 2D
        and results reshaped to (..., k); distances are float32, ascending,
        with the sqrt applied; indices are uint32. ``k <= 0`` raises.
        Missing neighbours (k > n) get distance ``inf`` and index ``n``.
        ``workers`` maps the reference's thread fan-out (pybind.cpp:164-172)
        to ranks: when a ``torch.distributed`` process group of more than
        one rank is initialised, ``workers != 1`` shards the queries over
        its ranks (:func:`..parallel.sharded.knn_query_sharded`, each rank
        on this tree's device). That is a collective: every rank must call
        it, with the same tree and queries, and every rank gets the whole
        answer. Without such a group it changes nothing (one device already
        answers a batch data-parallel).
        """
        if len(kwargs) > 0:
            warnings.warn("Unrecognized keyword arguments: {}".format(kwargs))
        if k <= 0:
            raise ValueError("k must be positive")
        points = np.asarray(points, dtype=np.float32)
        shape = None
        if points.ndim != 2:
            shape = points.shape
            points = points.reshape((-1, shape[-1]))
        if points.shape[-1] != 3:
            raise ValueError("query points must have 3 coordinates")
        if workers != 1 and points.shape[0] > 0 and _group_size() > 1:
            from ..parallel.sharded import knn_query_sharded

            distances, indices = knn_query_sharded(self._tree, points, k)
        else:
            res = cell_knn_query(self._tree, points, k)
            distances = res.distances.cpu().numpy()
            indices = res.indices.cpu().numpy()
        indices = indices.astype(np.uint32)
        if shape is not None:
            distances = distances.reshape(shape[:-1] + (k,))
            indices = indices.reshape(shape[:-1] + (k,))
        return distances, indices

    def query_device(self, queries, k: int = 1, engine: str = "auto"):
        """Exact k-NN with tensors in and out, on the tree's device.

        ``engine``: "auto" sends batches of 8192 queries or more on a CUDA
        tree through the candidate kernels, "kernel" always does (on the
        CPU through the kernels' plain versions), "ladder" never does.
        Periodic trees with fewer than 3 cells in x or y always take the
        ladder. Returns (distances (Q, k) float32 ascending, indices (Q, k)
        int32 -- not uint32, which torch supports for few operations).
        """
        res = cell_knn_query(self._tree, queries, k, engine=engine)
        return res.distances, res.indices

    def query_with_statistics(self, points, k: int = 1,
                              engine: str = "auto"):
        """Like :meth:`query` but also returns per-query
        :class:`QueryStatistics` as numpy int32 arrays (cells scanned,
        candidate points visited, cells pruned by the convergence bound;
        reference KDTreeQueryStatistics, kdtree.hpp:124-131). Queries the
        kernels answer report their piece's plan row."""
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        res = cell_knn_query(self._tree, points, k, with_stats=True,
                             engine=engine)
        stats = QueryStatistics(*(s.cpu().numpy() for s in res.stats))
        return (res.distances.cpu().numpy(),
                res.indices.cpu().numpy().astype(np.uint32), stats)

    def query_radius_count(self, points, radius,
                           engine: str = "auto") -> np.ndarray:
        """Number of points within ``radius`` of each query (ball count,
        inclusive). Periodicity follows the tree. ``radius`` may be scalar
        or per-query; ``engine`` is "auto", "cells" or "dense"."""
        from ..ops.ball import ball_count

        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        return ball_count(self._tree, points, radius, engine=engine)
