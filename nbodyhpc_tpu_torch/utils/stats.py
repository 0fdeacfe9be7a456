"""Summary statistics for N-body post-processing: kNN-CDFs and field stats.

PyTorch port of :mod:`nbodyhpc_tpu.utils.stats`. The kNN-CDF (cumulative
distribution of k-th nearest-neighbour distances from random query points,
Banerjee & Abel 2020) is built on the port's :class:`..kdtree.KDTree`; the
query points come from the same Philox stream as the JAX package's, so the
two agree for the same seed.
"""
from __future__ import annotations

import numpy as np

from ..kdtree import KDTree


def knn_cdf(points, k=(1, 2, 4, 8), n_queries: int = 100_000, radii=None,
            boxsize=None, seed: int = 0, tree: KDTree | None = None,
            device=None):
    """kNN-CDFs: P(distance to k-th neighbour <= r) from random query points.

    Returns (radii (R,), cdf (len(k), R)). ``device`` places the tree when
    ``tree`` is not given.
    """
    ks = tuple(int(v) for v in (k if np.ndim(k) else (k,)))
    kmax = max(ks)
    points = np.asarray(points, np.float32)
    if tree is None:
        tree = KDTree(points, boxsize=boxsize, device=device)

    rng = np.random.Generator(np.random.Philox(seed))
    if boxsize is not None:
        lo = np.zeros(3)
        hi = np.broadcast_to(np.asarray(boxsize, np.float64), (3,))
    else:
        lo = points.min(axis=0)
        hi = points.max(axis=0)
    queries = (lo + rng.random((n_queries, 3)) * (hi - lo)).astype(np.float32)

    dist, _ = tree.query(queries, k=kmax)
    kth = dist[:, [kk - 1 for kk in ks]]  # (Q, len(ks))

    if radii is None:
        # range from the LARGEST k's finite distances (k > n gives inf)
        dmax = dist[:, kmax - 1]
        finite = dmax[np.isfinite(dmax)]
        if finite.size == 0:
            raise ValueError(
                f"cannot derive a radii grid: k={kmax} exceeds the point "
                "count; pass radii explicitly"
            )
        rmax = float(np.percentile(finite, 99.5))
        radii = np.linspace(0.0, rmax, 64)
    radii = np.asarray(radii, np.float64)

    cdf = np.empty((len(ks), radii.size))
    for i in range(len(ks)):
        cdf[i] = np.searchsorted(np.sort(kth[:, i]), radii,
                                 side="right") / n_queries
    return radii, cdf


def field_moments(density):
    """(total mass, mean, variance, max) of a density field -- the
    quantities the reference demo reports for validation
    (rasterization/src/cpp/main.cpp:53-84)."""
    d = np.asarray(density, np.float64)
    return float(d.sum()), float(d.mean()), float(d.var()), float(d.max())
