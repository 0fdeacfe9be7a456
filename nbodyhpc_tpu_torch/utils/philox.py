"""Deterministic counter-based random data generation for tests/benchmarks.

Copy of :mod:`nbodyhpc_tpu.utils.philox` (numpy only). The reference seeds
Philox4x32 (Random123) for reproducible point clouds (reference:
kdtree/src/cpp/include/kdtree/kdtree_utils.hpp:16-90); numpy ships the same
generator, so fixtures are deterministic across platforms and identical to
the JAX package's for the same seed.
"""
from __future__ import annotations

import numpy as np


def random_points(n: int, seed: int = 42, boxsize: float = 1.0) -> np.ndarray:
    """(n, 3) float32 uniform points in [0, boxsize)^3, Philox-deterministic."""
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)) * boxsize).astype(np.float32)


def random_particles(n: int, seed: int = 42, boxsize: float = 1.0,
                     mean_radius: float | None = None):
    """(positions, weights, radii) for splat benchmarks: unit weights and
    lognormal radii around the mean interparticle spacing."""
    rng = np.random.Generator(np.random.Philox(seed))
    pos = (rng.random((n, 3)) * boxsize).astype(np.float32)
    w = np.ones(n, np.float32)
    if mean_radius is None:
        mean_radius = boxsize / max(n, 1) ** (1.0 / 3.0)
    r = (rng.lognormal(0.0, 0.35, n) * mean_radius).astype(np.float32)
    return pos, w, r
