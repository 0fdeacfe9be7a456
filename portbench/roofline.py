"""The card's peaks and the least bytes each measured call has to move.

One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): 3.35 TB/s of
HBM. The byte counts read each input once and write each output once,
whatever the kernels that implement the call read again, so a roofline
share stays the same measure when the program's kernels change.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def least_ms(nbytes: float) -> float:
    """The least time, in ms, to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def render_bytes(particles: int, voxels: int) -> int:
    """A volume render: each particle read once (position, weight and radius,
    20 B) and each voxel of the field written once (4 B)."""
    return 20 * particles + 4 * voxels


def b3_bytes(points: int, nq: int, k: int) -> int:
    """A k-NN query batch: each tree point read once (12 B), each query read
    once (12 B), each result written once (a distance and an index, 8 B per
    entry)."""
    return 12 * points + 12 * nq + 8 * k * nq
