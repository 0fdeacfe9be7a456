"""Distance metrics: the minimum-image wrap.

PyTorch port of :mod:`nbodyhpc_tpu.ops.metrics` (reference
``L2PeriodicDistance``, kdtree/src/cpp/include/kdtree/kdtree.hpp:20-121).

:func:`wrap_min_image` is the shared wrap of the query paths (ladder,
candidate kernels' plain versions, ball counts). Its exact float32
expression ``d - L * round(d * (1/L))``, with ``1/L`` computed in double and
rounded once to float32 and ``round`` half to even, is part of the parity
contract with the JAX package and with the CUDA kernels (which take
``float(1.0 / L)`` from the host and use ``rintf``).
"""
from __future__ import annotations

import torch


def sqrt_f32(d2: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorized float32
    ``sqrt`` on the CPU is off by one ulp for some inputs (measured on an
    AVX-512 build, ~0.6% of uniform values), where XLA's and CUDA's are
    exact; the root of the double is rounded once and always exact."""
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """Fused ``a * b + c`` of float32 tensors, rounded once, as CUDA's
    ``fmaf``. The product is exact in float64; the float64 sum is rounded
    to odd (its exact error by Knuth's two-sum, then the odd neighbour
    where inexact), which makes the final rounding to float32 correct."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sq_dist(qcols, px, py, pz, box=None) -> torch.Tensor:
    """Squared distance ``fma(dz, dz, fma(dx, dx, dy*dy))`` with ``d =
    qcols[dim] - p`` (query columns shaped to broadcast against the
    candidate coordinates), each component wrapped with ``box[dim]`` when
    ``box`` is given. This is the JAX package's ``d2 = d2 + d * d`` loop as
    XLA compiles it for the CPU, which contracts the sum into two fused
    multiply-adds; the kernels compute the same with ``fmaf``."""
    d = []
    for dim, p in enumerate((px, py, pz)):
        dd = qcols[dim] - p
        if box is not None:
            dd = wrap_min_image(dd, box[dim])
        d.append(dd)
    dx, dy, dz = d
    return fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))


def wrap_min_image(d: torch.Tensor, L: float) -> torch.Tensor:
    """Minimum-image wrap of one displacement component for box length
    ``L`` (a Python float; ``L <= 0`` disables periodicity, matching the
    reference's degradation at box_size = 0)."""
    L = float(L)
    if L <= 0.0:
        return d
    return d - L * torch.round(d * (1.0 / L))
