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
    """Correctly rounded float32 square root, as XLA's and CUDA's are.

    On a CUDA tensor the root of the double, rounded once, is exact. On the
    CPU PyTorch's vectorized ``sqrt`` is not correctly rounded, in float32
    (off by one ulp for ~0.6% of uniform values, measured on an AVX-512
    build) nor in float64, where its error can reach far enough to move the
    float32 rounding of a few values in 1e5, and not the same ones in every
    call. So there the rounded root ``r`` only brackets the answer, and
    exact arithmetic decides: the midpoint of two neighbouring float32
    values has 25 significant bits, its square 50, so ``x`` compares exactly
    with the squares of ``r``'s two rounding boundaries in float64."""
    x = d2.to(torch.float64)
    r = torch.sqrt(x).to(torch.float32)
    if d2.device.type != "cpu":
        return r
    up = torch.nextafter(r, r.new_tensor(float("inf")))
    dn = torch.nextafter(r, r.new_tensor(float("-inf")))
    m_up = (r.to(torch.float64) + up.to(torch.float64)) * 0.5
    m_dn = (r.to(torch.float64) + dn.to(torch.float64)) * 0.5
    out = torch.where(x > m_up * m_up, up, r)
    return torch.where((r > 0) & (x < m_dn * m_dn), dn, out)


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
