"""Public rasterizer API mirroring ``nbodyhpc.rasterizer``.

PyTorch port of :mod:`nbodyhpc_tpu.rasterizer` (reference: rasterization/
src/python/nbodyhpc/rasterizer/__init__.py:1-143): extent/period
normalization, the cached default container and per-(width, height,
subsample) renderer instances, and ``render_points`` /
``render_points_volume`` with the same argument conventions and the same
(height, width[, num_slices]) Fortran-ordered float32 numpy outputs
(rasterization/src/cpp/pybind.cpp:89-95,116-122).

The Vulkan runtime (VulkanContainer, reference vulkan_support.cpp:150-292)
maps to :class:`Container`, which names the torch device every render runs
on; the graphics pipeline (PointRenderer, point_renderer.cpp:15-370) maps to
:class:`PointRenderer`.

Engine choice follows the device: on a CUDA device the volume renders
through the tile engine's kernels (:mod:`..ops.splat_cuda`), on the CPU
through the oracle (:mod:`..ops.splat`). ``PointRenderer(engine="cuda")``
forces the tile engine, which on the CPU runs the kernels' plain versions.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch

from .. import default_device
from ..ops import ghosts as _ghosts
from ..ops import splat as _splat

Extent2d = Union[int, Tuple[int, int]]
Extent3d = Union[int, Tuple[int, int, int]]
PeriodT = Union[bool, float, Tuple[float, float, float]]

ENGINES = ("auto", "cuda", "oracle")

__all__ = [
    "Container",
    "PointRenderer",
    "get_default_container",
    "get_point_renderer",
    "render_points",
    "render_points_volume",
]


def _normalize_extent_2d(extent: Extent2d) -> Tuple[int, int]:
    if isinstance(extent, (int, np.integer)):
        return int(extent), int(extent)
    return tuple(int(v) for v in extent)


def _normalize_extent_3d(extent: Extent3d) -> Tuple[int, int, int]:
    if isinstance(extent, (int, np.integer)):
        return int(extent), int(extent), int(extent)
    return tuple(int(v) for v in extent)


def _normalize_period(deduced, period: PeriodT):
    """bool -> deduced box or disabled; scalar -> cubic; 2-tuple -> 2D;
    3-tuple -> per-dim (negative disables). Reference __init__.py:27-39."""
    if isinstance(period, (bool, np.bool_)):
        return tuple(deduced) if period else (-1.0, -1.0, -1.0)
    if isinstance(period, (int, float, np.floating, np.integer)):
        p = float(period)
        return (p, p, p)
    period = tuple(float(v) for v in period)
    if len(period) == 2:
        return (period[0], period[1], -1.0)
    return period


class Container:
    """Runtime context: the analog of the reference's ``VulkanContainer``.

    ``device`` is the torch device every render of this container runs on
    (default: the card, ``"cuda"``; without one it raises, and a CPU run
    passes ``device="cpu"``).
    ``enable_validation_layers`` is the analog of
    ``VK_LAYER_KHRONOS_validation`` (vulkan_support.cpp:132-148): renders of
    this container check that their inputs and their output are finite and
    raise ``ValueError`` otherwise.
    """

    def __init__(self, enable_validation_layers: bool = False, device=None):
        self.validation = bool(enable_validation_layers)
        self.device = default_device(device)

    def check_finite(self, name: str, t: torch.Tensor) -> None:
        """The validation layer: raise on non-finite values in ``t``."""
        if self.validation and not bool(torch.isfinite(t).all()):
            raise ValueError(f"validation layer: non-finite values in {name}")

    def __repr__(self):
        return f"Container(device={self.device}, validation={self.validation})"


@functools.lru_cache(maxsize=None)
def get_default_container() -> Container:
    """Default runtime container (cached), reference __init__.py:42-52: on
    the card, so without one it raises (see :class:`Container`)."""
    return Container(enable_validation_layers=False)


def _validate_arrays(positions, weights, radii, device):
    """Shape validation mirroring ``assemble_vertices`` (pybind.cpp:25-52);
    returns float32 tensors on ``device``."""
    positions = _splat.as_f32(positions, device)
    weights = _splat.as_f32(weights, device)
    radii = _splat.as_f32(radii, device)
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError("positions must be a 2D array of shape (N, 3)")
    if weights.dim() != 1:
        raise ValueError("weight must be a 1D array")
    if radii.dim() != 1:
        raise ValueError("radii must be a 1D array")
    if radii.shape[0] != positions.shape[0]:
        raise ValueError("radii must have the same length as positions")
    if weights.shape[0] != positions.shape[0]:
        raise ValueError("weights must have the same length as positions")
    return positions, weights, radii


def _to_fortran(field: torch.Tensor) -> np.ndarray:
    """(nx, ny[, nz]) C-order tensor -> F-order float32 numpy array. The axis
    reversal happens on the device; the host array is a transposed view of
    the copied buffer, so no host-side transpose pass runs."""
    rev = tuple(range(field.dim() - 1, -1, -1))
    return field.permute(rev).contiguous().cpu().numpy().transpose(rev)


class PointRenderer:
    """Sphere-splat renderer for one output shape.

    Constructor signature mirrors the reference binding
    ``PointRenderer(container, width, height, subsample_factor=4)``
    (pybind.cpp:141-167). As in the reference, the output arrays have shape
    ``(height, width[, num_slices])`` where the *height* axis spans
    position-x (the internal transpose documented at point_renderer.h:53-59).
    ``engine``: "auto" (tile engine on CUDA, oracle on the CPU), "cuda"
    (tile engine) or "oracle".
    """

    def __init__(self, container: Container | None, width: int, height: int,
                 subsample_factor: int = 4, engine: str = "auto"):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.container = (container if container is not None
                          else get_default_container())
        self.width = int(width)
        self.height = int(height)
        self.subsample_factor = int(subsample_factor)
        self.engine = engine
        # logical grid: axis 0 (nx) <- height <- position x
        self._nx, self._ny = self.height, self.width

    # -- internals ---------------------------------------------------------
    def _use_engine(self) -> bool:
        if self.engine == "auto":
            return self.container.device.type == "cuda"
        return self.engine == "cuda"

    def _prepare(self, positions, weights, radii, period):
        c = self.container
        positions, weights, radii = _validate_arrays(positions, weights,
                                                     radii, c.device)
        for name, t in (("positions", positions), ("weights", weights),
                        ("radii", radii)):
            c.check_finite(name, t)
        if any(p > 0 for p in period):
            positions, weights, radii = _ghosts.augment_points_periodic(
                positions, weights, radii, period
            )
        return positions, weights, radii

    def _finish(self, field: torch.Tensor) -> np.ndarray:
        self.container.check_finite("the rendered field", field)
        return _to_fortran(field)

    def render_points(self, positions, weights, radii, pixels_per_unit: float,
                      period=(-1.0, -1.0, -1.0)) -> np.ndarray:
        """Render one 2D slice at z=0; returns (height, width) float32
        F-order. Reference path: pybind.cpp:73-96 +
        point_renderer.cpp:606-657.

        The 2D plane (depth 0, bounds (-0.5, 0.5] px) is 3D slice 0 with z
        shifted by half a pixel, so the tile engine renders it on a
        one-voxel z-slab. Big particles: the shift rounds once in float32,
        so engine and 2D oracle agree to round-off, not bit-exactly.
        Sub-pixel particles select on z in (-0.5, 0.5] *units*: that
        predicate is evaluated here with the oracle's exact float32
        expression, and selected particles are parked mid-slab.
        """
        positions, weights, radii = self._prepare(positions, weights, radii,
                                                  period)
        ppu = float(pixels_per_unit)
        if not self._use_engine():
            img = _splat.splat_2d_oracle(
                positions, weights, radii, ppu, (self._nx, self._ny),
                self.subsample_factor,
            )
            return self._finish(img)
        from ..ops import splat_cuda

        is_sub = radii * ppu < 0.5
        zu = positions[:, 2] * ppu * (1.0 / ppu)
        zsel = (zu > -0.5) & (zu <= 0.5)
        pos2 = positions.clone()
        pos2[:, 2] = torch.where(
            is_sub,
            torch.full_like(zu, 0.5 / ppu),  # mid-slab: pixel-voxel 0
            positions[:, 2] + (0.5 / ppu),
        )
        weights = torch.where(is_sub & ~zsel, 0.0, weights)
        vol = splat_cuda.splat_volume(pos2, weights, radii, ppu,
                                      (self._nx, self._ny, 1),
                                      self.subsample_factor)
        return self._finish(vol[:, :, 0])

    def _render_volume_device(self, positions, weights, radii,
                              num_slices: int, pixels_per_unit: float,
                              period=(-1.0, -1.0, -1.0)) -> torch.Tensor:
        """The volume as a C-order (nx, ny, num_slices) float32 tensor on
        the container's device, before the copy to the host: a streamed
        render sums its batches here."""
        positions, weights, radii = self._prepare(positions, weights, radii,
                                                  period)
        grid = (self._nx, self._ny, int(num_slices))
        if self._use_engine():
            from ..ops import splat_cuda

            return splat_cuda.splat_volume(
                positions, weights, radii, float(pixels_per_unit), grid,
                self.subsample_factor,
            )
        return _splat.splat_volume_oracle(
            positions, weights, radii, float(pixels_per_unit), grid,
            self.subsample_factor,
        )

    def render_points_volume(self, positions, weights, radii, num_slices: int,
                             pixels_per_unit: float,
                             period=(-1.0, -1.0, -1.0)) -> np.ndarray:
        """Render the full volume; returns (height, width, num_slices)
        float32 F-order. Reference path: pybind.cpp:98-123 +
        point_renderer.cpp:825-950."""
        return self._finish(self._render_volume_device(
            positions, weights, radii, num_slices, pixels_per_unit, period))


@functools.lru_cache(maxsize=None)
def _get_point_renderer_impl(width: int, height: int,
                             subsample_factor: int = 4,
                             container: Container | None = None
                             ) -> PointRenderer:
    return PointRenderer(container, width, height, subsample_factor)


def get_point_renderer(grid_size: Extent2d, subsample_factor: int = 4,
                       container: Container | None = None) -> PointRenderer:
    """Cached renderer for a grid size; reference __init__.py:60-84 (note the
    reference's height/width unpack order, preserved here)."""
    if container is None:
        container = get_default_container()
    height, width = _normalize_extent_2d(grid_size)
    return _get_point_renderer_impl(width, height, subsample_factor, container)


def render_points(positions, weights, radii, pixels_per_unit: float,
                  grid_size: Extent2d, periodic: PeriodT = False) -> np.ndarray:
    """Render points in the z=0 slice; reference __init__.py:87-101."""
    grid_x, grid_y = _normalize_extent_2d(grid_size)
    renderer = get_point_renderer((grid_x, grid_y))
    deduced = (grid_x / pixels_per_unit, grid_y / pixels_per_unit, -1.0)
    period = _normalize_period(deduced, periodic)
    return renderer.render_points(positions, weights, radii, pixels_per_unit,
                                  period)


def render_points_volume(positions, weights, radii, pixels_per_unit: float,
                         grid_size: Extent3d, periodic: PeriodT = False,
                         subsample_factor: int = 4) -> np.ndarray:
    """Render points into a 3D density grid; reference __init__.py:104-143.

    Returns float32 array of shape ``(grid_x, grid_y, num_slices)``,
    Fortran-contiguous, where voxel (i, j, k) covers
    ``[i, i+1) x [j, j+1) x [k, k+1) / pixels_per_unit`` in position space.
    Renders on the default container's device.
    """
    grid_x, grid_y, num_slices = _normalize_extent_3d(grid_size)
    deduced_box = (
        grid_x / pixels_per_unit,
        grid_y / pixels_per_unit,
        num_slices / pixels_per_unit,
    )
    period = _normalize_period(deduced_box, periodic)
    renderer = get_point_renderer((grid_x, grid_y), subsample_factor)
    return renderer.render_points_volume(
        positions, weights, radii, num_slices, pixels_per_unit, period
    )
