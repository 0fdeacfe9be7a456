"""Cell-list build: the sorted point storage every k-NN path scans.

PyTorch port of :mod:`nbodyhpc_tpu.core.cells` (the replacement for the
reference's recursive kd-tree build, kdtree_impl.hpp:78-174): points are
bucketed into a uniform cell grid, sorted by raveled cell id, and a per-cell
offset table gives each cell's contiguous range of the sorted storage.

One torch build serves the CPU and the card: cell ids in float32 exactly as
the JAX build computes them, a stable ``torch.sort`` of the ids, the
coordinates and original indices gathered after it, and ``torch.searchsorted``
for the offsets. The tree lives on the device of its build; there is no
host/device split and no per-shape compile cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import profiling
from .points import PAD_SENTINEL, round_up, validate_points

#: Default target mean points per cell (see the JAX module: 27 * occupancy
#: candidates are scanned by the first query pass).
DEFAULT_OCCUPANCY = 8.0

MAX_CELLS_PER_DIM = 1024

#: Sentinel slots past the last point, so a fixed-width slice of the sorted
#: storage starting inside the points never runs off the end.
PAD_MARGIN = 2048


@dataclasses.dataclass
class CellList:
    """Sorted-by-cell point storage plus the per-cell offset table.

    Attributes
    ----------
    xyz : (4, npad) float32 tensor
        Points sorted by raveled cell id (rows x, y, z; row 3 and the
        padding columns hold ``PAD_SENTINEL``).
    index : (npad,) int32 tensor
        Original point index of each sorted slot; padding slots hold ``n``.
        (uint32 in the JAX package; int32 here so it can index tensors.)
    offsets : (ncells + 1,) int32 tensor
        ``offsets[c]:offsets[c+1]`` is the sorted range of cell ``c``
        (row-major ravel of the 3D cell coordinate).
    dims : (3,) int32 numpy — cells per dimension.
    lo : (3,) float32 numpy — lower corner of the binning box.
    cell_size, inv_cell_size : (3,) float32 numpy.
    n : int — number of real points.
    periodic : bool
    boxsize : (3,) float32 numpy or None — periodic box lengths.
    max_cell_count : int — occupancy of the fullest cell.
    """

    xyz: torch.Tensor
    index: torch.Tensor
    offsets: torch.Tensor
    dims: np.ndarray
    lo: np.ndarray
    cell_size: np.ndarray
    inv_cell_size: np.ndarray
    n: int
    periodic: bool
    boxsize: np.ndarray | None
    max_cell_count: int
    #: per-tree kernel plan, built on first kernel query (ops/knn_device.py)
    kernel_plan: object = dataclasses.field(default=None, repr=False)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.dims))

    @property
    def npad(self) -> int:
        return int(self.xyz.shape[1])

    @property
    def device(self) -> torch.device:
        return self.xyz.device


def choose_dims(n: int, extent: np.ndarray, occupancy: float) -> np.ndarray:
    """Pick cells-per-dim so mean occupancy ~= `occupancy`, proportional to extent."""
    n = max(n, 1)
    target_cells = max(n / max(occupancy, 1.0), 1.0)
    extent = np.maximum(np.asarray(extent, dtype=np.float64), 1e-30)
    geo = float(np.prod(extent)) ** (1.0 / 3.0)
    per_unit = target_cells ** (1.0 / 3.0) / geo
    dims = np.maximum(1, np.floor(extent * per_unit + 0.5).astype(np.int64))
    return np.minimum(dims, MAX_CELLS_PER_DIM).astype(np.int32)


def cell_coords(points: torch.Tensor, lo, inv_h, dims, periodic: bool
                ) -> torch.Tensor:
    """(N, 3) int32 cell coordinates, ``floor((p - lo) * inv_h)`` in float32;
    wrapped (periodic) or clipped to the grid."""
    dev = points.device
    lo_t = torch.as_tensor(np.asarray(lo, np.float32), device=dev)
    ih_t = torch.as_tensor(np.asarray(inv_h, np.float32), device=dev)
    dims_t = torch.as_tensor(np.asarray(dims, np.int32), device=dev)
    ic = torch.floor((points - lo_t) * ih_t).to(torch.int32)
    if periodic:
        return torch.remainder(ic, dims_t)
    return torch.minimum(torch.clamp_min(ic, 0), dims_t - 1)


def _sort_build(points: torch.Tensor, lo, inv_h, dims, periodic: bool,
                npad: int):
    """Counterpart of the JAX ``_sort_build_core``: returns (xyz (4, npad),
    index (npad,) int32, offsets (ncells + 1,) int32, max cell count)."""
    dev = points.device
    n = points.shape[0]
    Cx, Cy, Cz = (int(v) for v in dims)
    ncells = Cx * Cy * Cz
    ic = cell_coords(points, lo, inv_h, dims, periodic)
    ids = (ic[:, 0] * Cy + ic[:, 1]) * Cz + ic[:, 2]
    sid, perm = torch.sort(ids, stable=True)
    xyz = torch.full((4, npad), float(PAD_SENTINEL), dtype=torch.float32,
                     device=dev)
    xyz[:3, :n] = points[perm].T
    index = torch.full((npad,), n, dtype=torch.int32, device=dev)
    index[:n] = perm.to(torch.int32)
    offsets = torch.searchsorted(
        sid, torch.arange(ncells + 1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    mcc = int(torch.diff(offsets).max()) if n else 0
    return xyz, index, offsets, mcc


def build_cell_list(points, boxsize=None,
                    occupancy: float = DEFAULT_OCCUPANCY,
                    pad_multiple: int = 128, device=None) -> CellList:
    """Build the cell list on ``device`` (default: the points' device for a
    tensor, else the CPU). Numpy arrays and CPU tensors are moved there
    first. Two host syncs: the extent (non-periodic) and the fullest cell."""
    if device is None:
        device = (points.device if isinstance(points, torch.Tensor)
                  else torch.device("cpu"))
    with profiling.span("nbodyhpc.knn.build", device):
        return _build_cells(validate_points(points, boxsize), boxsize,
                            occupancy, pad_multiple, device)


def _build_cells(points, boxsize, occupancy: float, pad_multiple: int,
                 device) -> CellList:
    points = torch.as_tensor(points, device=device)
    n = points.shape[0]
    periodic = boxsize is not None

    if periodic:
        box = np.broadcast_to(np.asarray(boxsize, dtype=np.float32),
                              (3,)).astype(np.float32)
        lo = np.zeros(3, dtype=np.float32)
        extent = box.astype(np.float64)
    else:
        box = None
        if n > 0:
            mm = torch.stack([points.min(dim=0).values,
                              points.max(dim=0).values]).cpu().numpy()
            pmin, pmax = mm.astype(np.float64)
        else:
            pmin, pmax = np.zeros(3), np.ones(3)
        span = np.maximum(pmax - pmin, 1e-12)
        # small margin so max-coordinate points land strictly inside the
        # last cell
        lo = (pmin - 1e-6 * span).astype(np.float32)
        extent = span * (1.0 + 2e-6)

    dims = choose_dims(n, extent, occupancy)
    h = (extent / dims).astype(np.float32)
    inv_h = (1.0 / h).astype(np.float32)
    npad = max(round_up(max(n, 1), pad_multiple), pad_multiple) + PAD_MARGIN
    xyz, index, offsets, mcc = _sort_build(points, lo, inv_h, dims, periodic,
                                           npad)
    return CellList(
        xyz=xyz, index=index, offsets=offsets, dims=dims, lo=lo,
        cell_size=h, inv_cell_size=inv_h, n=n, periodic=periodic,
        boxsize=box, max_cell_count=mcc,
    )
