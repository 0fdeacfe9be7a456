"""k-NN candidate kernels on an NVIDIA Hopper GPU, and their plain versions.

PyTorch/CUDA port of the candidate kernels of :mod:`nbodyhpc_tpu.ops.knn_pallas`.
Both walk the same candidate set: a *piece* (at most :data:`QB` queries of
one column, or of one column pair and z-segment) scans the logical runs
(start, len) of its plan row, concatenated in run order; candidate ``c`` of a
piece is the ``c``-th point of that concatenation.

- **B3** :func:`knn_topk` (kernel ``csrc/knn_topk.cu``, replaces
  ``knn_pallas.py::_knn_topk_kernel``): per query the exact ``k`` smallest
  squared distances, ascending, ties to the lowest candidate, and their tree
  slots, proven from the query's z-window outwards with a cell bound (the
  kernel also takes the plan's cells, :class:`CellGrid`). ``k <= 128``.
- **B4** (kernel ``csrc/knn_dist.cu``, replaces
  ``knn_pallas.py::_knn_kernel``): one tiled kernel that scores every
  candidate of every query, with two sinks.

  - :func:`knn_select`: the ``k`` smallest of each row, ascending, ties to
    the lowest candidate, and their tree slots, selected in shared memory
    (it also replaces ``_topk_blocks``, the selection that followed the TPU
    kernel). ``k <= 256``; the engine takes it for ``128 < k <= 256``.
  - :func:`knn_dist`: the squared distance to every candidate, as one row
    of a ``[rows, ncand]`` block with ``inf`` past the piece's candidates.
    :func:`select_block` then takes the ``k`` smallest with a stable sort
    (not ``torch.topk``, which orders ties arbitrarily) and decodes
    candidate positions to tree slots. The engine takes it for ``k > 256``.

Shared inputs: ``q`` float32 [3, Q] (query rows, sorted so each piece's
queries are consecutive), per piece ``piece_q0`` (first query row),
``piece_qn`` (query count, <= QB) and ``piece_pid`` (plan row), the plan's
``run_start``/``run_len`` int32 [rows, R <= 36], the tree's ``xyz`` float32
[4, npad], and ``box`` (the periodic lengths, or zeros). Output row
``piece_q0[p] - row_base + t`` answers query ``piece_q0[p] + t``.

Each wrapper runs its plain PyTorch version for CPU tensors, and for CUDA
tensors launches its kernel or raises; its ``launches`` attribute counts
kernel launches only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .knn import select_k
from .metrics import sq_dist

QB = 64          # queries per piece (knn_common.h kQB)
MAX_RUNS = 36    # logical runs per plan row (knn_common.h kMaxRuns)
TOPK_MAX = 128   # largest k of the fused kernel; larger k take B4
#: largest k of B4's selection sink (knn_dist.cu kSelectMax): a row's list in
#: shared memory holds SELECT_LIST keys of 8 bytes, 16 rows a block; with the
#: 24 KB of candidate tiles that is 88 KB, so two blocks fit an SM's 227 KB,
#: and k up to half the list leaves the other half as buffer
SELECT_LIST = 512
SELECT_MAX = SELECT_LIST // 2
#: elements per plain-version candidate block (bounds its transients)
PLAIN_BLOCK_ELEMS = 1 << 24


def _box_args(box):
    """(periodic, L0, L1, L2, 1/L0, 1/L1, 1/L2) for the C entry points;
    ``1/L`` is divided in double and rounded once, as the JAX wrap does."""
    L = [float(v) for v in box]
    periodic = L[0] > 0.0
    inv = [1.0 / v if v > 0.0 else 0.0 for v in L]
    return (int(periodic), *L, *inv)


def _rows_of_pieces(piece_q0, piece_qn):
    """(piece index, absolute query row) of every query of the pieces."""
    dev = piece_q0.device
    qn = piece_qn.long()
    piece = torch.repeat_interleave(torch.arange(qn.shape[0], device=dev), qn)
    first = torch.cumsum(qn, 0) - qn
    t = torch.arange(piece.shape[0], device=dev) - first[piece]
    return piece, piece_q0.long()[piece] + t


def decode_slots(pos, pid, run_start, run_len):
    """Tree slot of candidate position ``pos`` [rows, m] of plan rows
    ``pid`` [rows]; -1 where ``pos`` lies past the row's candidates."""
    lens = run_len.long()[pid]                     # [rows, R]
    ends = torch.cumsum(lens, 1)
    r = torch.searchsorted(ends, pos.contiguous(), right=True)
    valid = r < lens.shape[1]
    r = r.clamp_max(lens.shape[1] - 1)
    first = torch.gather(ends - lens, 1, r)
    slot = torch.gather(run_start.long()[pid], 1, r) + (pos - first)
    return torch.where(valid, slot, -1)


def _candidate_block(q, piece_q0, piece_qn, piece_pid, run_start, run_len,
                     xyz, box, ncand):
    """Plain candidate walk of some pieces: (rows [m] absolute query rows,
    d2 [m, ncand] float32 with inf past each piece's candidates)."""
    piece, rows = _rows_of_pieces(piece_q0, piece_qn)
    pid = piece_pid.long()[piece]
    pos = torch.arange(ncand, device=q.device).expand(rows.shape[0], ncand)
    slot = decode_slots(pos, pid, run_start, run_len)
    s = slot.clamp_min(0)
    wrap = box if float(box[0]) > 0.0 else None
    d2 = sq_dist([q[d, rows, None] for d in range(3)], xyz[0][s], xyz[1][s],
                 xyz[2][s], wrap)
    return rows, torch.where(slot >= 0, d2, float("inf"))


def _piece_chunks(piece_qn, width: int):
    """Contiguous piece ranges whose rows x ``width`` stay within
    :data:`PLAIN_BLOCK_ELEMS` (one piece at least)."""
    qn = piece_qn.cpu().numpy().astype(np.int64)
    rows = max(PLAIN_BLOCK_ELEMS // max(width, 1), 1)
    out, p0, acc = [], 0, 0
    for p, n in enumerate(qn):
        if acc and acc + n > rows:
            out.append((p0, p))
            p0, acc = p, 0
        acc += n
    if p0 < len(qn):
        out.append((p0, len(qn)))
    return out


def _totals(piece_pid, run_len):
    return run_len.long().sum(1)[piece_pid.long()]


# ---------------------------------------------------------------------------
# B4: the distance block
# ---------------------------------------------------------------------------


def knn_dist_reference(q, piece_q0, piece_qn, piece_pid, run_start, run_len,
                       xyz, box, ncand: int, row_base: int = 0,
                       nrows: int | None = None):
    """Plain version of the distance-block kernel: a gather of each piece's
    candidates padded with inf, then the d2 block [nrows, ncand]."""
    nrows = q.shape[1] - row_base if nrows is None else nrows
    out = torch.full((nrows, ncand), float("inf"), device=q.device)
    for p0, p1 in _piece_chunks(piece_qn, ncand):
        rows, d2 = _candidate_block(
            q, piece_q0[p0:p1], piece_qn[p0:p1], piece_pid[p0:p1], run_start,
            run_len, xyz, box, ncand)
        out[rows - row_base] = d2
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_inputs(name, q, piece_q0, piece_qn, piece_pid, run_start,
                  run_len, xyz):
    dev = q.device
    _require(all(t.device == dev for t in (piece_q0, piece_qn, piece_pid,
                                           run_start, run_len, xyz)),
             f"{name}: all tensors must be on one device")
    if dev.type == "cpu":
        return False
    _require(dev.type == "cuda", f"{name}: unsupported device {dev}")
    for tname, t, dt in (("q", q, torch.float32), ("xyz", xyz, torch.float32),
                         ("piece_q0", piece_q0, torch.int32),
                         ("piece_qn", piece_qn, torch.int32),
                         ("piece_pid", piece_pid, torch.int32),
                         ("run_start", run_start, torch.int32),
                         ("run_len", run_len, torch.int32)):
        _require(t.dtype == dt, f"{name}: {tname} must be {dt}, got {t.dtype}")
        _require(t.is_contiguous(), f"{name}: {tname} must be contiguous")
    _require(q.dim() == 2 and q.shape[0] == 3, f"{name}: q must be [3, Q]")
    _require(xyz.dim() == 2 and xyz.shape[0] == 4,
             f"{name}: xyz must be [4, npad]")
    _require(piece_q0.dim() == 1
             and piece_q0.shape == piece_qn.shape == piece_pid.shape,
             f"{name}: piece_q0/qn/pid must be [npieces]")
    _require(run_start.dim() == 2 and run_start.shape == run_len.shape
             and 1 <= run_start.shape[1] <= MAX_RUNS,
             f"{name}: run_start/run_len must be [rows, R <= {MAX_RUNS}]")
    if piece_qn.numel():
        _require(int(piece_qn.max()) <= QB,
                 f"{name}: a piece holds more than {QB} queries")
    return True


def knn_dist(q, piece_q0, piece_qn, piece_pid, run_start, run_len, xyz, box,
             ncand: int, row_base: int = 0, nrows: int | None = None):
    """Squared distances of each piece's queries to all its candidates:
    float32 [nrows, ncand], inf past each piece's candidate count (see
    :func:`knn_dist_reference`; ``ncand`` must cover every piece).

    Kernel ``csrc/knn_dist.cu`` (its block sink) for CUDA tensors; replaces
    ``nbodyhpc_tpu/ops/knn_pallas.py::_knn_kernel``. Bound by the block's
    stores: candidates are staged through shared memory in tiles, a warp
    owns two query rows and writes 16 bytes per lane where ``ncand`` is a
    multiple of 4 (a multiple of 32 starts every row on a 128-byte line).
    """
    if not _check_inputs("knn_dist", q, piece_q0, piece_qn, piece_pid,
                         run_start, run_len, xyz):
        return knn_dist_reference(q, piece_q0, piece_qn, piece_pid,
                                  run_start, run_len, xyz, box, ncand,
                                  row_base, nrows)
    _require(ncand >= 1, "knn_dist: ncand must be positive")
    nrows = q.shape[1] - row_base if nrows is None else nrows
    out = torch.empty((nrows, ncand), dtype=torch.float32, device=q.device)
    npieces = piece_q0.shape[0]
    if npieces == 0 or nrows == 0:
        return out
    err = _build.load().lib.knn_dist(
        q.data_ptr(), q.shape[1], piece_q0.data_ptr(), piece_qn.data_ptr(),
        piece_pid.data_ptr(), npieces, run_start.data_ptr(),
        run_len.data_ptr(), run_start.shape[1], xyz.data_ptr(), xyz.shape[1],
        *_box_args(box), out.data_ptr(), ncand, row_base, _stream(q),
    )
    knn_dist.launches += 1
    _build.check(err, "knn_dist launch")
    return out


knn_dist.launches = 0


def select_block(d2, k: int, pid, run_start, run_len):
    """The ``k`` nearest of each row of a distance block: (d2 [rows, k]
    ascending, tree slot [rows, k] int32, -1 where no candidate), by a
    stable sort, so ties go to the lowest candidate position. ``pid`` is
    each row's plan row. This selection lies outside the kernel, as
    ``_topk_blocks`` lies outside the Pallas kernel; :func:`knn_select`
    is the same function inside it."""
    vals, pos = select_k(d2, k)
    slot = decode_slots(pos, pid.long(), run_start, run_len)
    return vals, torch.where(torch.isfinite(vals), slot, -1).to(torch.int32)


def knn_select_reference(q, piece_q0, piece_qn, piece_pid, run_start,
                         run_len, xyz, box, k: int, row_base: int = 0,
                         nrows: int | None = None):
    """Plain version of B4's selection sink: every candidate's distance, a
    stable sort, the first ``k`` (no limit on ``k``). Returns (d2 [nrows, k]
    float32, slot [nrows, k] int32; inf / -1 where a piece has fewer than
    ``k`` candidates)."""
    return knn_topk_reference(q, piece_q0, piece_qn, piece_pid, run_start,
                              run_len, xyz, box, k, row_base, nrows)


def knn_select(q, piece_q0, piece_qn, piece_pid, run_start, run_len, xyz, box,
               k: int, row_base: int = 0, nrows: int | None = None):
    """The ``k`` nearest candidates of every query of the pieces, all
    candidates scored: (d2 [nrows, k] float32 ascending, tree slot
    [nrows, k] int32), ties to the lowest candidate position (see
    :func:`knn_select_reference`). ``k <= SELECT_MAX``.

    Kernel ``csrc/knn_dist.cu`` (its selection sink) for CUDA tensors;
    replaces ``nbodyhpc_tpu/ops/knn_pallas.py::_knn_kernel`` and the
    ``_topk_blocks`` pass over its block. Bound by its float32 instructions:
    the distances are filtered against each row's k-th best and selected in
    shared memory, so only the answer reaches device memory.
    """
    _require(1 <= k <= SELECT_MAX,
             f"knn_select: k must be in [1, {SELECT_MAX}]")
    if not _check_inputs("knn_select", q, piece_q0, piece_qn, piece_pid,
                         run_start, run_len, xyz):
        return knn_select_reference(q, piece_q0, piece_qn, piece_pid,
                                    run_start, run_len, xyz, box, k,
                                    row_base, nrows)
    nrows = q.shape[1] - row_base if nrows is None else nrows
    out_d = torch.empty((nrows, k), dtype=torch.float32, device=q.device)
    out_s = torch.empty((nrows, k), dtype=torch.int32, device=q.device)
    npieces = piece_q0.shape[0]
    if npieces == 0 or nrows == 0:
        return out_d, out_s
    err = _build.load().lib.knn_select(
        q.data_ptr(), q.shape[1], piece_q0.data_ptr(), piece_qn.data_ptr(),
        piece_pid.data_ptr(), npieces, run_start.data_ptr(),
        run_len.data_ptr(), run_start.shape[1], xyz.data_ptr(), xyz.shape[1],
        *_box_args(box), out_d.data_ptr(), out_s.data_ptr(), k, row_base,
        _stream(q),
    )
    knn_select.launches += 1
    _build.check(err, "knn_select launch")
    return out_d, out_s


knn_select.launches = 0


# ---------------------------------------------------------------------------
# B3: fused distances + top-k
# ---------------------------------------------------------------------------


def knn_topk_reference(q, piece_q0, piece_qn, piece_pid, run_start, run_len,
                       xyz, box, k: int, row_base: int = 0,
                       nrows: int | None = None):
    """Plain version of the top-k kernel: the candidate block of
    :func:`knn_dist_reference`, a stable sort, the first ``k``. Returns
    (d2 [nrows, k] float32, slot [nrows, k] int32; inf / -1 where a piece
    has fewer than ``k`` candidates)."""
    nrows = q.shape[1] - row_base if nrows is None else nrows
    dev = q.device
    out_d = torch.full((nrows, k), float("inf"), device=dev)
    out_s = torch.full((nrows, k), -1, dtype=torch.int32, device=dev)
    tot = _totals(piece_pid, run_len)
    width = int(tot.max()) if tot.numel() else 0
    for p0, p1 in _piece_chunks(piece_qn, width):
        ncand = max(int(tot[p0:p1].max()), 1)
        rows, d2 = _candidate_block(
            q, piece_q0[p0:p1], piece_qn[p0:p1], piece_pid[p0:p1], run_start,
            run_len, xyz, box, ncand)
        pid = piece_pid.long()[p0:p1].repeat_interleave(piece_qn[p0:p1].long())
        vals, slot = select_block(d2, k, pid, run_start, run_len)
        out_d[rows - row_base] = vals
        out_s[rows - row_base] = slot
    return out_d, out_s


class CellGrid(NamedTuple):
    """The cells behind a plan's runs, which B3 needs to visit each query's
    window first and skip cells by their distance: ``run_cell`` and
    ``run_ncell`` int32 [rows, R] (each run's first cell id and cell count;
    a run is a contiguous range of ids ``(x * Cy + y) * Cz + z``),
    ``offsets`` int32 [ncells + 1] (cell ``c`` holds slots ``offsets[c]``
    .. ``offsets[c + 1]``), and per axis ``dims``, ``lo``, the cell size
    ``h`` and ``inv_h`` (float32 values, as the tree bins its points)."""

    run_cell: torch.Tensor
    run_ncell: torch.Tensor
    offsets: torch.Tensor
    dims: tuple
    lo: tuple
    h: tuple
    inv_h: tuple


#: B3's cell bound subtracts this share of each axis's coordinate scale
#: (``|lo| + dims * h``): ~128 float32 ulps, far above the rounding of the
#: cell assignment and of the displacement, far below a cell
BOUND_MARGIN = 2.0 ** -16


def _grid_args(grid: CellGrid):
    """(C0, C1, C2, lo, h, 1/h, margin per axis) for the C entry point."""
    dims = [int(v) for v in grid.dims]
    lo = [float(v) for v in grid.lo]
    h = [float(v) for v in grid.h]
    marg = [BOUND_MARGIN * (abs(a) + c * b) for a, c, b in zip(lo, dims, h)]
    return (*dims, *lo, *h, *(float(v) for v in grid.inv_h), *marg)


def knn_topk(q, piece_q0, piece_qn, piece_pid, run_start, run_len, xyz, box,
             k: int, row_base: int = 0, nrows: int | None = None, *,
             grid: CellGrid | None, counts=None):
    """Exact ``k`` nearest candidates of every query of the pieces: (d2
    [nrows, k] float32 ascending, tree slot [nrows, k] int32), ties to the
    lowest candidate position (see :func:`knn_topk_reference`).

    Kernel ``csrc/knn_topk.cu`` for CUDA tensors; replaces
    ``nbodyhpc_tpu/ops/knn_pallas.py::_knn_topk_kernel``. One thread per
    query row; each scores the cells of its z-window first, then scans a
    further cell only where a lower bound on its distances does not exceed
    the k-th best, so it does the work the answer needs rather than every
    candidate. ``grid`` is always given: the kernel needs the plan's cells
    (:func:`.knn_device.cell_grid`); the plain version on CPU tensors does
    not read them, so it takes None there. ``counts``, an int64 CUDA tensor
    of 2, receives the pairs scored and the cells scanned. ``k <= 128``.
    """
    _require(1 <= k <= TOPK_MAX, f"knn_topk: k must be in [1, {TOPK_MAX}]")
    if not _check_inputs("knn_topk", q, piece_q0, piece_qn, piece_pid,
                         run_start, run_len, xyz):
        return knn_topk_reference(q, piece_q0, piece_qn, piece_pid,
                                  run_start, run_len, xyz, box, k, row_base,
                                  nrows)
    _require(grid is not None, "knn_topk: the kernel needs the plan's cells "
                               "(grid=CellGrid(...))")
    for tname, t in (("run_cell", grid.run_cell),
                     ("run_ncell", grid.run_ncell),
                     ("offsets", grid.offsets)):
        _require(t.device == q.device and t.dtype == torch.int32
                 and t.is_contiguous(),
                 f"knn_topk: {tname} must be contiguous int32 on {q.device}")
    _require(grid.run_cell.shape == grid.run_ncell.shape == run_start.shape,
             "knn_topk: run_cell/run_ncell must be shaped like run_start")
    if counts is not None:
        _require(counts.device == q.device and counts.dtype == torch.int64
                 and counts.numel() == 2 and counts.is_contiguous(),
                 "knn_topk: counts must be a contiguous int64 tensor of 2")
    nrows = q.shape[1] - row_base if nrows is None else nrows
    dev = q.device
    out_d = torch.empty((nrows, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((nrows, k), dtype=torch.int32, device=dev)
    npieces = piece_q0.shape[0]
    if npieces == 0 or nrows == 0:
        return out_d, out_s
    err = _build.load().lib.knn_topk(
        q.data_ptr(), q.shape[1], piece_q0.data_ptr(), piece_qn.data_ptr(),
        piece_pid.data_ptr(), npieces, run_start.data_ptr(),
        run_len.data_ptr(), grid.run_cell.data_ptr(),
        grid.run_ncell.data_ptr(), run_start.shape[1],
        grid.offsets.data_ptr(), xyz.data_ptr(), xyz.shape[1],
        *_box_args(box), *_grid_args(grid), out_d.data_ptr(),
        out_s.data_ptr(), k, row_base, nrows,
        None if counts is None else counts.data_ptr(), _stream(q),
    )
    knn_topk.launches += 1
    _build.check(err, "knn_topk launch")
    return out_d, out_s


knn_topk.launches = 0
