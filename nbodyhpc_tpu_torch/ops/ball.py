"""Fixed-radius (ball) queries: neighbour counts within a radius.

PyTorch port of :mod:`nbodyhpc_tpu.ops.ball` (XLA only in JAX, plain torch
here). Two engines, both exact, counting with an inclusive boundary
(``d2 <= r2``, as ``scipy.spatial.KDTree.query_ball_point``):

- **Cell-list cube scan**: each query scans the anisotropic cell cube that
  contains its ball (per-dimension Chebyshev cell radius
  ``ceil(r_max / h_d)``), each cell one contiguous slice of the sorted
  storage with the tree's fullest cell as slice cap, so nothing truncates.
- **Dense masked scan**: every query against every point, streamed over
  point blocks; periodic displacements wrap with the tree's ``boxsize``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cells import CellList
from .knn import _divisor_block, cube_window, query_cells
from .metrics import sq_dist

#: cap on cells per query cube before the dense scan takes over
MAX_CUBE_CELLS = 2048

#: per-chunk candidate-transient budget (elements of the [qc, M, ccap] block)
CHUNK_BUDGET = 1 << 25


def _dense_count(tree: CellList, queries, r2, block: int):
    box = ([float(v) for v in tree.boxsize] if tree.periodic else None)
    qcols = [queries[:, d:d + 1] for d in range(3)]
    xyz = tree.xyz
    acc = torch.zeros(queries.shape[0], dtype=torch.int32,
                      device=queries.device)
    for s in range(0, tree.npad, block):
        d2 = sq_dist(qcols, xyz[0, s:s + block], xyz[1, s:s + block],
                     xyz[2, s:s + block], box)
        slot = torch.arange(s, s + block, device=queries.device)
        ok = (d2 <= r2[:, None]) & (slot < tree.n)
        acc += ok.sum(dim=1, dtype=torch.int32)
    return acc


def _cell_count(tree: CellList, queries, r2, rc, ccap: int):
    # with ccap >= the fullest cell no window truncates a cell
    qw, qcell = query_cells(tree, queries)
    _, slot, valid_c, _, _ = cube_window(tree, qcell, rc, ccap)
    box = ([float(d) * float(h) for d, h in zip(tree.dims, tree.cell_size)]
           if tree.periodic else None)
    d2 = sq_dist([qw[:, d, None, None] for d in range(3)], tree.xyz[0][slot],
                 tree.xyz[1][slot], tree.xyz[2][slot], box)
    ok = valid_c & (d2 <= r2[:, None, None])
    return ok.sum(dim=(1, 2), dtype=torch.int32)


def ball_count(tree: CellList, queries, radius, chunk: int = 16384,
               engine: str = "auto") -> np.ndarray:
    """Count points within ``radius`` of each query (inclusive boundary);
    int32 numpy [Q].

    ``radius`` may be a scalar or a per-query array; the cube engine sizes
    its cell cube from the largest radius and masks per query. ``engine``:
    "auto" picks by profitability; "cells" / "dense" force one.
    """
    if engine not in ("auto", "cells", "dense"):
        raise ValueError(f"engine must be auto, cells or dense, got {engine!r}")
    queries = np.asarray(queries, np.float32)
    Q = queries.shape[0]
    r = np.broadcast_to(np.asarray(radius, np.float32), (Q,)).astype(np.float32)
    if Q == 0:
        return np.empty((0,), np.int32)
    npad = tree.npad
    r_max = float(r.max())
    rc = tuple(int(np.ceil(r_max * float(tree.inv_cell_size[d])))
               for d in range(3))
    M = int(np.prod([2 * c + 1 for c in rc]))
    ccap = min(max(int(tree.max_cell_count), 1), npad)
    if engine == "auto":
        use_cells = tree.n > 0 and M <= MAX_CUBE_CELLS and M * ccap < npad
    else:
        use_cells = engine == "cells" and tree.n > 0

    dev = tree.device
    q_t = torch.as_tensor(queries, device=dev)
    r2_t = torch.as_tensor(np.where(r >= 0, r * r, np.float32(-1.0)),
                           device=dev)
    if use_cells:
        qc = int(min(max(CHUNK_BUDGET // max(M * ccap, 1), 1), chunk, 4096))
    else:
        block = _divisor_block(npad, min(4096, npad))
        qc = min(chunk, Q)
    out = []
    for s in range(0, Q, qc):
        if use_cells:
            out.append(_cell_count(tree, q_t[s:s + qc], r2_t[s:s + qc], rc,
                                   ccap))
        else:
            out.append(_dense_count(tree, q_t[s:s + qc], r2_t[s:s + qc],
                                    block))
    return torch.cat(out).cpu().numpy()
