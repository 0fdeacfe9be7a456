"""Sharded summary statistics: the kNN-CDF over the mesh.

PyTorch port of :mod:`nbodyhpc_tpu.parallel.stats`: the random query set is
cut by rank and the histogram summed with ``all_reduce`` (SURVEY.md §5.8's
"global reductions (total mass, kNN-CDF statistics) via psum").
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.cells import CellList
from ..core.points import round_up
from ..ops import knn as _knn
from .mesh import SlabMesh
from .sharded import _tree_mesh, _wire


def cdf_queries(tree: CellList, n_queries: int, nd: int, seed: int = 0):
    """The JAX function's query set on ``nd`` ranks: (queries [nd * qloc,
    3] float32 numpy, qloc), uniform over the tree's box from one
    ``Philox(seed)`` stream; rank r answers rows ``[r * qloc, (r + 1) *
    qloc)``. ``qloc`` rounds ``ceil(n_queries / nd)`` up to the JAX
    function's chunk, so the count depends on ``nd``."""
    rng = np.random.Generator(np.random.Philox(seed))
    if tree.periodic:
        lo = np.zeros(3)
        hi = tree.boxsize.astype(np.float64)
    else:
        lo = tree.lo.astype(np.float64)
        hi = lo + tree.cell_size.astype(np.float64) * tree.dims
    # the JAX function's chunk, which bounds its per-pass candidate block;
    # here it only rounds qloc (so it sets the result): each rank answers
    # its slice in one call
    ladder = _knn.default_ladder(tree)
    bmax = max(((2 * r + 1) ** 3) * c for r, c in ladder)
    ch = int(min(max((n_queries + nd - 1) // nd, 1),
                 max(2048, (1 << 25) // bmax)))
    ch = round_up(ch, 8)
    qloc = round_up(max((n_queries + nd - 1) // nd, 1), ch)
    q = (lo + rng.random((nd * qloc, 3)) * (hi - lo)).astype(np.float32)
    return q, qloc


def knn_cdf_sharded(tree: CellList, k, radii, n_queries: int = 65536,
                    mesh: SlabMesh | None = None, seed: int = 0):
    """kNN-CDFs with the random query set sharded over the mesh and the
    histogram summed over it. Returns (radii float32 [R], cdf float32
    [len(k), R]) on every rank.

    Equal to the JAX function's result on a mesh of the same size: the
    query count ``nd * qloc`` (so the result) depends on the mesh size, as
    there. Every rank draws the whole ``Philox(seed)`` stream and answers
    its slice of ``qloc`` queries in one :func:`..ops.knn.cell_knn_query`
    call (the candidate kernels on the card).
    """
    mesh = _tree_mesh(tree, mesh)
    nd, s = mesh.size, mesh.rank

    ks = tuple(int(v) for v in (k if np.ndim(k) else (k,)))
    kmax = max(ks)
    radii = np.asarray(radii, np.float32)

    q, qloc = cdf_queries(tree, n_queries, nd, seed)
    dist_k = _knn.cell_knn_query(tree, q[s * qloc:(s + 1) * qloc],
                                 kmax).distances
    kth = dist_k[:, [kk - 1 for kk in ks]]  # [qloc, nk]
    r_t = torch.as_tensor(radii, device=kth.device)
    hist = (kth[:, :, None] <= r_t[None, None, :]).sum(0, dtype=torch.int64)
    hist = _wire(mesh, hist)
    if mesh.group is not None:
        dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=mesh.group)
    # exact integer counts; the JAX function sums float32 counts with psum,
    # which is exact while every bin holds fewer than 2^24, and divides in
    # float32: so does this
    cdf = hist.cpu().numpy().astype(np.float32) / (nd * qloc)
    return radii, cdf
