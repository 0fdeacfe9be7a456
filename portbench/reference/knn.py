"""Plain reference of periodic k nearest neighbours.

Exact k-NN in a periodic box by a uniform grid of cells at several
resolutions: a query takes the k best of the 27 cells around its own and
is done when its k-th distance is within the cube's nearest face;
otherwise it tries the next coarser grid, and past the coarsest, every
point. Distances are the minimum-image metric in ``dtype`` (float64 for the
reference, a lower precision for the control). Plain torch only.
"""
from __future__ import annotations

import torch

PAIRS = 1 << 24  # (query, candidate) pairs held at once


def min_image_d2(a, b, box: float):
    """Squared minimum-image distances between rows of ``a`` and ``b``."""
    d = a - b
    d = d - box * torch.round(d / box)
    return (d * d).sum(-1)


def _levels(n: int, target: float):
    m = max(3, int((n / target) ** (1.0 / 3.0)))
    while m >= 3:
        yield m
        m //= 2


class _Grid:
    def __init__(self, pts, box: float, m: int):
        self.m, self.h = m, box / m
        c = torch.clamp((pts / self.h).long(), 0, m - 1)
        cid = (c[:, 0] * m + c[:, 1]) * m + c[:, 2]
        cid, self.order = torch.sort(cid, stable=True)
        self.starts = torch.searchsorted(
            cid, torch.arange(m ** 3 + 1, device=pts.device))

    def cube(self, q):
        """(cells [Q, 27], distance to the 27-cell cube's nearest face)."""
        m, h = self.m, self.h
        qc = torch.clamp((q / h).long(), 0, m - 1)
        d = torch.arange(-1, 2, device=q.device)
        off = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), -1)
        c = (qc[:, None, :] + off.reshape(1, 27, 3)) % m
        cells = (c[..., 0] * m + c[..., 1]) * m + c[..., 2]
        lo = (qc - 1).to(q.dtype) * h
        hi = (qc + 2).to(q.dtype) * h
        face = torch.minimum(q - lo, hi - q).min(1).values
        return cells, face


def _topk_pairs(qid, d2, nq: int, k: int):
    """Per query the k smallest of its pairs: (d2 [nq, k], slot [nq, k]),
    inf and -1 where a query has fewer than k."""
    o = torch.argsort(d2, stable=True)
    o = o[torch.argsort(qid[o], stable=True)]
    q, v = qid[o], d2[o]
    cnt = torch.bincount(q, minlength=nq)
    first = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(q.numel(), device=q.device) - first[q]
    keep = rank < k
    out = torch.full((nq, k), float("inf"), dtype=d2.dtype, device=d2.device)
    slot = torch.full((nq, k), -1, dtype=torch.long, device=d2.device)
    out[q[keep], rank[keep]] = v[keep]
    slot[q[keep], rank[keep]] = o[keep]
    return out, slot


def _cube_pass(grid, pts, q, k: int, box: float):
    """k best of each query's 27 cells, and whether that is certified."""
    cells, face = grid.cube(q)
    cnt = grid.starts[cells + 1] - grid.starts[cells]           # [Q, 27]
    tot = cnt.sum(1)
    d2 = torch.full((q.shape[0], k), float("inf"), dtype=q.dtype,
                    device=q.device)
    idx = torch.full((q.shape[0], k), -1, dtype=torch.long, device=q.device)
    ends = torch.cumsum(tot, 0)
    b0 = 0
    while b0 < q.shape[0]:
        lim = (ends[b0 - 1] if b0 else 0) + PAIRS
        b1 = max(b0 + 1, int(torch.searchsorted(ends, lim, right=True)))
        b1 = min(b1, q.shape[0])
        c = cells[b0:b1].reshape(-1)
        n = cnt[b0:b1].reshape(-1)
        seg = torch.repeat_interleave(torch.arange(c.numel(), device=c.device),
                                      n)
        first = torch.cumsum(n, 0) - n
        within = torch.arange(seg.numel(), device=c.device) - first[seg]
        pid = grid.order[grid.starts[c][seg] + within]
        qid = seg // 27
        dd = min_image_d2(pts[pid], q[b0:b1][qid], box)
        bd, slot = _topk_pairs(qid, dd, b1 - b0, k)
        d2[b0:b1] = bd
        idx[b0:b1] = torch.where(slot >= 0, pid[slot.clamp_min(0)], -1)
        b0 = b1
    ok = torch.isfinite(d2[:, -1]) & (d2[:, -1] <= face * face)
    return d2, idx, ok


def _brute(pts, q, k: int, box: float):
    rows = max(1, PAIRS // max(1, pts.shape[0]))
    ds, ids = [], []
    for s in range(0, q.shape[0], rows):
        dd = min_image_d2(pts[None, :, :], q[s:s + rows, None, :], box)
        kk = min(k, pts.shape[0])
        v, i = torch.topk(dd, kk, dim=1, largest=False, sorted=True)
        if kk < k:
            pad = k - kk
            v = torch.cat([v, v.new_full((v.shape[0], pad), float("inf"))], 1)
            i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
        ds.append(v)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def knn(points, queries, k: int, box: float, dtype=torch.float64,
        target: float = 8.0):
    """Exact periodic k-NN: (distances [Q, k] ascending, indices [Q, k]
    int64), computed in ``dtype`` on the points' device."""
    pts = torch.as_tensor(points).to(dtype)
    q = torch.as_tensor(queries, device=pts.device).to(dtype)
    box_t = float(box)
    d2 = torch.full((q.shape[0], k), float("inf"), dtype=dtype,
                    device=pts.device)
    idx = torch.full((q.shape[0], k), -1, dtype=torch.long, device=pts.device)
    todo = torch.arange(q.shape[0], device=pts.device)
    for m in _levels(pts.shape[0], target):
        if not todo.numel():
            break
        grid = _Grid(pts, box_t, m)
        bd, bi, ok = _cube_pass(grid, pts, q[todo], k, box_t)
        d2[todo[ok]] = bd[ok]
        idx[todo[ok]] = bi[ok]
        todo = todo[~ok]
    if todo.numel():
        bd, bi = _brute(pts, q[todo], k, box_t)
        d2[todo] = bd
        idx[todo] = bi
    return torch.sqrt(d2), idx

