"""The top-k kernel's visit-then-skip rule (``csrc/knn_topk.cu``), pinned on
the CPU against its plain version ``knn_cuda.knn_topk_reference``.

The kernel no longer scores every candidate of a piece. Per query it scores
the cells within one z-cell of the query's own cell in every column segment
of the piece's runs (the window), then walks each column up and down,
stopping at the first cell whose lower bound on d2 exceeds the k-th best; it
skips any cell whose bound does so, and it keeps its k best ordered by (d2,
candidate position). A torch mirror of those steps, written here the way the
kernel computes them (float32 scalars, the same margin, the same fused
multiply-adds), must give ``knn_topk_reference``'s d2 and slots bit for bit,
while scanning fewer cells than the runs hold:

- on random inputs, and on a 1/(2 dims) lattice where ties and points on
  cell faces abound;
- on FULLZ plans, on ZSEG plans (a dense tree, and z-segments forced on an
  ordinary one), in periodic and open boxes, and with 3 cells in x;
- for k in {1, 16, 100, 128}.

The kernel's min-image wrap, a compare-and-select, equals the JAX package's
``d - L * rint(d * invL)`` bit for bit (up to the sign of a zero).
"""
import bisect
import math
import struct

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch.core.cells import build_cell_list
from nbodyhpc_tpu_torch.ops import knn_cuda as tkc
from nbodyhpc_tpu_torch.ops import knn_device as tkd
from nbodyhpc_tpu_torch.ops.metrics import sq_dist, wrap_min_image

f32 = np.float32
SHRINK = f32(1.0 - 2.0 ** -20)  # the kernel's relative margin


def _fma(a, b, c):
    """float32 fmaf of float32 scalars: the exact product plus c, rounded to
    odd in float64, then once to float32."""
    a, b, c = float(a), float(b), float(c)
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0 and struct.unpack("<q", struct.pack("<d", s))[0] & 1 == 0:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return f32(s)


class _Grid:
    """The kernel's Grid, from the wrapper's own arguments."""

    def __init__(self, grid, periodic):
        a = tkc._grid_args(grid)
        self.C = a[0:3]
        self.lo, self.h, self.ih, self.marg = (
            [f32(v) for v in a[3 + 3 * i:6 + 3 * i]] for i in range(4))
        self.periodic = periodic

    def query_axis(self, q, d):
        c = int(np.floor(f32(f32(q - self.lo[d]) * self.ih[d])))
        C = self.C[d]
        c = c % C if self.periodic else min(max(c, 0), C - 1)
        return c, f32(q - f32(f32(f32(c) * self.h[d]) + self.lo[d]))

    def axis_gap(self, m, ax, d):
        def slab(mm):
            below = f32(f32(f32(mm) * self.h[d]) - ax[1])
            above = f32(ax[1] - f32(f32(mm + 1) * self.h[d]))
            return max(max(below, above), f32(0))

        gap = slab(m)
        if self.periodic:
            gap = min(gap, slab(m - self.C[d]))
            gap = min(gap, slab(m + self.C[d]))
        return max(f32(f32(gap * SHRINK) - self.marg[d]), f32(0))


def mirror_topk(tree, plan, st, k):
    """The kernel's rule on every sorted query row: (d2 [Q, k], slot [Q, k],
    cells scanned, cells the runs hold)."""
    g = _Grid(tkd.cell_grid(tree, plan), tree.periodic)
    Cy, Cz = g.C[1], g.C[2]
    box = list(plan.box) if tree.periodic else None
    off = tree.offsets.tolist()
    xyz = tree.xyz
    rstart, rlen = plan.run_start.tolist(), plan.run_len.tolist()
    rcell, rncell = plan.run_cell.tolist(), plan.run_ncell.tolist()
    Q = st.qs.shape[0]
    out_d = torch.full((Q, k), float("inf"))
    out_s = torch.full((Q, k), -1, dtype=torch.int32)
    scanned = held = 0
    for row in range(Q):
        pid = int(st.pid[row])
        qv = [st.qs[row, d].reshape(()) for d in range(3)]
        ax = [g.query_axis(f32(float(qv[d])), d) for d in range(3)]
        qz = ax[2][0]
        top = []

        def kth():
            return top[-1][0] if len(top) == k else math.inf

        def scan(cell, base):
            s0, s1 = off[cell], off[cell + 1]
            d2 = sq_dist(qv, xyz[0, s0:s1], xyz[1, s0:s1], xyz[2, s0:s1], box)
            for j, dv in enumerate(d2.tolist()):
                item = (dv, base + s0 + j)
                if len(top) < k or item < top[-1]:
                    bisect.insort(top, item)
                    del top[k:]

        for phase in (0, 1):
            pre = 0
            for r in range(len(rstart[pid])):
                c0, nc = rcell[pid][r], rncell[pid][r]
                base = pre - rstart[pid][r]
                pre += rlen[pid][r]
                if nc <= 0:
                    continue
                if phase == 0:
                    held += nc
                for col in range(c0 // Cz, (c0 + nc - 1) // Cz + 1):
                    za = max(c0, col * Cz) - col * Cz
                    zb = min(c0 + nc, (col + 1) * Cz) - col * Cz
                    gx = g.axis_gap(col // Cy - ax[0][0], ax[0], 0)
                    gy = g.axis_gap(col % Cy - ax[1][0], ax[1], 1)
                    gxy = _fma(gx, gx, f32(gy * gy))
                    if gxy > kth():
                        continue
                    if phase == 0:
                        nw = min(Cz, 3) if g.periodic else 3
                        for m in (0, 1, -1)[:nw]:
                            z = (qz + m) % Cz if g.periodic else qz + m
                            if not za <= z < zb:
                                continue
                            gz = g.axis_gap(m, ax[2], 2)
                            if _fma(gz, gz, gxy) > kth():
                                continue
                            scan(col * Cz + z, base)
                            scanned += 1
                        continue
                    mu = Cz // 2 if g.periodic else Cz - 1 - qz
                    md = (Cz + 1) // 2 - 1 if g.periodic else qz
                    for sgn, mmax in ((1, mu), (-1, md)):
                        for m in range(2, mmax + 1):
                            gz = g.axis_gap(sgn * m, ax[2], 2)
                            if _fma(gz, gz, gxy) > kth():
                                break
                            z = qz + sgn * m
                            z = z % Cz if g.periodic else z
                            if za <= z < zb:
                                scan(col * Cz + z, base)
                                scanned += 1
        for j, (dv, pos) in enumerate(top):
            if dv == math.inf:
                break
            out_d[row, j] = dv
            pre = 0
            for r in range(len(rstart[pid])):
                if pos < pre + rlen[pid][r]:
                    out_s[row, j] = rstart[pid][r] + pos - pre
                    break
                pre += rlen[pid][r]
    return out_d, out_s, scanned, held


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

# (plan, box, inputs): box is "periodic", "open" or "cx3" (periodic, 3 cells
# in x); plan is "fullz" (the tree's own plan), "zseg" (3-cell z-segments
# forced on an ordinary tree) or "dense" (a thin column: the tree's own plan
# is ZSEG); "sparse" inputs hold 2 points per cell, so the walks go round
# whole columns and large k finds fewer candidates than it asks for
CASES = [
    ("fullz", "periodic", "random"), ("fullz", "periodic", "lattice"),
    ("fullz", "open", "random"), ("fullz", "open", "lattice"),
    ("zseg", "periodic", "random"), ("zseg", "open", "lattice"),
    ("dense", "periodic", "random"),
    ("fullz", "cx3", "random"), ("fullz", "cx3", "lattice"),
    ("fullz", "periodic", "sparse"), ("fullz", "open", "sparse"),
]
NQ = 64


def _inputs(plan_kind, box_kind, kind, seed):
    """(points [n, 3], queries [NQ, 3], boxsize or None), float32."""
    rng = np.random.Generator(np.random.Philox(seed))
    if box_kind == "cx3":
        box = np.array([1.0, 2.0, 2.0])
        dims = np.array([3, 6, 6])       # 8 points per cell: n = 864
    else:
        box = np.ones(3)
        dims = np.array([6, 6, 6])       # n = 1728
    n = int((2 if kind == "sparse" else 8) * dims.prod())
    if plan_kind == "dense":
        n = 20_000  # one column overflows the FULLZ budget
    if kind == "lattice":
        pts = rng.integers(0, 2 * dims, (n, 3)) / (2 * dims) * box
    else:
        pts = rng.random((n, 3)) * box
    if plan_kind == "dense":
        pts[:, :2] *= 1e-3
    pts = pts.astype(np.float32)
    q = np.concatenate([pts[rng.integers(0, n, NQ // 2)],
                        (rng.random((NQ - NQ // 2, 3)) * box)])
    if kind == "lattice":
        q[NQ // 2:] = (rng.integers(0, 2 * dims, (NQ - NQ // 2, 3))
                       / (2 * dims) * box)
    if box_kind == "open":
        q[-8:] = rng.random((8, 3)) * 1.6 - 0.3   # some outside the points
    if plan_kind == "dense":
        q[:, :2] *= 1e-3
    q = q.astype(np.float32)
    return pts, q, (None if box_kind == "open" else tuple(box))


def _staged(plan_kind, box_kind, kind, seed):
    pts, q, boxsize = _inputs(plan_kind, box_kind, kind, seed)
    tree = build_cell_list(torch.from_numpy(pts), boxsize=boxsize,
                           occupancy=2.0 if kind == "sparse" else 8.0)
    assert tree.dims.tolist() == ([3, 6, 6] if box_kind == "cx3" else
                                  [6, 6, 6]) or plan_kind == "dense"
    plan = tkd.tree_plan(tree)
    if box_kind == "cx3":
        assert int(tree.dims[0]) == 3 and tree.periodic
    if plan_kind == "dense":
        assert not plan.fullz
    elif plan_kind == "zseg":
        zseg = 3
        nseg = -(-int(tree.dims[2]) // zseg)
        npair = (int(tree.dims[0]) * int(tree.dims[1]) + 1) // 2
        s, ln, cells, c0, nc = tkd._build_static_tables(tree, zseg, nseg,
                                                        npair)
        plan = tkd.KernelPlan(False, zseg, nseg, s, ln, cells,
                              ln.sum(1, dtype=torch.int32), plan.box, c0, nc)
    else:
        assert plan.fullz
    return tree, plan, tkd._stage_sort(tree, plan, torch.from_numpy(q))


@pytest.mark.parametrize("k", [1, 16, 100, 128])
@pytest.mark.parametrize("plan_kind,box_kind,kind", CASES,
                         ids=["-".join(c) for c in CASES])
def test_window_rule_equals_full_scan(plan_kind, box_kind, kind, k):
    tree, plan, st = _staged(plan_kind, box_kind, kind, 100 + k)
    d2, slot, scanned, held = mirror_topk(tree, plan, st, k)
    want_d, want_s = tkc.knn_topk_reference(
        st.qs.T.contiguous(), st.piece_q0, st.piece_qn, st.piece_pid,
        plan.run_start, plan.run_len, tree.xyz, plan.box, k)
    assert torch.equal(d2.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(slot, want_s)
    # the rule proves cells away rather than scanning every candidate (a
    # sparse tree at large k needs them all), and never scans one twice
    assert scanned < held or (kind == "sparse" and scanned == held)
    if kind == "lattice" and k > 1:  # ties at equal distance met and broken
        finite = torch.isfinite(want_d)
        assert bool(((want_d[:, 1:] == want_d[:, :-1]) & finite[:, 1:]).any())


def _select_wrap(d, L):
    """The kernel's wrap: compare-and-select on t = d * (1/L)."""
    t = d * f32(1.0 / L)
    return torch.where(t > 0.5, d - f32(L), torch.where(t < -0.5, d + f32(L),
                                                        d))


@pytest.mark.parametrize("L", [1.0, 0.75, 2.0 / 3.0, 1000.0 / 3.0, 1e-3])
def test_select_wrap_equals_rint_wrap(L):
    L = float(f32(L))
    rng = np.random.Generator(np.random.Philox(9))
    edges = np.array([0.5 * L, -0.5 * L, L, -L, 0.0, -0.0], np.float32)
    near = np.concatenate([np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])
    d = torch.from_numpy(np.concatenate([
        edges, near, (rng.random(20000) * 2 - 1).astype(np.float32) * f32(L)
    ]).astype(np.float32))
    want = wrap_min_image(d, L)
    got = _select_wrap(d, L)
    # equal bits once a zero's sign is dropped, and equal squares
    assert torch.equal((got + 0.0).view(torch.int32),
                       (want + 0.0).view(torch.int32))
    assert torch.equal((got * got).view(torch.int32),
                       (want * want).view(torch.int32))
