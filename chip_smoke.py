#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbodyhpc_tpu_torch``) on one GPU.

Builds the kernels from ``nbodyhpc_tpu_torch/csrc/`` with nvcc, holds each
against its plain PyTorch version on the card, drives the volume render
(``nbodyhpc_tpu_torch.rasterizer.render_points_volume``) at a moderate size
against the same render on the CPU, then at full size: 256^3 particles into
a 1024^3 grid, periodic, subsample 4; then (phase 6) writes that set to a
particle file, reads it back, renders it through the demo's ``--file`` path
and streams it in batches; after the k-NN phases (phase 8) spawns ranks
of the sharded path (``nbodyhpc_tpu_torch.parallel``): one NCCL rank, then
two gloo ranks sharing the card at full size, each held to the single
process; then (phase 7) sends itself SIGINT during a long k-NN query and
during a streamed render, and checks the calls after; last (phase 6b), it
profiles one render of the file with ``profiling.trace``. Every phase is an assertion; any failure exits
non-zero before the result line. Needs one CUDA device and
``nvcc`` (sm_90a); run from the repository root:

    python3 chip_smoke.py [--baseline-deposit PATH] [--baseline-topk PATH]
                          [--baseline-dist PATH]

``--baseline-deposit`` builds another source of the deposit kernel (the
same C entry point, for example an earlier commit's
``csrc/splat_deposit.cu``) and times it against the package's kernel in
turns, on the full-size streams and in the device render.
``--baseline-topk`` does the same for the k-NN top-k kernel B3, over all
pieces of the harness at every k that kNN-1 runs, with a ``knn_topk.cu``
of either design: the full-scan one (the C entry point without the cell
grid, as of the commit before B3's redesign) or one with the package's own
C entry point. Its ``knn_common.h`` must lie beside it.
``--baseline-dist`` takes another ``knn_dist.cu`` (the C entry point
``knn_dist``, for example the one-block-per-piece kernel of the commit before
B4's redesign, its ``knn_common.h`` beside it) and times its distance block
against the package's block sink in turns, in kNN-2.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path
(and on the sharded path, summed over ranks),
its largest difference from its plain version, both times and its bound:
the least time the card could take for the same work, the larger of its
bytes over the memory rate and its float32 instructions over the
instruction rate.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import torch

from nbodyhpc_tpu_torch.utils import profiling
from nbodyhpc_tpu_torch.utils.profiling import device_busy_ms, synced

SEED = 2024
# atomics reorder float sums; built with --fmad=false, so no subcell quantum
RTOL, ATOL = 2e-5, 1e-6
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s, and
# float32 instructions/s (67 TFLOP/s counting an FMA as two operations)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 3.35e13
# float32 instructions per (query, candidate) pair, counted from the
# function, not from a kernel's code (periodic): per axis sub, mul by 1/L,
# round, mul by L, sub (15), then dy*dy and two fmaf (3); B3 adds the
# compare against its k-th best
B3_INSTR, B4_INSTR = 19, 18
# bytes a deposit must move: the attribute row it reads (7 floats), and a
# read and a write of each voxel it changes
DEPOSIT_ROW_BYTES, VOXEL_RMW_BYTES = 28, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference; fails past |got - want| <= ATOL + RTOL |want|."""
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    diff = (got - want).abs()
    bad = int((diff > ATOL + RTOL * want.abs()).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    if bad:
        fail(f"{name}: {bad} voxels outside rtol {RTOL} atol {ATOL} "
             f"(max abs err {err:.3e})")
    return err


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up
    (CUDA events around the run)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, ops: float = 0.0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 instructions over the instruction rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(fn) -> float:
    """Device time of one ``fn()`` (CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def gated_voxels(attrs, nchunks: int, geom, grid) -> int:
    """Voxels the oracle's gates admit in the first ``nchunks`` chunks of a
    bucket stream, inside window and grid: per particle and z slice of its
    window the z-cull, and the number of x (times y) voxels whose centre
    offsets lie in [-half, half), found by a search over the window's
    ascending offsets. A sub-pixel particle counts its one voxel."""
    F = geom.F
    a = attrs[:, :nchunks * geom.CH]
    a = a[:, (a[4] != 0.0) | (a[5] != 0.0)]
    g = torch.tensor(grid, device=a.device)[:, None, None]
    off = torch.arange(F, device=a.device)
    total, step = 0, 1 << 19
    for s in range(0, a.shape[1], step):
        p = a[0:3, s:s + step]
        r = a[3, s:s + step]
        sub = a[6, s:s + step] > 0.5
        v = torch.ceil(p - (F / 2 + 0.5)).int()[:, :, None] + off  # (3, m, F)
        vf = v.float()
        inside = (v >= 0) & (v < g)
        zoff = p[2, :, None] - (vf[2] + 0.5)
        zclip = (zoff.abs() <= r[:, None] + 1.0) & inside[2]
        half = torch.ceil(torch.sqrt(torch.clamp_min(
            (r * r)[:, None] - zoff * zoff, 0.0))) + 1.0
        n = []
        for d in range(2):
            c = (vf[d] + 0.5) - p[d, :, None]
            c = torch.where(v[d] < 0, float("-inf"),
                            torch.where(v[d] >= g[d], float("inf"), c))
            n.append(torch.searchsorted(c, half) - torch.searchsorted(c, -half))
        big = (n[0] * n[1] * zclip).sum(1)
        vsub = torch.stack([torch.floor(p[0]), torch.floor(p[1]),
                            torch.ceil(p[2]) - 1]).long()
        one = ((vsub >= 0) & (vsub < g[:, :, 0])).all(0).long()
        total += int(torch.where(sub, one, big).sum())
    return total


def load_baseline_source(src: str, entry: str, argtypes):
    """The C entry point ``entry`` of another kernel source (with the
    headers beside it), built with the package's flags into its gitignored
    kernel directory."""
    import hashlib
    from pathlib import Path

    from nbodyhpc_tpu_torch import _build

    h = hashlib.sha256()
    for f in [Path(src), *sorted(Path(src).parent.glob("*.h"))]:
        h.update(f.read_bytes())
    out = _build.KERNEL_DIR / f"libbaseline_{entry}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.find_nvcc() or "nvcc", *_build.NVCC_FLAGS, "-shared",
               "-o", str(out), src]
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if done.returncode:
            fail(f"baseline build failed: {' '.join(cmd)}\n{done.stdout}"
                 f"{done.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# the full-scan B3's C entry point: q qstride piece_q0 piece_qn piece_pid
# npieces run_start run_len nruns xyz xstride periodic L0 L1 L2 iL0 iL1 iL2
# out_d2 out_slot k row_base stream
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
FULLSCAN_TOPK_ARGS = (_P, _LL, _P, _P, _P, _I, _P, _P, _I, _P, _LL, _I,
                      *(_F,) * 6, _P, _P, _I, _I, _P)


def fullscan_topk(fn, q, q0, qn, pid, run_start, run_len, xyz, box, k: int):
    """(d2, slot) [Q, k] of the full-scan B3 entry point ``fn`` over every
    piece (one block per piece, every candidate scored)."""
    from nbodyhpc_tpu_torch import _build
    from nbodyhpc_tpu_torch.ops import knn_cuda as kc

    nrows = q.shape[1]
    out_d = torch.empty((nrows, k), device=q.device)
    out_s = torch.empty((nrows, k), dtype=torch.int32, device=q.device)
    err = fn(q.data_ptr(), nrows, q0.data_ptr(), qn.data_ptr(),
             pid.data_ptr(), q0.numel(), run_start.data_ptr(),
             run_len.data_ptr(), run_start.shape[1], xyz.data_ptr(),
             xyz.shape[1], *kc._box_args(box), out_d.data_ptr(),
             out_s.data_ptr(), k, 0,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "full-scan knn_topk launch")
    return out_d, out_s


def baseline_topk(path: str):
    """``fn(args, k, grid) -> (d2, slot)`` running the B3 of another
    ``knn_topk.cu`` over all pieces: a full-scan source through its own C
    entry point, or one with the package's entry point (it reads the cell
    grid) through ``knn_cuda.knn_topk``."""
    from pathlib import Path

    from nbodyhpc_tpu_torch import _build
    from nbodyhpc_tpu_torch.ops import knn_cuda as kc

    if "run_cell" not in Path(path).read_text():
        fn = load_baseline_source(path, "knn_topk", FULLSCAN_TOPK_ARGS)
        return lambda args, k, grid: fullscan_topk(fn, *args, k)
    real = _build.load()
    lib = real._replace(lib=_SwappedLib(real.lib, "knn_topk", load_baseline_source(
        path, "knn_topk", _build.SIGNATURES["knn_topk"])))

    def run(args, k, grid):
        with mock.patch.object(_build, "load", lambda: lib):
            return kc.knn_topk(*args, k, grid=grid)
    return run


def baseline_dist(path: str):
    """``fn(args) -> block`` running the ``knn_dist`` of another
    ``knn_dist.cu`` through ``knn_cuda.knn_dist``."""
    from nbodyhpc_tpu_torch import _build
    from nbodyhpc_tpu_torch.ops import knn_cuda as kc

    real = _build.load()
    lib = real._replace(lib=_SwappedLib(real.lib, "knn_dist", load_baseline_source(
        path, "knn_dist", _build.SIGNATURES["knn_dist"])))

    def run(args):
        with mock.patch.object(_build, "load", lambda: lib):
            return kc.knn_dist(*args)
    return run


def b3_bytes(points: int, nq: int, k: int) -> int:
    """B3's bytes: each tree point read once (12 B), each query read once
    (12 B), each result written once (8 B per entry)."""
    return 12 * points + 12 * nq + 8 * k * nq


def window_work(cl, plan, st):
    """The window of the staged queries at these inputs, counted on the
    card: (pairs [Q] int64, points). Pairs: per sorted query, the points of
    its 27-cell cube that lie in its piece's runs; points: the tree points
    those pairs touch. Assumes at least 3 cells per axis (no cell of a cube
    repeats)."""
    dims = [int(v) for v in cl.dims]
    if min(dims) < 3:
        fail(f"window_work: dims {dims} below 3")
    off = cl.offsets.long()
    counts = off[1:] - off[:-1]
    touched = torch.zeros(cl.ncells, dtype=torch.bool, device=off.device)
    pairs = []
    rc = plan.run_cell.long()
    rn = plan.run_ncell.long()
    d = torch.arange(-1, 2, device=off.device)
    cube = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), -1).reshape(
        -1, 3)
    for r0 in range(0, st.qcs.shape[0], 1 << 17):
        qc = st.qcs[r0:r0 + (1 << 17)]
        c = qc[:, None, :] + cube[None]                    # [q, 27, 3]
        ok = torch.ones(c.shape[:2], dtype=torch.bool, device=c.device)
        for a in range(3):
            if cl.periodic:
                c[..., a] %= dims[a]
            else:
                ok &= (c[..., a] >= 0) & (c[..., a] < dims[a])
                c[..., a] = c[..., a].clamp(0, dims[a] - 1)
        ids = (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
        pid = st.pid[r0:r0 + (1 << 17)].long()
        lo, n = rc[pid][:, None, :], rn[pid][:, None, :]    # [q, 1, R]
        inrun = ((ids[..., None] >= lo) & (ids[..., None] < lo + n)).any(-1)
        use = ok & inrun
        pairs.append(torch.where(use, counts[ids], 0).sum(1))
        touched[ids[use]] = True
    return torch.cat(pairs), int(counts[touched].sum())


class _SwappedLib:
    """The kernel library with the entry point ``name`` replaced by ``fn``."""

    def __init__(self, lib, name, fn):
        self._lib, self._name, self._fn = lib, name, fn

    def __getattr__(self, name):
        return self._fn if name == self._name else getattr(self._lib, name)


def lognormal_workload(n: int, grid: int, gen: torch.Generator):
    """bench.py's render workload at size n: positions uniform in the unit
    box, radii exp(0.35 N(0,1)) times the mean spacing grid / n^(1/3)
    pixels, floored at 0.1 px; unit weights. Made on the card."""
    dev = gen.device
    spacing_px = grid / n ** (1.0 / 3.0)
    pos = torch.rand((n, 3), generator=gen, device=dev)
    rpx = torch.clamp_min(
        torch.exp(0.35 * torch.randn(n, generator=gen, device=dev))
        * spacing_px, 0.1)
    return pos, torch.ones(n, device=dev), rpx / grid


# the reference kd-tree harness: 1e7 points, 5e5 self-queries, k=16
# (BASELINE.md:10); its CPU binary answered 165,959 q/s (BASELINE.md:26)
KNN_N, KNN_Q, KNN_K = 10_000_000, 500_000, 16
REF_QPS = 165_959
# B3 at other k on the same inputs: knn_cdf's default reach (k <= 8), one
# neighbour, and the kernel's largest k
KNN_SWEEP_K = (1, 8, 128)
# the k > 128 route: a 1e6-point periodic tree, 2e4 random queries; cells
# of 64 points (leafsize 1024), so the r = 1 bound certifies the 200th
# neighbour and the kernel's answers reach the result (at the default 8 per
# cell every query would finish on the ladder)
KNN2_N, KNN2_Q, KNN2_K = 1_000_000, 20_000, 200
KNN2_LEAFSIZE = 1024
# B4's selection sink at its smallest k on the path and at its capacity
KNN2_SWEEP_K = (129, 256)
# a k above that capacity, which takes B4's distance blocks, on the first
# queries of the same batch
KNN2_BLOCK_K, KNN2_BLOCK_Q = 300, 10_000


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same float32 bit patterns, inf included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the finite entries of ``want``."""
    diff = torch.where(torch.isfinite(want), (got - want).abs(), 0.0)
    return float(diff.max()) if diff.numel() else 0.0


def brute_knn(cl, queries, k: int, qchunk: int = 512, block: int = 1 << 18):
    """Plain exact brute force on the card: every point of the cell list
    ``cl`` against every query, with the port's distance expression, the
    k + 1 nearest of each point block merged by a stable sort. Returns
    (d2 [Q, k + 1] ascending, tree slots [Q, k + 1])."""
    from nbodyhpc_tpu_torch.ops import knn
    from nbodyhpc_tpu_torch.ops.metrics import sq_dist

    box = ([float(d) * float(h) for d, h in zip(cl.dims, cl.cell_size)]
           if cl.periodic else None)
    qw, _ = knn.query_cells(cl, queries)
    kk = k + 1
    out_d, out_s = [], []
    for q0 in range(0, qw.shape[0], qchunk):
        cols = [qw[q0:q0 + qchunk, d:d + 1] for d in range(3)]
        m = cols[0].shape[0]
        best_d = torch.full((m, kk), float("inf"), device=qw.device)
        best_s = torch.zeros((m, kk), dtype=torch.int64, device=qw.device)
        for s in range(0, cl.n, block):
            e = min(s + block, cl.n)
            d2 = sq_dist(cols, cl.xyz[0, s:e], cl.xyz[1, s:e], cl.xyz[2, s:e],
                         box)
            v, i = torch.topk(d2, min(kk, e - s), dim=1, largest=False)
            cat_s = torch.cat([best_s, i + s], dim=1)
            best_d, sel = knn.select_k(torch.cat([best_d, v], dim=1), kk)
            best_s = torch.gather(cat_s, 1, sel)
        out_d.append(best_d)
        out_s.append(best_s)
    return torch.cat(out_d), torch.cat(out_s)


def check_sample(name: str, cl, queries, d, idx, k: int,
                 tol: float = 0.0) -> int:
    """Fails unless (d, idx) of ``queries`` equal the plain brute force:
    distances bit-equal (with ``tol``: within one ulp plus ``tol``), indices
    equal. The k nearest must be unique (no tie at the k-th distance); rows
    with equal distances inside the k (with ``tol``: closer than twice the
    tolerance) keep the engine's candidate order, so there the index sets
    are compared. Returns the number of such rows."""
    from nbodyhpc_tpu_torch.ops.metrics import sqrt_f32

    d2b, sb = brute_knn(cl, queries, k)
    edge = (d2b[:, k - 1] == d2b[:, k]) & torch.isfinite(d2b[:, k])
    if bool(edge.any()):
        fail(f"{name}: {int(edge.sum())} sample rows tie at the k-th "
             f"distance; the k nearest are not unique")
    want_d = sqrt_f32(d2b[:, :k])
    want_i = cl.index[sb[:, :k]].to(idx.dtype)
    if tol:
        slack = ulp_tolerance(want_d, tol)
        bad = int(((d - want_d).abs() > slack).any(1).sum())
        tied = ((want_d[:, 1:] - want_d[:, :-1]) <= 2 * slack[:, 1:]).any(1)
    else:
        bad = int((d.view(torch.int32) != want_d.view(torch.int32)).any(1)
                  .sum())
        tied = (d2b[:, 1:k] == d2b[:, :k - 1]).any(1)
    if bad:
        fail(f"{name}: distances of {bad} sample rows differ from brute force")
    same = (idx == want_i).all(1)
    same_set = (torch.sort(idx, 1).values == torch.sort(want_i, 1).values
                ).all(1)
    if not bool((same | (tied & same_set)).all()):
        fail(f"{name}: indices of {int((~same).sum())} sample rows differ "
             f"from brute force")
    return int(tied.sum())


def ulp_tolerance(want: torch.Tensor, tol: float) -> torch.Tensor:
    """One float32 ulp of each finite ``want`` plus ``tol``."""
    up = torch.nextafter(want, want.new_tensor(float("inf")))
    return torch.where(torch.isfinite(want), up - want + tol, 0.0)


# the slab-sharded tree's distances against the single tree's: its
# slab-local z rounds a point's coordinate once and a query's twice (moved
# to the slab, wrapped about its centre), each by up to 2^-24 of the
# coordinate's size, where the single tree rounds q - p once; so one ulp
# of the distance plus 2^-22 of the box (the unit box here)
TREE_TOL = 2.0 ** -22


def tree_gate(name: str, d, i, d_ref, i_ref, pts, q, box,
              exact: bool = False) -> dict:
    """Hold the sharded tree's (d, i) to the single process's (d_ref,
    i_ref) for queries ``q`` on points ``pts`` (tensors on the card; ``box``
    the single tree's period or None): distances within one ulp plus
    :data:`TREE_TOL`; indices equal, except rows where the sharded answer's
    points lie, by the single tree's own distance, within twice that of
    the reference's (two candidates that close at one place of the k).
    With ``exact`` (the periodic tree at one slab: its z0 is 0 and it bins
    z with the box, so no slab-local coordinate rounds) distances are
    bit-equal and indices equal. Returns the counts it logs."""
    from nbodyhpc_tpu_torch.ops.metrics import sq_dist, sqrt_f32

    i = i.to(torch.int64)
    i_ref = i_ref.to(torch.int64)
    if exact:
        rows_d = int((d.view(torch.int32) != d_ref.view(torch.int32))
                     .any(1).sum())
        rows_i = int((i != i_ref).any(1).sum())
        if rows_d or rows_i:
            fail(f"{name}: {rows_d} rows' distances and {rows_i} rows' "
                 f"indices differ from the single process's, which they "
                 f"equal at one slab")
    if not torch.equal(torch.isfinite(d), torch.isfinite(d_ref)):
        fail(f"{name}: other neighbours are missing than in the single "
             f"process's answer")
    slack = ulp_tolerance(d_ref, TREE_TOL)
    diff = torch.where(torch.isfinite(d_ref), (d - d_ref).abs(), 0.0)
    if bool((diff > slack).any()):
        fail(f"{name}: {int((diff > slack).any(1).sum())} rows' distances "
             f"differ from the single process's by more than one ulp + "
             f"{TREE_TOL:.3g} (max {float(diff.max()):.3e})")
    rows = torch.nonzero((i != i_ref).any(1)).squeeze(1)
    if rows.numel():
        p = pts[i[rows].clamp_max(pts.shape[0] - 1)]
        qr = q[rows]
        d_re = sqrt_f32(sq_dist([qr[:, a, None] for a in range(3)],
                                p[..., 0], p[..., 1], p[..., 2],
                                None if box is None else (box,) * 3))
        d_re = torch.where(i[rows] < pts.shape[0], d_re, float("inf"))
        gap = torch.where(torch.isfinite(d_ref[rows]),
                          (d_re - d_ref[rows]).abs(), 0.0)
        if bool((gap > 2 * slack[rows]).any()):
            fail(f"{name}: indices of {rows.numel()} rows differ from the "
                 f"single process's, not by near ties")
    ulps = (d.view(torch.int32).long() - d_ref.view(torch.int32).long()
            ).abs()
    ulps = torch.where(torch.isfinite(d_ref), ulps, 0)
    return {"rows_d_differ": int((ulps > 0).any(1).sum()),
            "max_ulps": int(ulps.max()), "max_abs": float(diff.max()),
            "rows_i_near_tie": int(rows.numel())}


def _gate_log(g: dict) -> str:
    return (f"{g['rows_d_differ']} rows with a distance not bit-equal (max "
            f"{g['max_ulps']} ulps, {g['max_abs']:.3e}), "
            f"{g['rows_i_near_tie']} rows with other indices at near ties")


def knn_phases(dev: torch.device, gen: torch.Generator, smi: str,
               base_topk=None, base_dist=None) -> list:
    """Phases kNN-1..4: B3 and B4's two sinks against their plain versions
    at the main path's shapes, the main path at the reference harness's
    size, and the k > 128 routes. ``smi`` (the card's name and power limit)
    is printed beside every time; ``base_topk`` (from :func:`baseline_topk`)
    is timed against B3 in turns at every k, ``base_dist`` (from
    :func:`baseline_dist`) against B4's block sink. Returns the kernels'
    entries for the result line, and kNN-3's (tree, queries, distances,
    indices)."""
    import numpy as np

    from nbodyhpc_tpu_torch.kdtree import KDTree
    from nbodyhpc_tpu_torch.ops import knn, knn_cuda as kc, knn_device as kd

    # ---- kNN-1: B3 vs plain at the full-size plan --------------------------
    gen.manual_seed(SEED + 10)
    pts = torch.rand((KNN_N, 3), generator=gen, device=dev)
    queries = pts[:KNN_Q]
    torch.cuda.reset_peak_memory_stats()
    tree, build_ms = synced(lambda: KDTree(pts, boxsize=1.0))
    cl = tree._tree
    plan, plan_ms = synced(lambda: kd.tree_plan(cl))
    st = kd._stage_sort(cl, plan, queries)
    npieces = st.piece_q0.numel()
    cand = plan.points[st.pid.long()].double()
    log(f"kNN-1: {KNN_N} points, periodic, dims {cl.dims.tolist()}, "
        f"max cell {cl.max_cell_count}: built in {build_ms:.3f} ms, plan "
        f"{'FULLZ' if plan.fullz else 'ZSEG'} ({plan.run_start.shape[0]} "
        f"rows x {plan.run_start.shape[1]} runs) in {plan_ms:.3f} ms; "
        f"{KNN_Q} queries in {npieces} pieces "
        f"({KNN_Q / npieces:.1f} queries each), candidates per query "
        f"mean {float(cand.mean()):.1f} max {int(cand.max())}")
    q_all = st.qs.T.contiguous()
    grid = kd.cell_grid(cl, plan)
    args3 = (q_all, st.piece_q0, st.piece_qn, st.piece_pid, plan.run_start,
             plan.run_len, cl.xyz, plan.box)
    win_q, win_points = window_work(cl, plan, st)
    win_pairs = int(win_q.sum())
    del win_q
    # the full-column scan: every FULLZ (or ZSEG) candidate of every query
    full_pairs = float(cand.sum())

    def b3_at(k: int, reps: int):
        """B3 at ``k`` over all pieces: held bit-equal to its plain version
        (and to the baseline), then timed in turns with the baseline. Returns
        (d2, slot, plain d2 [Q, k + 1], {"new": [ms], "base": [ms]}, pairs
        scored, cells scanned)."""
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        dk, sk = kc.knn_topk(*args3, k, grid=grid, counts=counts)
        dr, sr = kc.knn_topk_reference(*args3, k + 1)
        torch.cuda.synchronize()
        if not (bits_equal(dk, dr[:, :k]) and torch.equal(sk, sr[:, :k])):
            bad = int(((dk.view(torch.int32) != dr[:, :k].view(torch.int32))
                       | (sk != sr[:, :k])).any(1).sum())
            fail(f"kNN-1: B3 at k={k} is not bit-equal to its plain version "
                 f"on {bad} of {KNN_Q} rows")
        del sr
        if base_topk is not None:
            bd, bs = base_topk(args3, k, grid)
            torch.cuda.synchronize()
            if not (bits_equal(bd, dk) and torch.equal(bs, sk)):
                fail(f"kNN-1: the baseline B3 differs from the kernel at k={k}")
            del bd, bs
        turns = {"new": [], "base": []}
        for who in (("base", "new", "new", "base") if base_topk is not None
                    else ("new", "new")):
            if who == "new":
                turns[who].append(cuda_ms(
                    lambda: kc.knn_topk(*args3, k, grid=grid), reps))
            else:
                turns[who].append(cuda_ms(
                    lambda: base_topk(args3, k, grid), reps))
        scored, scanned = (int(v) for v in counts.tolist())
        if scored <= 0:
            fail(f"kNN-1: B3 at k={k} counted no pairs scored")
        return dk, sk, dr, turns, scored, scanned

    def b3_report(k, turns, scored, scanned, pairs_needed):
        """Log B3's times at ``k`` in turns and its bound, from the pairs the
        answer needs; returns (kernel ms, bound ms, bound by)."""
        ms = sum(turns["new"]) / len(turns["new"])
        bound_ms, bound_by = bound(b3_bytes(win_points, KNN_Q, k),
                                   B3_INSTR * pairs_needed)
        line = (f"kNN-1: B3 at k={k} ({smi}): kernel {ms:.3f} ms (turns "
                f"{turns['new']})")
        if turns["base"]:
            b_ms = sum(turns["base"]) / len(turns["base"])
            line += (f", baseline source {b_ms:.3f} ms (turns "
                     f"{turns['base']}), {b_ms / ms:.2f}x the kernel's time")
        log(line + f"; scored {scored} pairs ({scored / KNN_Q:.1f} per "
            f"query) in {scanned} cells ({scanned / KNN_Q:.2f} per query); "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs_needed} pairs x "
            f"{B3_INSTR} instructions, {b3_bytes(win_points, KNN_Q, k)} "
            f"bytes), share {bound_ms / ms:.4f}")
        return ms, bound_ms, bound_by

    dk, sk, dr, turns, scored, scanned = b3_at(KNN_K, 10)
    edge = int(((dr[:, -2] == dr[:, -1]) & torch.isfinite(dr[:, -1])).sum())
    if edge:
        fail(f"kNN-1: {edge} rows tie at the k-th candidate distance")
    b3_err = max_err(dk, dr[:, :KNN_K])
    b3_plain_ms = cuda_ms(lambda: kc.knn_topk_reference(*args3, KNN_K), 1)
    log(f"kNN-1: B3 bit-equal to plain on all {npieces} pieces ({KNN_Q} "
        f"queries, k={KNN_K}), no tie at the k-th distance"
        + (", bit-equal to the baseline source" if base_topk else "")
        + f"; {smi}: plain {b3_plain_ms:.3f} ms")
    # the bound from what these inputs need: the window's pairs, or fewer
    # where the kernel proved the answer with fewer; each tree point the
    # window touches, the queries and the results once
    need = min(win_pairs, scored)
    b3_ms, b3_bound_ms, b3_bound_by = b3_report(KNN_K, turns, scored,
                                                scanned, need)
    win_ms, win_by = bound(b3_bytes(win_points, KNN_Q, KNN_K),
                           B3_INSTR * win_pairs)
    full_ms, full_by = bound(b3_bytes(KNN_N, KNN_Q, KNN_K),
                             B3_INSTR * full_pairs)
    log(f"kNN-1: B3 work at k={KNN_K}: the window holds {win_pairs} pairs "
        f"({win_pairs / KNN_Q:.1f} per query; bound from them alone "
        f"{win_ms:.4f} ms, {win_by}), the kernel scored {scored} "
        f"({scored / win_pairs:.3f}x the window's); the full-column scan: "
        f"{full_pairs:.0f} pairs, bound {full_ms:.3f} ms ({full_by})")
    del dk, sk, dr
    # at other k: the pairs the kernel scored (at k = 128 the window alone
    # does not hold the answer)
    for k in KNN_SWEEP_K:
        _, _, _, turns_k, scored_k, scanned_k = b3_at(k, 5)
        b3_report(k, turns_k, scored_k, scanned_k, scored_k)
    del args3

    # ---- kNN-2: B4's two sinks vs plain, k > 128 ---------------------------
    n2, q2, k2 = KNN2_N, KNN2_Q, KNN2_K
    gen.manual_seed(SEED + 11)
    pts2 = torch.rand((n2, 3), generator=gen, device=dev)
    queries2 = torch.rand((q2, 3), generator=gen, device=dev)
    tree2 = KDTree(pts2, boxsize=1.0, leafsize=KNN2_LEAFSIZE)
    cl2 = tree2._tree
    plan2 = kd.tree_plan(cl2)
    st2 = kd._stage_sort(cl2, plan2, queries2)
    argsq = kd._kernel_args(cl2, plan2, st2)
    pc4 = plan2.points[st2.piece_pid.long()].double()
    b4_pairs = float((st2.piece_qn.double() * pc4).sum())
    read_bytes = 12 * q2 + 12 * min(float(pc4.sum()), n2)
    harness = (f"{n2} points periodic, plan "
               f"{'FULLZ' if plan2.fullz else 'ZSEG'}, {q2} queries in "
               f"{st2.piece_q0.numel()} pieces, {b4_pairs:.0f} pairs")

    # the block sink, rows padded as the engine pads them
    ncand = -(-int(pc4.max()) // kd.DIST_ROW_ALIGN) * kd.DIST_ROW_ALIGN
    args4 = (*argsq, ncand)
    bk = kc.knn_dist(*args4)
    br = kc.knn_dist_reference(*args4)
    torch.cuda.synchronize()
    if not bits_equal(bk, br):
        fail("kNN-2: B4's block sink is not bit-equal to its plain version")
    own_ms = None
    if base_dist is not None:
        if not bits_equal(base_dist(args4), bk):
            fail("kNN-2: the baseline knn_dist differs from the block sink")
        # the baseline at the unpadded row length, as the route ran it
        # before rows were padded
        own = (*argsq, int(pc4.max()))
        own_ms = cuda_ms(lambda: base_dist(own), 10)
    # derived: the block written once, each query and candidate read once
    blk_bound_ms, blk_bound_by = bound(4 * bk.numel() + read_bytes,
                                     B4_INSTR * b4_pairs)
    sel_d, sel_s = kc.select_block(br, k2 + 1, st2.pid, plan2.run_start,
                                   plan2.run_len)
    if int(((sel_d[:, -2] == sel_d[:, -1])
            & torch.isfinite(sel_d[:, -1])).sum()):
        fail("kNN-2: rows tie at the k-th candidate distance")
    turns = {"new": [], "base": []}
    for who in (("base", "new", "new", "base") if base_dist is not None
                else ("new", "new")):
        turns[who].append(cuda_ms(
            (lambda: kc.knn_dist(*args4)) if who == "new"
            else (lambda: base_dist(args4)), 10))
    blk_ms = sum(turns["new"]) / len(turns["new"])
    blk_plain_ms = cuda_ms(lambda: kc.knn_dist_reference(*args4), 1)
    line = (f"kNN-2: B4 block sink bit-equal to plain ({smi}): {harness}, "
            f"block {tuple(bk.shape)}: kernel {blk_ms:.3f} ms (turns "
            f"{turns['new']})")
    if turns["base"]:
        base_ms = sum(turns["base"]) / len(turns["base"])
        line += (f", baseline source {base_ms:.3f} ms (turns "
                 f"{turns['base']}), {base_ms / blk_ms:.2f}x the kernel's "
                 f"time, bit-equal; the baseline on unpadded rows of "
                 f"{int(pc4.max())}: {own_ms:.3f} ms")
    log(line + f", plain {blk_plain_ms:.3f} ms, bound {blk_bound_ms:.3f} ms "
        f"({blk_bound_by}), share {blk_bound_ms / blk_ms:.4f}")
    # for the record: one library call that selects the same values from
    # the block, without the tie rule and without making the block
    topk_ms = cuda_ms(lambda: torch.topk(bk, k2, dim=1, largest=False), 3)
    sort_ms = cuda_ms(lambda: kc.select_block(
        bk, k2, st2.pid, plan2.run_start, plan2.run_len), 3)
    log(f"kNN-2: on that block ({smi}): torch.topk(block, {k2}, "
        f"largest=False) {topk_ms:.3f} ms; select_block (stable sort and "
        f"decode) {sort_ms:.3f} ms")
    del bk, br

    # the selection sink, at the path's k, its smallest k and its capacity.
    # Its bound counts the pairs the answer needs, as B3's does: a row whose
    # k-th distance lies inside its 27-cell cube needs that window's pairs,
    # any other row every candidate of its piece
    win2, _ = window_work(cl2, plan2, st2)
    face2, _ = knn.cube_bound(cl2, st2.qs, st2.qcs, 1, 3)
    cand2 = plan2.points[st2.pid.long()].long()

    def select_at(k: int, want_d, want_s):
        """Hold ``knn_select`` at ``k`` bit-equal to (want_d, want_s) and
        time it: (max abs err, ms, bound ms, bound by)."""
        dk, sk = kc.knn_select(*argsq, k)
        torch.cuda.synchronize()
        if not (bits_equal(dk, want_d) and torch.equal(sk, want_s)):
            bad = int(((dk.view(torch.int32) != want_d.view(torch.int32))
                       | (sk != want_s)).any(1).sum())
            fail(f"kNN-2: B4's selection sink at k={k} is not bit-equal to "
                 f"its plain version on {bad} of {q2} rows")
        ms = cuda_ms(lambda: kc.knn_select(*argsq, k), 10)
        inwin = want_d[:, k - 1] < face2 * face2
        need = int(torch.where(inwin, win2, cand2).sum())
        nbytes = read_bytes + 8 * k * q2
        b_ms, b_by = bound(nbytes, B4_INSTR * need)
        scan_ms, scan_by = bound(nbytes, B4_INSTR * b4_pairs)
        log(f"kNN-2: B4 selection sink at k={k} bit-equal to plain ({smi}): "
            f"kernel {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {need} pairs "
            f"x {B4_INSTR} instructions, {int(inwin.sum())} of {q2} rows "
            f"answered by their window; {nbytes:.0f} bytes), share "
            f"{b_ms / ms:.4f}; the full scan it runs: {b4_pairs:.0f} pairs, "
            f"bound {scan_ms:.4f} ms ({scan_by}), {b4_pairs / need:.2f}x the "
            f"pairs the answer needs")
        return max_err(dk, want_d), ms, b_ms, b_by

    rd, rs = kc.knn_select_reference(*argsq, k2)
    if not (bits_equal(rd, sel_d[:, :k2]) and torch.equal(rs, sel_s[:, :k2])):
        fail("kNN-2: knn_select_reference differs from the sorted block")
    del sel_d, sel_s
    sel_err, sel_ms, sel_bound_ms, sel_bound_by = select_at(k2, rd, rs)
    sel_plain_ms = cuda_ms(lambda: kc.knn_select_reference(*argsq, k2), 1)
    log(f"kNN-2: B4 selection sink's plain version at k={k2}: "
        f"{sel_plain_ms:.3f} ms")
    for k in KNN2_SWEEP_K:
        if not kc.TOPK_MAX < k <= kc.SELECT_MAX:
            fail(f"kNN-2: k={k} is not on the selection sink's path")
        select_at(k, *kc.knn_select_reference(*argsq, k))
    del win2, face2, cand2

    # the two k > 128 routes on the same staged queries, in turns (wall ms,
    # the device drained around each): one launch of the selection sink
    # against distance blocks and a stable sort of each
    routes = {"select": [], "block": []}
    for who in ("block", "select", "select", "block"):
        (dd, ss), ms = synced(
            (lambda: kd.candidate_topk(cl2, plan2, st2, k2))
            if who == "select" else (lambda: kd.block_topk(cl2, plan2, st2,
                                                           k2)))
        routes[who].append(ms)
        if not (bits_equal(dd, rd) and torch.equal(ss, rs)):
            fail(f"kNN-2: the {who} route differs from the plain version")
    log(f"kNN-2: candidate stage at k={k2} in turns ({smi}, wall ms): "
        f"selection sink {routes['select']}, blocks and stable sort "
        f"{routes['block']}")
    del args4, rd, rs, dd, ss
    torch.cuda.empty_cache()

    # ---- kNN-3: the main path at full size ---------------------------------
    tree.query_device(queries, k=KNN_K)  # warm-up
    profiling.reset()
    (d, idx), qd_ms = synced(lambda: tree.query_device(queries, k=KNN_K))
    b3_launches = _launches()["knn_topk"]
    ladder_q = kd.query_blocks_device.ladder_queries
    if b3_launches == 0:
        fail("kNN-3: B3 was not launched on the main path")
    if d.shape != (KNN_Q, KNN_K) or idx.dtype != torch.int32:
        fail(f"kNN-3: result {tuple(d.shape)} {idx.dtype}")
    if not bool((d[:, 0] == 0).all()):
        fail("kNN-3: a self-query's nearest distance is not 0")
    sample = torch.randperm(KNN_Q, generator=gen, device=dev)[:4096]
    tied = check_sample("kNN-3", cl, queries[sample], d[sample], idx[sample],
                        KNN_K)
    log(f"kNN-3: query_device {KNN_Q} self-queries k={KNN_K} ({smi}): "
        f"{qd_ms:.3f} ms ({KNN_Q / qd_ms * 1e3:.0f} q/s, "
        f"{KNN_Q / qd_ms * 1e3 / REF_QPS:.2f}x the reference binary's "
        f"{REF_QPS} q/s); B3 launches {b3_launches}; {ladder_q} queries "
        f"({ladder_q / KNN_Q:.4%}) finished on the ladder; d[:, 0] == 0; "
        f"4096-query sample equals brute force ({tied} rows with tied "
        f"distances inside the k)")

    pts_np = queries.cpu().numpy()
    (dn, inn), q_ms = synced(lambda: tree.query(pts_np, k=KNN_K))
    if dn.dtype != np.float32 or inn.dtype != np.uint32:
        fail(f"kNN-3: query returned {dn.dtype}/{inn.dtype}")
    if not (dn[:, 0] == 0).all():
        fail("kNN-3: query: a self-query's nearest distance is not 0")
    if not (np.array_equal(dn, d.cpu().numpy())
            and np.array_equal(inn, idx.cpu().numpy().astype(np.uint32))):
        fail("kNN-3: query differs from query_device")
    _, _, stats = tree.query_with_statistics(pts_np[:4096], k=KNN_K)
    if not ((stats.cells_scanned > 0).all()
            and (stats.points_visited >= KNN_K).all()):
        fail("kNN-3: query_with_statistics counters out of range")
    log(f"kNN-3: query (numpy in and out) {q_ms:.3f} ms "
        f"({KNN_Q / q_ms * 1e3:.0f} q/s); query_with_statistics on 4096: "
        f"mean cells scanned {stats.cells_scanned.mean():.1f}, points "
        f"visited {stats.points_visited.mean():.1f}; build {build_ms:.3f} "
        f"ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # stage split of query_device, a sync around each stage
    st, t_sort = synced(lambda: kd._stage_sort(cl, plan, queries))
    (d2s, slot), t_b3 = synced(lambda: kd.candidate_topk(cl, plan, st,
                                                          KNN_K))
    (_, _, cv), t_epi = synced(lambda: kd._epilogue(cl, plan, d2s, slot,
                                                    st.qs, st.qcs))
    bad, t_bad = synced(lambda: torch.nonzero(~cv).squeeze(1))
    _, t_lad = synced(lambda: knn.ladder_knn(cl, st.qs[bad], KNN_K))
    _, rebuild_ms = synced(lambda: KDTree(pts, boxsize=1.0))
    log(f"kNN-3: stage split (ms, {smi}): build again {rebuild_ms:.3f}, "
        f"plan {plan_ms:.3f} (once per tree), stage sort {t_sort:.3f}, B3 "
        f"{t_b3:.3f}, epilogue {t_epi:.3f}, unconverged {t_bad:.3f}, ladder "
        f"({bad.numel()} queries) {t_lad:.3f}; query_device {qd_ms:.3f} ms "
        f"= {KNN_Q / qd_ms * 1e3:.0f} q/s")
    busy_ms, wall_ms, top = device_busy_ms(
        lambda: tree.query_device(queries, k=KNN_K))
    idle = 1 - busy_ms / wall_ms
    if not 0.0 <= idle <= 1.0:
        fail(f"kNN-3: idle share {idle} outside [0, 1] (busy {busy_ms} ms, "
             f"wall {wall_ms} ms)")
    log(f"kNN-3: profiled query_device: device busy {busy_ms:.3f} ms of its "
        f"wall {wall_ms:.3f} ms, idle share {idle:.3f}; by kernel (ms): "
        f"{top}")
    # the harness's tree, queries and answer stay for phase 7
    del cl, plan, st, pts, d2s, slot, cv
    torch.cuda.empty_cache()

    # ---- kNN-4: the k > 128 routes end to end ------------------------------
    def certified_sample(name, queries, d, idx, k, nsample):
        """Hold ``nsample`` of the queries the kernel route certified (so
        B4's answers, not the ladder's) to brute force. Returns (rows with
        ties, rows held)."""
        st = kd._stage_sort(cl2, plan2, queries)
        d2c, slotc = kd.candidate_topk(cl2, plan2, st, k)
        _, _, cv = kd._epilogue(cl2, plan2, d2c, slotc, st.qs, st.qcs)
        cert = st.orig[cv]
        ladder = kd.query_blocks_device.ladder_queries
        if cert.numel() != queries.shape[0] - ladder:
            fail(f"{name}: {cert.numel()} certified rows, "
                 f"{queries.shape[0] - ladder} expected")
        rows = cert[torch.randperm(cert.numel(), generator=gen,
                                   device=dev)[:nsample]]
        return (check_sample(name, cl2, queries[rows], d[rows], idx[rows], k),
                rows.numel())

    tree2.query_device(queries2, k=k2)  # warm-up
    profiling.reset()
    (d4, i4), k4_ms = synced(lambda: tree2.query_device(queries2, k=k2))
    took = _launches()
    sel_launches = took["knn_select"]
    ladder4 = kd.query_blocks_device.ladder_queries
    if sel_launches != 1 or took["knn_dist"] or took["knn_topk"]:
        fail(f"kNN-4: k={k2} launched (knn_select, knn_dist, knn_topk) = "
             f"({sel_launches}, {took['knn_dist']}, {took['knn_topk']}), "
             f"expected (1, 0, 0)")
    if ladder4 >= q2 // 2:
        fail(f"kNN-4: {ladder4} of {q2} queries finished on the ladder; the "
             f"kernel route certified too few")
    tied4, held4 = certified_sample("kNN-4", queries2, d4, i4, k2, 1024)
    log(f"kNN-4: query_device {q2} queries k={k2} on {n2} points (cells of "
        f"{n2 / cl2.ncells:.1f} points) ({smi}): {k4_ms:.3f} ms; launches "
        f"knn_select {sel_launches}, knn_dist 0; {ladder4} queries on the "
        f"ladder; {held4} of the kernel-certified queries equal brute force "
        f"({tied4} rows with ties)")
    # stage split of that call, a sync around each stage
    st4, t_sort = synced(lambda: kd._stage_sort(cl2, plan2, queries2))
    (d2s, slot), t_cand = synced(lambda: kd.candidate_topk(cl2, plan2, st4,
                                                            k2))
    (_, _, cv), t_epi = synced(lambda: kd._epilogue(cl2, plan2, d2s, slot,
                                                    st4.qs, st4.qcs))
    bad, t_bad = synced(lambda: torch.nonzero(~cv).squeeze(1))
    _, t_lad = synced(lambda: knn.ladder_knn(cl2, st4.qs[bad], k2))
    log(f"kNN-4: stage split at k={k2} (ms, {smi}): stage sort {t_sort:.3f}, "
        f"candidate stage (selection sink) {t_cand:.3f}, epilogue "
        f"{t_epi:.3f}, unconverged {t_bad:.3f}, ladder ({bad.numel()} "
        f"queries) {t_lad:.3f}; query_device {k4_ms:.3f} ms")
    del d4, i4, st4, d2s, slot, cv

    # above the selection sink's capacity: distance blocks and a stable sort
    k5, q5 = KNN2_BLOCK_K, queries2[:KNN2_BLOCK_Q]
    if k5 <= kc.SELECT_MAX:
        fail(f"kNN-4: k={k5} does not exceed the selection sink's capacity")
    tree2.query_device(q5, k=k5)  # warm-up
    profiling.reset()
    (d5, i5), k5_ms = synced(lambda: tree2.query_device(q5, k=k5))
    took = _launches()
    b4_launches = took["knn_dist"]
    ladder5 = kd.query_blocks_device.ladder_queries
    if b4_launches == 0 or took["knn_select"] or took["knn_topk"]:
        fail(f"kNN-4: k={k5} launched (knn_select, knn_dist, knn_topk) = "
             f"({took['knn_select']}, {b4_launches}, {took['knn_topk']}), "
             f"expected knn_dist alone")
    if ladder5 >= q5.shape[0] // 2:
        fail(f"kNN-4: {ladder5} of {q5.shape[0]} queries at k={k5} finished "
             f"on the ladder; the kernel route certified too few")
    tied5, held5 = certified_sample(f"kNN-4 (k={k5})", q5, d5, i5, k5, 512)
    log(f"kNN-4: query_device {q5.shape[0]} queries k={k5} ({smi}): "
        f"{k5_ms:.3f} ms; launches knn_dist {b4_launches}, knn_select 0; "
        f"{ladder5} queries on the ladder; {held5} of the kernel-certified "
        f"queries equal brute force ({tied5} rows with ties)")
    # the block sink at the blocks that call launched: held against plain,
    # timed and bounded there, so its entry describes the path's launches
    st5 = kd._stage_sort(cl2, plan2, q5)
    args5 = kd._kernel_args(cl2, plan2, st5)
    tot5 = plan2.points[st5.piece_pid.long()]
    blocks5 = [(args5[0], *(a[p0:p1] for a in args5[1:4]), *args5[4:], nc,
                r0, nr) for p0, p1, r0, nr, nc in kd._dist_chunks(st5, tot5)]
    if len(blocks5) != b4_launches:
        fail(f"kNN-4: k={k5} launched knn_dist {b4_launches} times for "
             f"{len(blocks5)} blocks")
    b4_err = 0.0
    for a in blocks5:
        got, want = kc.knn_dist(*a), kc.knn_dist_reference(*a)
        if not bits_equal(got, want):
            fail(f"kNN-4: B4's block sink is not bit-equal to its plain "
                 f"version on the k={k5} call's block of {tuple(got.shape)}")
        b4_err = max(b4_err, max_err(got, want))
    del got, want
    b4_ms = cuda_ms(lambda: [kc.knn_dist(*a) for a in blocks5], 10)
    b4_plain_ms = cuda_ms(
        lambda: [kc.knn_dist_reference(*a) for a in blocks5], 1)
    pairs5 = float((st5.piece_qn.double() * tot5.double()).sum())
    bytes5 = (sum(4 * a[10] * a[8] for a in blocks5) + 12 * q5.shape[0]
              + 12 * min(float(tot5.sum()), n2))
    b4_bound_ms, b4_bound_by = bound(bytes5, B4_INSTR * pairs5)
    log(f"kNN-4: B4 block sink at that call's blocks "
        f"{[(a[10], a[8]) for a in blocks5]} bit-equal to plain ({smi}): "
        f"kernel {b4_ms:.3f} ms, plain {b4_plain_ms:.3f} ms, bound "
        f"{b4_bound_ms:.3f} ms ({b4_bound_by}: {bytes5:.0f} bytes; "
        f"{pairs5:.0f} pairs), share {b4_bound_ms / b4_ms:.4f}")

    return [
        {"name": "knn_topk", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/knn_topk.cu",
         "replaces": "nbodyhpc_tpu/ops/knn_pallas.py:204",
         "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms,
         "bound_ms": b3_bound_ms, "bound_by": b3_bound_by,
         "library_ms": None},
        {"name": "knn_select", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/knn_dist.cu",
         "replaces": "nbodyhpc_tpu/ops/knn_pallas.py:185 and "
                     "nbodyhpc_tpu/ops/knn_pallas.py:673",
         "launches": sel_launches, "max_abs_err": sel_err,
         "ms": sel_ms, "plain_ms": sel_plain_ms,
         "bound_ms": sel_bound_ms, "bound_by": sel_bound_by,
         "library_ms": None},
        {"name": "knn_dist", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/knn_dist.cu",
         "replaces": "nbodyhpc_tpu/ops/knn_pallas.py:185",
         "launches": b4_launches, "max_abs_err": b4_err,
         "ms": b4_ms, "plain_ms": b4_plain_ms,
         "bound_ms": b4_bound_ms, "bound_by": b4_bound_by,
         "library_ms": None},
    ], (tree, queries, d, idx)


# phase 6 streams the file in the runtime's default batches (5 at 256^3),
# phase 7 interrupts a stream of 17 batches
STREAM_ROWS, CANCEL_ROWS = 4_000_000, 1_000_000
RATIO_LINE = re.compile(r"mass conservation rendered/input: ([0-9.]+)")


class _TimedReader:
    """Stands in for a stream's reader pool and adds up the seconds the
    stream waits for its reads: with ``sync`` False the pool the package
    makes (batch i+1 read on its thread while batch i renders), with
    ``sync`` True none (each read runs at once on the calling thread, so
    the wait is the whole read)."""

    sync = False
    waited = 0.0

    def __init__(self, *args, **kwargs):
        self._pool = (None if _TimedReader.sync else
                      concurrent.futures.ThreadPoolExecutor(*args, **kwargs))

    def submit(self, fn, *args):
        t0 = time.perf_counter()
        if self._pool is None:
            fut = concurrent.futures.Future()
            fut.set_result(fn(*args))
            _TimedReader.waited += time.perf_counter() - t0
            return fut
        return _TimedFuture(self._pool.submit(fn, *args))

    def shutdown(self, *args, **kwargs):
        if self._pool is not None:
            self._pool.shutdown(*args, **kwargs)


class _TimedFuture:
    def __init__(self, fut):
        self._fut = fut

    def result(self):
        t0 = time.perf_counter()
        try:
            return self._fut.result()
        finally:
            _TimedReader.waited += time.perf_counter() - t0


def file_phase(tmp: str, pos, w, r, grid: int, smi: str):
    """Phase 6: the full-size workload written to a particle file with
    ``runtime.save_particles`` and read back bit-equal; the demo's bulk
    ``--file --periodic`` render of it (mass ratio, B1 and B2 launched);
    the file streamed in batches of :data:`STREAM_ROWS`, summed on the card
    and held to one render of the whole set (both non-periodic, through the
    renderer's device path), with and without the prefetch, in turns.
    Returns (file, renderer, the one-call field on the host)."""
    import io

    import numpy as np

    from nbodyhpc_tpu_torch import runtime
    from nbodyhpc_tpu_torch.cli import rasterizer_demo as demo
    from nbodyhpc_tpu_torch.rasterizer import Container, get_point_renderer

    t_phase = time.perf_counter()
    n = pos.shape[0]
    host = [t.cpu().numpy() for t in (pos, w, r)]
    path = os.path.join(tmp, "particles.bin")
    t0 = time.perf_counter()
    runtime.save_particles(path, *host)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    if nbytes != 20 * n:
        fail(f"phase 6: the file holds {nbytes} B, not {20 * n}")
    t0 = time.perf_counter()
    back = runtime.load_particles(path)
    read_s = time.perf_counter() - t0
    for a, b in zip(back, host):
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            fail("phase 6: the particles read back differ from those written")
    t0 = time.perf_counter()
    runtime._load_records(path, 5)
    records_s = time.perf_counter() - t0
    log(f"phase 6: wrote {n} particles, {nbytes} B, in {write_s:.3f} s "
        f"({nbytes / write_s / 1e9:.2f} GB/s, into the page cache); "
        f"load_particles read them back bit-equal in {read_s:.3f} s "
        f"({nbytes / read_s / 1e9:.2f} GB/s), of which the records alone "
        f"(a fresh buffer, readinto) {records_s:.3f} s")

    # the demo's bulk path, as a user runs it
    profiling.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = demo.main(["--file", path, "--grid", str(grid), "--periodic"])
    launches = tuple(_launches()[k] for k in ("splat_align", "splat_deposit"))
    ratio = RATIO_LINE.search(out.getvalue())
    if rc != 0 or ratio is None:
        fail(f"phase 6: the demo returned {rc}: {out.getvalue()}")
    if abs(float(ratio.group(1)) - 1.0) > 0.01:
        fail(f"phase 6: the demo's mass ratio {ratio.group(1)} is not "
             f"within 1% of 1")
    if min(launches) == 0:
        fail(f"phase 6: a kernel was not launched by the demo (align, "
             f"deposit) = {launches}")
    log(f"phase 6: demo --file --grid {grid} --periodic ({smi}): "
        + "; ".join(out.getvalue().strip().splitlines())
        + f"; launches (align, deposit) {launches}")

    # the stream against one render of the whole set, on the card
    renderer = get_point_renderer(grid, 4, Container())
    ppu = float(grid)

    def stream(rows):
        return demo.stream_volume(renderer, path, grid, ppu, rows)

    one, one_ms = synced(lambda: renderer._render_volume_device(
        *back, grid, ppu))
    turns = {"prefetch": [], "sync": []}
    waited = {"prefetch": 0.0, "sync": 0.0}
    err = 0.0
    for who in ("prefetch", "sync", "sync", "prefetch"):
        _TimedReader.sync, _TimedReader.waited = who == "sync", 0.0
        with mock.patch.object(runtime, "ThreadPoolExecutor", _TimedReader):
            (field, n_s, _), ms = synced(lambda: stream(STREAM_ROWS))
        turns[who].append(ms)
        waited[who] += _TimedReader.waited * 1e3 / 2
        if n_s != n:
            fail(f"phase 6: the stream gave {n_s} particles, not {n}")
        err = max(err, check_close(f"phase 6 {who} stream vs one render",
                                   field, one))
        del field
    log(f"phase 6: stream of {-(-n // STREAM_ROWS)} batches of "
        f"{STREAM_ROWS} rows, non-periodic, summed on the card ({smi}): "
        f"{sum(turns['prefetch']) / 2:.3f} ms (turns {turns['prefetch']}), "
        f"reads made synchronous {sum(turns['sync']) / 2:.3f} ms (turns "
        f"{turns['sync']}); waited for reads: {waited['prefetch']:.3f} ms "
        f"with the prefetch, {waited['sync']:.3f} ms without (the read "
        f"time), so the prefetch hid "
        f"{1 - waited['prefetch'] / waited['sync']:.3f} of it; one render "
        f"of all {n} through the device path {one_ms:.3f} ms; the stream "
        f"equals it within rtol {RTOL} atol {ATOL}, max abs err {err:.3e}")

    one = one.cpu()
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s of command time")
    return path, renderer, one


def trace_phase(path: str, renderer, smi: str):
    """Phase 6b, run last: one device render of phase 6's file under
    ``profiling.trace`` (its Chrome trace must name the deposit kernel),
    then the same render's device busy time. After a trace session later
    launches were slower on this card, so no timed phase follows it."""
    from nbodyhpc_tpu_torch import runtime

    t_phase = time.perf_counter()
    back = runtime.load_particles(path)
    grid = renderer.height
    ppu = float(grid)
    trace_dir = os.path.join(os.path.dirname(path), "trace")
    with profiling.trace(trace_dir):
        renderer._render_volume_device(*back, grid, ppu)
    trace_json = os.path.join(trace_dir, "trace.json")
    with open(trace_json) as f:
        named = f.read().count("deposit_kernel")
    if not named:
        fail(f"phase 6b: {trace_json} does not name deposit_kernel")
    busy_ms, wall_ms, top = device_busy_ms(
        lambda: renderer._render_volume_device(*back, grid, ppu), top=10)
    log(f"phase 6b: profiling.trace wrote {os.path.getsize(trace_json)} B, "
        f"{named} events of deposit_kernel; device_busy_ms of the same "
        f"render ({smi}): busy {busy_ms:.3f} ms of its wall {wall_ms:.3f} "
        f"ms, idle share {1 - busy_ms / wall_ms:.3f}; by kernel (ms): {top}")
    log(f"phase 6b: {time.perf_counter() - t_phase:.1f} s of command time")


def interrupted_ms(fn, full_ms: float) -> float:
    """Runs ``fn`` with SIGINT sent to this process at 40% of ``full_ms``;
    returns the ms until ``fn`` raised ``KeyboardInterrupt``. Fails if
    ``fn`` returns; a signal after that ends the script."""
    torch.cuda.synchronize()
    timer = threading.Timer(0.4 * full_ms / 1e3, os.kill,
                            (os.getpid(), signal.SIGINT))
    t0 = time.perf_counter()
    timer.start()
    try:
        fn()
    except KeyboardInterrupt:
        ms = (time.perf_counter() - t0) * 1e3
    else:
        timer.cancel()
        fail("phase 7: the call ended before the signal")
    finally:
        timer.join()
    torch.cuda.synchronize()
    if ms >= 0.8 * full_ms:
        fail(f"phase 7: interrupted at {0.4 * full_ms:.1f} ms, the call "
             f"ended at {ms:.1f} ms, not before {0.8 * full_ms:.1f} ms")
    return ms


def cancel_phase(path: str, renderer, ref_host, harness, smi: str):
    """Phase 7: SIGINT during a long ladder ``query_device`` and during a
    streamed render of phase 6's file; each must raise
    ``KeyboardInterrupt`` before 80% of its uninterrupted time, and the
    next call must be right: kNN-3's answer bit for bit through the kernel
    route, phase 6's field within rtol/atol with no reader thread left."""
    from nbodyhpc_tpu_torch.cli import rasterizer_demo as demo
    from nbodyhpc_tpu_torch.ops import knn

    t_phase = time.perf_counter()
    tree, queries, d3, i3 = harness
    q = queries
    _, full_ms = synced(lambda: tree.query_device(q, KNN_K, engine="ladder"))
    while full_ms < 1000.0:
        q = torch.cat([q, q])
        _, full_ms = synced(lambda: tree.query_device(q, KNN_K,
                                                      engine="ladder"))
    ms = interrupted_ms(lambda: tree.query_device(q, KNN_K, engine="ladder"),
                        full_ms)
    profiling.reset()
    d, idx = tree.query_device(queries, KNN_K)
    if _launches()["knn_topk"] == 0:
        fail("phase 7: the k-NN check after the interrupt took no kernel")
    if not (bits_equal(d, d3) and torch.equal(idx, i3)):
        fail("phase 7: the k-NN answer after the interrupt differs from "
             "kNN-3's")
    chunk = knn.ladder_chunk(knn.default_ladder(tree._tree))
    log(f"phase 7: ladder query_device of {q.shape[0]} queries k={KNN_K} "
        f"in {-(-q.shape[0] // chunk)} chunks of {chunk} ({smi}): "
        f"{full_ms:.3f} ms; SIGINT at 40% -> KeyboardInterrupt "
        f"after {ms:.3f} ms ({ms / full_ms:.3f} of the call); the next "
        f"kernel-route query_device equals kNN-3's bit for bit")
    del d, idx, harness, tree, queries, d3, i3, q

    ref = ref_host.to(renderer.container.device)
    grid = ref.shape[2]

    def stream():
        return demo.stream_volume(renderer, path, grid, float(grid),
                                  CANCEL_ROWS)

    before = threading.active_count()
    (field, n, _), full_ms = synced(stream)
    err = check_close("phase 7 stream vs phase 6", field, ref)
    del field
    ms = interrupted_ms(stream, full_ms)
    if threading.active_count() != before:
        fail(f"phase 7: {threading.active_count()} threads after the "
             f"interrupted stream, {before} before it")
    (field, _, _), _ = synced(stream)
    err = max(err, check_close("phase 7 stream after the interrupt",
                               field, ref))
    log(f"phase 7: stream of {-(-n // CANCEL_ROWS)} batches of "
        f"{CANCEL_ROWS} rows ({smi}): {full_ms:.3f} ms; SIGINT at 40% -> "
        f"KeyboardInterrupt after {ms:.3f} ms ({ms / full_ms:.3f} of the "
        f"call), {before} threads before and after; the next stream equals "
        f"phase 6's field within rtol {RTOL} atol {ATOL}, max abs err "
        f"{err:.3e}")
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s of command time")


# ---- phase 8: the sharded path, spawned ranks ------------------------------
# 8a: one NCCL rank at a smaller size; 8b: two gloo ranks sharing the card at
# full size. Sizes travel in a spec, so a rehearsal on the CPU can cut them.
SHARDED_SPEC = {
    "8a": {"backend": "nccl", "nprocs": 1, "device": "cuda:0",
           "render_n": 2_000_000, "render_grid": 256,
           "knn_n": 1_000_000, "knn_q": 50_000, "timeout": 240},
    "8b": {"backend": "gloo", "nprocs": 2, "device": "cuda:0",
           "render_n": 256**3, "render_grid": 1024,
           "knn_n": KNN_N, "knn_q": KNN_Q, "knn2_n": KNN2_N,
           "knn2_q": KNN2_Q, "tree_q0": 50_000,
           # 420 s before the sharded tree's build and three queries
           "timeout": 480},
}
# the kNN-CDF of phase 8b: k up to the harness's, radii past its 16th
# neighbour distance (~0.0073 at 1e7 points)
CDF_K, CDF_RMAX, CDF_NR = (1, 2, 4, 8, 16), 0.012, 64
SHARDED_KERNELS = ("splat_align", "splat_deposit", "knn_topk", "knn_select",
                   "knn_dist")


def _launches() -> dict:
    """Every kernel's launch count, by the name of its ``kernels`` row."""
    counts = profiling.counters()
    return {name: counts.get(name.replace("_", ".", 1) + ".launches", 0)
            for name in SHARDED_KERNELS}


def knn_inputs(n: int, q: int, seed: int, dev, queries_apart: bool):
    """kNN-1's points made again from the seed (queries: the first ``q``
    points), or with ``queries_apart`` kNN-2's (``q`` random queries drawn
    after the points)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pts = torch.rand((n, 3), generator=gen, device=dev)
    if queries_apart:
        return pts, torch.rand((q, 3), generator=gen, device=dev)
    return pts, pts[:q]


def sharded_rank(rank: int, phase: str, spec: dict, tmp: str) -> None:
    """One rank of phase 8: join the phase's process group (a ``file://``
    store in ``tmp``), drive the sharded path through the entry points a
    user calls, and write what it returned, its launch counts and its
    times to ``tmp/<phase>_rank<r>.{npz,json}``. Rank 0 also holds the
    gathered field to the single-process render of the same inputs.
    The k-NN calls are timed after a warm-up call, the render cold;
    launches are counted per timed call, from zero."""
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from nbodyhpc_tpu_torch.kdtree import KDTree
    from nbodyhpc_tpu_torch.parallel.mesh import make_slab_mesh
    from nbodyhpc_tpu_torch.parallel.sharded import (
        knn_query_sharded,
        render_points_volume_sharded,
    )
    from nbodyhpc_tpu_torch.parallel.stats import knn_cdf_sharded
    from nbodyhpc_tpu_torch.parallel.tree_sharded import (
        build_tree_sharded,
        knn_query_tree_sharded,
    )
    from nbodyhpc_tpu_torch.rasterizer import Container, get_point_renderer

    # the group's sockets stay on this machine
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(spec["backend"],
                            init_method=f"file://{tmp}/store_{phase}",
                            world_size=spec["nprocs"], rank=rank)
    arrays, info = {}, {"launches": {}, "ms": {}}

    def call(name, fn, warm=True):
        """``fn()`` timed (after one warm-up call unless ``warm`` is
        False), its launches counted from zero."""
        if warm:
            fn()
        profiling.reset()
        out, ms = synced(fn)
        info["launches"][name] = _launches()
        info["ms"][name] = ms
        return out

    try:
        mesh = make_slab_mesh(device=None if dev.type == "cuda" else dev)
        if mesh.device != dev:
            fail(f"phase {phase}: rank {rank} computes on {mesh.device}")
        info["backend"] = mesh.backend

        # the k-NN harness (8b: through KDTree.query(workers=-1))
        pts, q = knn_inputs(spec["knn_n"], spec["knn_q"], SEED + 10, dev,
                            False)
        tree = KDTree(pts, boxsize=1.0)
        q_np = q.cpu().numpy()
        if phase == "8a":
            arrays["knn_d"], arrays["knn_i"] = call(
                "knn", lambda: knn_query_sharded(tree._tree, q_np, KNN_K,
                                                 mesh))
            ref_d, ref_i = tree.query(q_np, k=KNN_K)
            if not (np.array_equal(arrays["knn_d"].view(np.int32),
                                   ref_d.view(np.int32))
                    and np.array_equal(arrays["knn_i"], ref_i)):
                fail("phase 8a: knn_query_sharded differs from the single "
                     "process's query")
        else:
            arrays["knn_d"], arrays["knn_i"] = call(
                "knn", lambda: tree.query(q_np, k=KNN_K, workers=-1))
            # the k > 128 route on kNN-2's inputs
            pts2, q2 = knn_inputs(spec["knn2_n"], spec["knn2_q"], SEED + 11,
                                  dev, True)
            tree2 = KDTree(pts2, boxsize=1.0, leafsize=KNN2_LEAFSIZE)
            q2_np = q2.cpu().numpy()
            arrays["knn2_d"], arrays["knn2_i"] = call(
                "knn2", lambda: knn_query_sharded(tree2._tree, q2_np,
                                                  KNN2_K, mesh))
            del tree2, pts2, q2
            radii = np.linspace(0.0, CDF_RMAX, CDF_NR)
            arrays["cdf_r"], arrays["cdf"] = call(
                "cdf", lambda: knn_cdf_sharded(tree._tree, CDF_K, radii,
                                               n_queries=spec["knn_q"],
                                               mesh=mesh, seed=0))
        # the slab-sharded tree on the same points and queries, tensors in
        # and out (8a: the periodic tree and the open one, each held to the
        # single process here; 8b: the periodic tree, held to kNN-3 by the
        # parent, and hops=0 on the first queries)
        tree_runs = [("tree", 1.0)]
        if phase == "8a":
            tree_runs.append(("tree_open", None))
        for name, box in tree_runs:
            st = call(name + "_build", lambda: build_tree_sharded(
                pts, boxsize=box, mesh=mesh))
            td, ti, tov = call(name, lambda: knn_query_tree_sharded(
                st, q, KNN_K))
            info[name] = {"overflow": tov,
                          "stats": knn_query_tree_sharded.stats,
                          "counts": st.counts.tolist(),
                          "max_cell_count": st.max_cell_count}
            if phase == "8a":
                one = tree if box is not None else KDTree(pts)
                rd, ri = (torch.from_numpy(a).to(dev)
                          for a in one.query(q_np, k=KNN_K))
                info[name]["gate"] = tree_gate(
                    f"phase 8a {name}", td, ti, rd, ri, pts, q, box,
                    exact=box is not None)
                del one, rd, ri
            else:
                arrays[name + "_d"] = td.cpu().numpy()
                arrays[name + "_i"] = ti.cpu().numpy()
                n0 = spec["tree_q0"]
                d0, i0, ov0 = knn_query_tree_sharded(st, q[:n0], KNN_K,
                                                     hops=0)
                arrays[name + "0_d"] = d0.cpu().numpy()
                arrays[name + "0_i"] = i0.cpu().numpy()
                info[name]["overflow0"] = ov0
            del st, td, ti
        del tree, pts, q
        torch.cuda.empty_cache()

        # the render set (phase 5's), the first render_n particles
        g = spec["render_grid"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        pos, w, r = lognormal_workload(256**3, 1024, gen)
        n = spec["render_n"]
        pos, w, r = pos[:n], w[:n], r[:n]
        vol, overflow = call("render", lambda: render_points_volume_sharded(
            pos, w, r, float(g), g, periodic=True, mesh=mesh), warm=False)
        info["render_stats"] = render_points_volume_sharded.stats
        info["overflow"] = overflow
        t0 = time.perf_counter()
        info["digest"] = hashlib.sha256(memoryview(vol).cast("B")).hexdigest()
        info["digest_s"] = time.perf_counter() - t0
        if rank == 0:
            # the single process's render of the same inputs: the device
            # stage of phase 5's render_points_volume, before its copy to
            # the host
            ref = get_point_renderer(g, 4, Container(device=dev)
                                     )._render_volume_device(
                pos, w, r, g, float(g), (1.0, 1.0, 1.0))
            got = torch.from_numpy(vol).to(dev)
            info["render_err"] = check_close(
                f"phase {phase} sharded render vs one process", got, ref)
            info["mass_ratio"] = float(got.sum(dtype=torch.float64)) / float(
                w.sum(dtype=torch.float64))
            del ref, got
        np.savez(os.path.join(tmp, f"{phase}_rank{rank}.npz"), **arrays)
        with open(os.path.join(tmp, f"{phase}_rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(phase: str, spec: dict, tmp: str) -> list:
    """Run :func:`sharded_rank` on ``spec["nprocs"]`` spawned processes;
    fails when a rank raises or dies, or when the ranks do not all finish
    within ``spec["timeout"]`` seconds (a hung collective). Returns each
    rank's (arrays, info)."""
    import numpy as np
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    ctx = mp.start_processes(sharded_rank, args=(phase, spec, tmp),
                             nprocs=spec["nprocs"], join=False,
                             start_method="spawn")
    deadline = time.monotonic() + spec["timeout"]
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                fail(f"phase {phase}: the ranks did not finish in "
                     f"{spec['timeout']} s")
    except ProcessException as e:
        fail(f"phase {phase}: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    out = []
    for r in range(spec["nprocs"]):
        with np.load(os.path.join(tmp, f"{phase}_rank{r}.npz")) as z:
            arrays = dict(z)
        with open(os.path.join(tmp, f"{phase}_rank{r}.json")) as f:
            out.append((arrays, json.load(f)))
    return out


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _render_log(info: dict, g: int, n: int) -> str:
    st = info["render_stats"]
    return (f"{n} particles -> {g}^3 periodic: {info['ms']['render']:.3f} "
            f"ms; hops {st['hops']}, rows sent down {st['rows_down']} / up "
            f"{st['rows_up']}, received {st['rows_received']}; exchange "
            f"{st['exchange_s'] * 1e3:.3f} ms, {st['exchange_bytes']} B; "
            f"gather {st['gather_s'] * 1e3:.3f} ms (in all_gather "
            f"{st['gather_wire_s'] * 1e3:.3f} ms); sha256 "
            f"{info['digest_s'] * 1e3:.1f} ms; launches "
            f"{_nonzero(info['launches']['render'])}")


def _tree_log(info: dict, name: str) -> str:
    t, st = info[name], info[name]["stats"]
    rounds = "; ".join(
        f"hop {r['hop']}{'+' if r['direction'] > 0 else '-'} sent "
        f"{r['sent']}, received {r['received']}, over cap {r['over_cap']}"
        for r in st["rounds"]) or "no hop rounds"
    return (f"build {info['ms'][name + '_build']:.3f} ms (slab counts "
            f"{t['counts']}, fullest cell {t['max_cell_count']}); query "
            f"{info['ms'][name]:.3f} ms, of it local answers "
            f"{st['local_s'] * 1e3:.3f} ms and exchanges "
            f"{st['exchange_s'] * 1e3:.3f} ms ({rounds}); {st['escalated']} "
            f"rows past the first rung, {st['brute']} at the brute backstop; "
            f"overflow {t['overflow']}; launches {info['launches'][name]}")


def sharded_phase(tmp: str, harness, smi: str,
                  spec: dict = SHARDED_SPEC) -> dict:
    """Phase 8: the sharded path on spawned ranks. 8a: one NCCL rank on
    the card (device tensors in every collective) at a smaller size, held
    to the single process. 8b: two gloo ranks on the one card (exchanges
    staged through the host; NCCL takes no two ranks on one GPU) at full
    size: the 256^3 -> 1024^3 render held to one process's render,
    ``KDTree.query(workers=-1)`` on the harness and ``knn_query_sharded``
    at k=200 held bit for bit to kNN-3's and kNN-2's single-process
    answers, the kNN-CDF equal to one computed here from the same
    queries. Every rank must return the same and launch each kernel of
    its path. ``harness``: kNN-3's (tree, queries, distances, indices).
    Returns the kernels' launches on the path, summed over ranks."""
    import numpy as np

    from nbodyhpc_tpu_torch.kdtree import KDTree
    from nbodyhpc_tpu_torch.parallel.stats import cdf_queries

    t_phase = time.perf_counter()
    total = dict.fromkeys(SHARDED_KERNELS, 0)

    def need(phase, info, call, names):
        for name in names:
            if info["launches"][call][name] == 0:
                fail(f"phase {phase}: a rank's {call} call launched no "
                     f"{name}: {info['launches'][call]}")

    def add(info):
        for counts in info["launches"].values():
            for name, c in counts.items():
                total[name] += c

    torch.cuda.empty_cache()
    a = spec["8a"]
    (_, info), = spawn_ranks("8a", a, tmp)
    if info["backend"] != a["backend"] or info["overflow"] != 0:
        fail(f"phase 8a: backend {info['backend']}, overflow "
             f"{info['overflow']}")
    need("8a", info, "knn", ("knn_topk",))
    need("8a", info, "render", ("splat_align", "splat_deposit"))
    add(info)
    log(f"phase 8a ({smi}): one {a['backend']} rank on {a['device']}: "
        f"knn_query_sharded {a['knn_q']} self-queries k={KNN_K} on "
        f"{a['knn_n']} points {info['ms']['knn']:.3f} ms, bit-equal to the "
        f"single process, launches {_nonzero(info['launches']['knn'])}; "
        f"render "
        + _render_log(info, a["render_grid"], a["render_n"])
        + f"; the field within rtol {RTOL} atol {ATOL} of one process's "
        f"(max abs err {info['render_err']:.3e}), mass ratio "
        f"{info['mass_ratio']:.6f}")
    for name, what in (("tree", "periodic"), ("tree_open", "open")):
        if info[name]["overflow"] != 0:
            fail(f"phase 8a: the {what} sharded tree's overflow is "
                 f"{info[name]['overflow']}")
        log(f"phase 8a ({smi}): {what} slab-sharded tree, {a['knn_q']} "
            f"self-queries k={KNN_K} on {a['knn_n']} points, tensors in and "
            f"out: " + _tree_log(info, name) + "; against the single "
            f"process's query: " + _gate_log(info[name]["gate"]))

    b = spec["8b"]
    ranks = spawn_ranks("8b", b, tmp)
    arrays, info = ranks[0]
    for r, (arr_r, info_r) in enumerate(ranks):
        if info_r["backend"] != b["backend"] or info_r["overflow"] != 0:
            fail(f"phase 8b: rank {r}: backend {info_r['backend']}, "
                 f"overflow {info_r['overflow']}")
        if info_r["digest"] != info["digest"] or arr_r.keys() != arrays.keys():
            fail(f"phase 8b: rank {r} returned another field or key set")
        for key, val in arrays.items():
            if not np.array_equal(arr_r[key], val):
                fail(f"phase 8b: rank {r}'s {key} differs from rank 0's")
        need("8b", info_r, "knn", ("knn_topk",))
        need("8b", info_r, "knn2", ("knn_select",))
        need("8b", info_r, "cdf", ("knn_topk",))
        need("8b", info_r, "render", ("splat_align", "splat_deposit"))
        add(info_r)
    if abs(info["mass_ratio"] - 1.0) > 0.01:
        fail(f"phase 8b: mass ratio {info['mass_ratio']:.6f} not within 1% "
             f"of 1")

    tree, queries, d, idx = harness
    if not (np.array_equal(arrays["knn_d"].view(np.int32),
                           d.cpu().numpy().view(np.int32))
            and np.array_equal(arrays["knn_i"],
                               idx.cpu().numpy().astype(np.uint32))):
        fail("phase 8b: query(workers=-1) differs from kNN-3's answer")
    pts2, q2 = knn_inputs(b["knn2_n"], b["knn2_q"], SEED + 11,
                          queries.device, True)
    d2, i2 = KDTree(pts2, boxsize=1.0, leafsize=KNN2_LEAFSIZE).query(
        q2.cpu().numpy(), k=KNN2_K)
    if not (np.array_equal(arrays["knn2_d"].view(np.int32),
                           d2.view(np.int32))
            and np.array_equal(arrays["knn2_i"], i2)):
        fail(f"phase 8b: knn_query_sharded at k={KNN2_K} differs from the "
             f"single process's query")
    del pts2, q2, d2, i2

    # the slab-sharded tree, default hops, against kNN-3's answer; hops=0
    # on the first queries: rows off the exact answer within the overflow
    dev = queries.device
    for r, (_, info_r) in enumerate(ranks):
        if (info_r["tree"]["overflow"] != 0 or info_r["tree"]["overflow0"]
                != info["tree"]["overflow0"]):
            fail(f"phase 8b: rank {r}'s sharded tree overflow is "
                 f"{info_r['tree']['overflow']}, at hops=0 "
                 f"{info_r['tree']['overflow0']}")
    td = torch.from_numpy(arrays["tree_d"]).to(dev)
    ti = torch.from_numpy(arrays["tree_i"]).to(dev)
    pts, _ = knn_inputs(b["knn_n"], b["knn_q"], SEED + 10, dev, False)
    gate = tree_gate("phase 8b sharded tree", td, ti, d, idx, pts, queries,
                     1.0)
    del pts
    tied_t = check_sample("phase 8b sharded tree", tree._tree,
                          queries[:1000], td[:1000], ti[:1000], KNN_K,
                          tol=TREE_TOL)
    n0, ov0 = b["tree_q0"], info["tree"]["overflow0"]
    d0 = torch.from_numpy(arrays["tree0_d"]).to(dev)
    i0 = torch.from_numpy(arrays["tree0_i"]).to(dev)
    off = ((i0 != idx[:n0]).any(1)
           | ((d0 - d[:n0]).abs() > ulp_tolerance(d[:n0], TREE_TOL)).any(1))
    off = int(off.sum())
    if not 0 < ov0 or off > ov0:
        fail(f"phase 8b: hops=0 on {n0} queries: {off} rows off the exact "
             f"answer, overflow {ov0}")
    del td, ti, d0, i0
    for r, (_, info_r) in enumerate(ranks):
        log(f"phase 8b ({smi}): rank {r} slab-sharded tree, {b['knn_q']} "
            f"self-queries k={KNN_K} on {b['knn_n']} points: "
            + _tree_log(info_r, "tree"))
    log(f"phase 8b: the sharded tree against kNN-3's answer: "
        + _gate_log(gate) + f"; a 1000-query sample within one ulp + "
        f"{TREE_TOL:.3g} of brute force ({tied_t} rows with near ties "
        f"inside the k); hops=0 on {n0} queries: overflow {ov0}, {off} rows "
        f"off the exact answer")
    radii = np.linspace(0.0, CDF_RMAX, CDF_NR).astype(np.float32)
    cq, qloc = cdf_queries(tree._tree, b["knn_q"], b["nprocs"], seed=0)
    dc, _ = tree.query(cq, k=max(CDF_K))
    kth = dc[:, [k - 1 for k in CDF_K]]
    hist = (kth[:, :, None] <= radii[None, None, :]).sum(0)
    cdf = hist.astype(np.float32) / (b["nprocs"] * qloc)
    if not (np.array_equal(arrays["cdf"], cdf)
            and np.array_equal(arrays["cdf_r"], radii)):
        fail("phase 8b: knn_cdf_sharded differs from the single process's "
             "CDF of the same queries")
    ms = [i_r["ms"] for _, i_r in ranks]
    log(f"phase 8b ({smi}): {b['nprocs']} {b['backend']} ranks sharing "
        f"{b['device']}, every "
        f"rank's answers identical. query(workers=-1) {b['knn_q']} "
        f"self-queries k={KNN_K} on {b['knn_n']} points, bit-equal to "
        f"kNN-3: rank ms {[round(m['knn'], 3) for m in ms]}, launches "
        f"{[_nonzero(i_r['launches']['knn']) for _, i_r in ranks]}; "
        f"knn_query_sharded "
        f"{b['knn2_q']} queries k={KNN2_K}, bit-equal to one process: rank "
        f"ms {[round(m['knn2'], 3) for m in ms]}, launches "
        f"{[_nonzero(i_r['launches']['knn2']) for _, i_r in ranks]}; "
        f"knn_cdf_sharded "
        f"k={CDF_K} on {b['nprocs'] * qloc} queries, equal to one "
        f"process's: rank ms {[round(m['cdf'], 3) for m in ms]}, launches "
        f"{[_nonzero(i_r['launches']['cdf']) for _, i_r in ranks]}")
    for r, (_, info_r) in enumerate(ranks):
        log(f"phase 8b: rank {r} render "
            + _render_log(info_r, b["render_grid"], b["render_n"]))
    log(f"phase 8b: the gathered {b['render_grid']}^3 field within rtol "
        f"{RTOL} atol {ATOL} of one process's render (max abs err "
        f"{info['render_err']:.3e}), mass ratio {info['mass_ratio']:.6f}, "
        f"overflow 0")
    log(f"phase 8: launches on the sharded path, summed over ranks: {total}; "
        f"{time.perf_counter() - t_phase:.1f} s of command time")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-deposit", metavar="PATH",
                    help="another splat_deposit.cu to time against the "
                         "package's kernel, in turns")
    ap.add_argument("--baseline-topk", metavar="PATH",
                    help="another knn_topk.cu, full-scan or with the "
                         "package's entry point (its knn_common.h beside "
                         "it), to time against B3, in turns")
    ap.add_argument("--baseline-dist", metavar="PATH",
                    help="another knn_dist.cu (its knn_common.h beside it) "
                         "to time against B4's block sink, in turns")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2

    from nbodyhpc_tpu_torch import _build
    from nbodyhpc_tpu_torch.ops import ghosts, splat_cuda as sc
    from nbodyhpc_tpu_torch.rasterizer import (
        Container,
        PointRenderer,
        render_points_volume,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    # ---- phase 1: card, versions, kernel build --------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.load()
    log(f"phase 1: kernels built in {lib.build_seconds:.2f} s (nvcc), "
        f"loaded in {time.perf_counter() - t0:.2f} s: {lib.path.name}")

    # ---- the full-size workload (phase 5's), made up front --------------
    n_full, g_full = 256**3, 1024
    gen.manual_seed(SEED)
    pos, w, r = lognormal_workload(n_full, g_full, gen)
    gp, gw, gr = ghosts.augment_points_periodic(pos, w, r, (1.0, 1.0, 1.0))
    part = sc.prepartition(gp, gw, gr, float(g_full), (g_full,) * 3)
    del gp, gw, gr
    pops = {f"G{g.F}": t[-1] - t[0] for g, t in zip(sc.BUCKETS, part.wtabs)}
    pops["dense"] = part.n_huge
    log(f"full-size workload: {n_full} particles + "
        f"{part.pos_px.shape[0] - n_full} ghosts -> {g_full}^3; "
        f"bucket populations {pops}; max radius {part.max_rpx:.2f} px")

    # ---- phase 2: B1 align kernel vs plain, full-size G8 stream ---------
    bi = 1
    geom = sc.BUCKETS[bi]
    r0, r1 = part.wtabs[bi][0], part.wtabs[bi][-1]
    prep = sc._prep_body(part.pos_px[r0:r1], part.w[r0:r1], part.rpx[r0:r1],
                         part.key[r0:r1] - part.kbases[bi], part.grid, geom)
    srcf, srci, starts, cnts, aoff = prep
    nrows = int(((cnts + geom.CH - 1) // geom.CH).sum()) * geom.CH
    ntiles_used = int((cnts > 0).sum())
    args = (starts, cnts, aoff, srcf, srci, geom.CH, geom.HALO, nrows)
    kf, ki = sc.align(*args)
    rf, ri = sc.align_reference(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kf.view(torch.int32), rf.view(torch.int32))
            and torch.equal(ki, ri)):
        fail("phase 2: align kernel output is not bit-equal to its plain "
             "version")
    align_bound_ms, align_bound_by = bound(
        48 * (r1 - r0) + 48 * nrows + 12 * starts.numel())
    align_ms = cuda_ms(lambda: sc.align(*args), 20)
    align_plain_ms = cuda_ms(lambda: sc.align_reference(*args), 20)
    log(f"phase 2: align kernel bit-equal to plain on the G8 stream "
        f"({r1 - r0} rows, {ntiles_used} tiles, {nrows} aligned rows); "
        f"kernel {align_ms:.3f} ms, plain {align_plain_ms:.3f} ms, bound "
        f"{align_bound_ms:.3f} ms ({align_bound_by})")
    del prep, srcf, srci, kf, ki, rf, ri

    # ---- phase 3: B2 deposit kernel vs plain ----------------------------
    # (a) every bucket plus sub-pixel particles, 2e4 particles into 64^3
    g3, n3 = 64, 20_000
    gen.manual_seed(SEED + 3)
    p3 = torch.rand((n3, 3), generator=gen, device=dev)
    rpx3 = torch.rand(n3, generator=gen, device=dev) * 15.0
    rpx3[: n3 // 10] = 0.05 + 0.4 * rpx3[: n3 // 10] / 15.0  # sub-pixel
    w3 = 0.5 + torch.rand(n3, generator=gen, device=dev)
    part3 = sc.prepartition(p3, w3, rpx3 / g3, float(g3), (g3,) * 3)
    err3 = 0.0
    for bi, geom in enumerate(sc.BUCKETS):
        stream = sc.bucket_stream(part3, bi)
        if stream is None:
            fail(f"phase 3: bucket G{geom.F} is empty")
        attrs, _, nch = stream
        vk = sc.deposit(attrs, nch, torch.zeros((g3,) * 3, device=dev), geom)
        vr = sc.deposit_reference(attrs, nch,
                                  torch.zeros((g3,) * 3, device=dev), geom)
        torch.cuda.synchronize()
        e = check_close(f"phase 3 deposit G{geom.F}", vk, vr)
        err3 = max(err3, e)
        log(f"phase 3: deposit G{geom.F}: {part3.wtabs[bi][-1] - part3.wtabs[bi][0]}"
            f" particles, {nch} chunks, max abs err {e:.3e}")
    del part3, p3, rpx3, w3

    # (b) times at the full-size streams: a prefix of each bucket's chunks,
    # as many as the card holds in flight at once (8 blocks of 256 threads
    # per SM), so the kernel runs at full occupancy while the plain version
    # stays within seconds
    k_max = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    dep_ms = dep_plain_ms = dep_bytes = 0.0
    err_full = 0.0
    vol_k = torch.empty((g_full,) * 3, device=dev)
    vol_r = torch.empty((g_full,) * 3, device=dev)
    for bi, geom in enumerate(sc.BUCKETS):
        stream = sc.bucket_stream(part, bi)
        if stream is None:
            continue
        attrs, _, nch = stream
        k = min(nch, k_max)
        vol_k.zero_()
        vol_r.zero_()
        sc.deposit(attrs, k, vol_k, geom)
        sc.deposit_reference(attrs, k, vol_r, geom)
        torch.cuda.synchronize()
        e = check_close(f"phase 3 deposit G{geom.F} (full size)", vol_k, vol_r)
        err_full = max(err_full, e)
        dep_bytes += (k * geom.CH * DEPOSIT_ROW_BYTES
                      + VOXEL_RMW_BYTES * int(torch.count_nonzero(vol_k)))
        tk = cuda_ms(lambda: sc.deposit(attrs, k, vol_k, geom), 3)
        tr = cuda_ms(lambda: sc.deposit_reference(attrs, k, vol_r, geom), 1)
        dep_ms += tk
        dep_plain_ms += tr
        log(f"phase 3: deposit G{geom.F} full-size stream, first {k} of {nch} "
            f"chunks: kernel {tk:.3f} ms, plain {tr:.3f} ms, "
            f"max abs err {e:.3e}")
    dep_bound_ms, dep_bound_by = bound(dep_bytes)

    # (c) every bucket's whole stream into a zeroed volume: the kernel's
    # time (CUDA events, one launch each), the voxels it changes (which set
    # the byte bound), and the voxels the gates admit; with a baseline
    # source, both kernels in turns and their fields held to each other
    base_lib = None
    if opts.baseline_deposit:
        real = _build.load()
        base_lib = real._replace(lib=_SwappedLib(
            real.lib, "splat_deposit", load_baseline_source(
                opts.baseline_deposit, "splat_deposit",
                _build.SIGNATURES["splat_deposit"])))

    def kernel_of(who: str):
        """Context in which ``sc.deposit`` launches the package's kernel
        ("new") or the baseline source's ("base")."""
        if who == "new":
            return contextlib.nullcontext()
        return mock.patch.object(_build, "load", lambda: base_lib)

    full_ms = full_base_ms = 0.0
    for bi, geom in enumerate(sc.BUCKETS):
        stream = sc.bucket_stream(part, bi)
        if stream is None:
            continue
        attrs, _, nch = stream
        turns = (("base", "new", "new", "base") * 2 if base_lib
                 else ("new",) * 3)
        times = {"new": [], "base": []}
        for who in turns:
            vol = vol_k if who == "new" else vol_r
            vol.zero_()
            with kernel_of(who):
                times[who].append(event_ms(
                    lambda: sc.deposit(attrs, nch, vol, geom)))
        nnz = int(torch.count_nonzero(vol_k))
        gated = gated_voxels(attrs, nch, geom, part.grid)
        b_ms, b_by = bound(nch * geom.CH * DEPOSIT_ROW_BYTES
                           + VOXEL_RMW_BYTES * nnz)
        t_new = sum(times["new"]) / len(times["new"])
        full_ms += t_new
        log(f"phase 3: deposit G{geom.F} whole stream ({nch} chunks, "
            f"{nch * geom.CH} rows) into a zeroed {g_full}^3 volume: kernel "
            f"{t_new:.3f} ms (launches {[round(t, 3) for t in times['new']]});"
            f" {nnz} voxels changed, {gated} gated; bound {b_ms:.3f} ms "
            f"({b_by}), share of bound {b_ms / t_new:.4f}; "
            f"{t_new * 1e6 / max(gated, 1):.4f} ns per gated voxel")
        if base_lib:
            e = check_close(f"phase 3 deposit G{geom.F} kernel vs baseline",
                            vol_k, vol_r)
            t_base = sum(times["base"]) / len(times["base"])
            full_base_ms += t_base
            log(f"phase 3: deposit G{geom.F} whole stream, baseline source: "
                f"{t_base:.3f} ms (launches "
                f"{[round(t, 3) for t in times['base']]}), "
                f"{t_base / t_new:.2f}x the kernel's time; fields agree, "
                f"max abs err {e:.3e}")
    log(f"phase 3: whole-stream deposits, all buckets: kernel "
        f"{full_ms:.3f} ms" + (f", baseline source {full_base_ms:.3f} ms"
                               if base_lib else ""))
    del vol_k, vol_r, attrs, stream, vol
    torch.cuda.empty_cache()

    # ---- phase 4: main path, moderate size, against the CPU -------------
    n4, g4 = 50_000, 128
    gen.manual_seed(SEED + 4)
    p4, w4, r4 = lognormal_workload(n4, g4, gen)
    profiling.reset()
    vol4 = render_points_volume(p4, w4, r4, float(g4), g4, periodic=True)
    launches4 = tuple(_launches()[k]
                      for k in ("splat_align", "splat_deposit"))
    if min(launches4) == 0:
        fail(f"phase 4: a kernel was not launched (align, deposit) = "
             f"{launches4}")
    cpu = PointRenderer(Container(device="cpu"), g4, g4, engine="cuda")
    t0 = time.perf_counter()
    ref4 = cpu.render_points_volume(p4.cpu(), w4.cpu(), r4.cpu(), g4,
                                    float(g4), period=(1.0, 1.0, 1.0))
    cpu_s = time.perf_counter() - t0
    if not (vol4.flags["F_CONTIGUOUS"] and vol4.dtype.name == "float32"):
        fail("phase 4: output is not an F-order float32 array")
    err4 = check_close("phase 4 render vs CPU", torch.from_numpy(vol4),
                       torch.from_numpy(ref4))
    log(f"phase 4: {n4} particles -> {g4}^3 periodic: card equals CPU "
        f"(plain versions, {cpu_s:.1f} s) within rtol {RTOL} atol {ATOL}, "
        f"max abs err {err4:.3e}; launches (align, deposit) {launches4}")

    # ---- phase 5: main path, full size ----------------------------------
    def render():
        return render_points_volume(pos, w, r, float(g_full), g_full,
                                    periodic=True)

    vol = render()  # warm-up
    del vol
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = render()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    took = _launches()
    launches = {"align": took["splat_align"],
                "deposit": took["splat_deposit"]}
    if min(launches.values()) == 0:
        fail(f"phase 5: a kernel was not launched on the main path: "
             f"{launches}")
    if vol.shape != (g_full,) * 3 or not vol.flags["F_CONTIGUOUS"]:
        fail(f"phase 5: output shape {vol.shape} / order is wrong")
    if not bool(torch.isfinite(torch.from_numpy(vol)).all()):
        fail("phase 5: non-finite voxels")
    ratio = float(vol.sum(dtype="float64")) / float(w.sum(dtype=torch.float64))
    if abs(ratio - 1.0) > 0.01:
        fail(f"phase 5: mass ratio {ratio:.6f} not within 1% of 1")
    del vol

    # the device render alone: pre-partitioned particles, field left on
    # the card (no ghosts, no sort, no copy to the host); with a baseline
    # source, renders with either deposit kernel in turns
    def device_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sc.splat_volume(part, None, None, float(g_full), (g_full,) * 3)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    dvol, engine_s = device_render()
    if base_lib:
        del dvol
        turns_s = {"new": [], "base": []}
        for who in ("base", "new", "new", "base"):
            with kernel_of(who):
                dvol, t = device_render()
            turns_s[who].append(t)
            del dvol
        log(f"phase 5: device render of the partition in turns (s): "
            f"baseline deposit {turns_s['base']}, kernel {turns_s['new']}")
        dvol, engine_s = device_render()
    dratio = float(dvol.sum(dtype=torch.float64)) / float(
        w.sum(dtype=torch.float64))
    del dvol
    log(f"phase 5: {n_full} particles -> {g_full}^3 periodic, subsample 4: "
        f"render_points_volume {render_s:.3f} s "
        f"({n_full / render_s / 1e6:.2f} Mparticles/s), mass ratio "
        f"{ratio:.6f}; device render of the partition {engine_s:.3f} s "
        f"({n_full / engine_s / 1e6:.2f} Mparticles/s), mass ratio "
        f"{dratio:.6f}; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # removed at the end, or by its finalizer when a phase fails
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    path, renderer, ref6 = file_phase(tmp.name, pos, w, r, g_full, smi)
    del pos, w, r, part
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    kernels = [
        {"name": "splat_align", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/splat_align.cu",
         "replaces": "nbodyhpc_tpu/ops/splat_pallas.py:518",
         "launches": launches["align"], "max_abs_err": 0.0,
         "ms": align_ms, "plain_ms": align_plain_ms,
         "bound_ms": align_bound_ms, "bound_by": align_bound_by,
         "library_ms": None},
        {"name": "splat_deposit", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/splat_deposit.cu",
         "replaces": "nbodyhpc_tpu/ops/splat_pallas.py:201",
         "launches": launches["deposit"], "max_abs_err": max(err3, err_full),
         "ms": dep_ms, "plain_ms": dep_plain_ms,
         "bound_ms": dep_bound_ms, "bound_by": dep_bound_by,
         "library_ms": None},
    ]
    base_topk = (baseline_topk(opts.baseline_topk) if opts.baseline_topk
                 else None)
    base_dist = (baseline_dist(opts.baseline_dist) if opts.baseline_dist
                 else None)
    knn_kernels, harness = knn_phases(dev, gen, smi, base_topk, base_dist)
    kernels += knn_kernels
    sharded = sharded_phase(tmp.name, harness, smi)
    for row in kernels:
        row["launches"] += sharded[row["name"]]
    cancel_phase(path, renderer, ref6, harness, smi)
    del ref6, harness
    trace_phase(path, renderer, smi)
    tmp.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
