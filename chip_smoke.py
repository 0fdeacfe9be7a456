#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbodyhpc_tpu_torch``) on one GPU.

Builds the kernels from ``nbodyhpc_tpu_torch/csrc/`` with nvcc, holds each
against its plain PyTorch version on the card, drives the volume render
(``nbodyhpc_tpu_torch.rasterizer.render_points_volume``) at a moderate size
against the same render on the CPU, then at full size: 256^3 particles into
a 1024^3 grid, periodic, subsample 4. Every phase is an assertion; any
failure exits non-zero before the result line. Needs one CUDA device and
``nvcc`` (sm_90a); run from the repository root:

    python3 chip_smoke.py

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path,
its largest difference from its plain version and both times.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SEED = 2024
# atomics reorder float sums; built with --fmad=false, so no subcell quantum
RTOL, ATOL = 2e-5, 1e-6


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
KNN_PIECES = 1056  # 8 blocks per SM x 132 SMs, as phase 3 times B2
# the k > 128 route: a 1e6-point periodic tree, 2e4 random queries; cells
# of 64 points (leafsize 1024), so the r = 1 bound certifies the 200th
# neighbour and the kernel's answers reach the result (at the default 8 per
# cell every query would finish on the ladder)
KNN2_N, KNN2_Q, KNN2_K = 1_000_000, 20_000, 200
KNN2_LEAFSIZE = 1024


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same float32 bit patterns, inf included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the finite entries of ``want``."""
    diff = torch.where(torch.isfinite(want), (got - want).abs(), 0.0)
    return float(diff.max()) if diff.numel() else 0.0


def synced(fn):
    """(fn(), wall ms) with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_busy_ms(fn, top: int = 6):
    """(device busy ms, wall ms, the ``top`` device activities by ms) of one
    ``fn()`` under ``torch.profiler``. Busy time is the union of the
    intervals of the device's kernels, copies and fills; wall time is the
    same call's, the device drained before and after. The profiler also
    reports each operator's span on the device as an annotation around its
    kernels; those would count the kernels twice and are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_ms = synced(fn)
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e3
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    rows = sorted(((ms, name) for name, ms in by_name.items()), reverse=True)
    return (busy_us / 1e3, wall_ms,
            {name[:48]: round(ms, 3) for ms, name in rows[:top]})


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


def check_sample(name: str, cl, queries, d, idx, k: int) -> int:
    """Fails unless (d, idx) of ``queries`` equal the plain brute force:
    distances bit-equal, indices equal. The k nearest must be unique (no
    tie at the k-th distance); rows with equal distances inside the k keep
    the engine's candidate order, so there the index sets are compared.
    Returns the number of such rows."""
    from nbodyhpc_tpu_torch.ops.metrics import sqrt_f32

    d2b, sb = brute_knn(cl, queries, k)
    edge = (d2b[:, k - 1] == d2b[:, k]) & torch.isfinite(d2b[:, k])
    if bool(edge.any()):
        fail(f"{name}: {int(edge.sum())} sample rows tie at the k-th "
             f"distance; the k nearest are not unique")
    want_d = sqrt_f32(d2b[:, :k])
    want_i = cl.index[sb[:, :k]].to(idx.dtype)
    if not bits_equal(d, want_d):
        bad = int((d.view(torch.int32) != want_d.view(torch.int32)).any(1)
                  .sum())
        fail(f"{name}: distances of {bad} sample rows differ from brute force")
    tied = (d2b[:, 1:k] == d2b[:, :k - 1]).any(1)
    same = (idx == want_i).all(1)
    same_set = (torch.sort(idx, 1).values == torch.sort(want_i, 1).values
                ).all(1)
    if not bool((same | (tied & same_set)).all()):
        fail(f"{name}: indices of {int((~same).sum())} sample rows differ "
             f"from brute force")
    return int(tied.sum())


def knn_phases(dev: torch.device, gen: torch.Generator) -> list:
    """Phases kNN-1..4: B3 and B4 against their plain versions at the main
    path's shapes, the main path at the reference harness's size, and the
    k > 128 route. Returns the kernels' entries for the result line."""
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
    m = min(KNN_PIECES, npieces)
    nrows = int(st.piece_q0[m - 1] + st.piece_qn[m - 1])
    args3 = (st.qs.T.contiguous(), st.piece_q0[:m], st.piece_qn[:m],
             st.piece_pid[:m], plan.run_start, plan.run_len, cl.xyz, plan.box)
    dk, sk = kc.knn_topk(*args3, KNN_K, nrows=nrows)
    dr, sr = kc.knn_topk_reference(*args3, KNN_K + 1, nrows=nrows)
    torch.cuda.synchronize()
    edge = int(((dr[:, -2] == dr[:, -1]) & torch.isfinite(dr[:, -1])).sum())
    if edge:
        fail(f"kNN-1: {edge} rows tie at the k-th candidate distance")
    if not (bits_equal(dk, dr[:, :KNN_K])
            and torch.equal(sk, sr[:, :KNN_K])):
        fail("kNN-1: B3 is not bit-equal to its plain version")
    b3_err = max_err(dk, dr[:, :KNN_K])
    b3_ms = cuda_ms(lambda: kc.knn_topk(*args3, KNN_K, nrows=nrows), 10)
    b3_plain_ms = cuda_ms(
        lambda: kc.knn_topk_reference(*args3, KNN_K, nrows=nrows), 1)
    log(f"kNN-1: B3 bit-equal to plain on the first {m} pieces ({nrows} "
        f"queries, k={KNN_K}): kernel {b3_ms:.3f} ms, plain "
        f"{b3_plain_ms:.3f} ms")
    del args3, dk, sk, dr, sr

    # ---- kNN-2: B4 vs plain, k > 128 ---------------------------------------
    n2, q2, k2 = KNN2_N, KNN2_Q, KNN2_K
    gen.manual_seed(SEED + 11)
    pts2 = torch.rand((n2, 3), generator=gen, device=dev)
    queries2 = torch.rand((q2, 3), generator=gen, device=dev)
    tree2 = KDTree(pts2, boxsize=1.0, leafsize=KNN2_LEAFSIZE)
    cl2 = tree2._tree
    plan2 = kd.tree_plan(cl2)
    st2 = kd._stage_sort(cl2, plan2, queries2)
    ncand = int(plan2.points[st2.piece_pid.long()].max())
    args4 = (st2.qs.T.contiguous(), st2.piece_q0, st2.piece_qn, st2.piece_pid,
             plan2.run_start, plan2.run_len, cl2.xyz, plan2.box, ncand)
    bk = kc.knn_dist(*args4)
    br = kc.knn_dist_reference(*args4)
    torch.cuda.synchronize()
    if not bits_equal(bk, br):
        fail("kNN-2: B4 is not bit-equal to its plain version")
    b4_err = max_err(bk, br)
    sel, _ = kc.select_block(br, k2 + 1, st2.pid, plan2.run_start,
                             plan2.run_len)
    if int(((sel[:, -2] == sel[:, -1]) & torch.isfinite(sel[:, -1])).sum()):
        fail("kNN-2: rows tie at the k-th candidate distance")
    b4_ms = cuda_ms(lambda: kc.knn_dist(*args4), 10)
    b4_plain_ms = cuda_ms(lambda: kc.knn_dist_reference(*args4), 1)
    log(f"kNN-2: B4 bit-equal to plain: {n2} points periodic, plan "
        f"{'FULLZ' if plan2.fullz else 'ZSEG'}, {q2} queries "
        f"in {st2.piece_q0.numel()} pieces, block {tuple(bk.shape)}: kernel "
        f"{b4_ms:.3f} ms, plain {b4_plain_ms:.3f} ms")
    del args4, bk, br, sel

    # ---- kNN-3: the main path at full size ---------------------------------
    tree.query_device(queries, k=KNN_K)  # warm-up
    kc.knn_topk.launches = kc.knn_dist.launches = 0
    (d, idx), qd_ms = synced(lambda: tree.query_device(queries, k=KNN_K))
    b3_launches = kc.knn_topk.launches
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
    log(f"kNN-3: query_device {KNN_Q} self-queries k={KNN_K}: "
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
    log(f"kNN-3: stage split (ms): build again {rebuild_ms:.3f}, stage sort "
        f"{t_sort:.3f}, B3 {t_b3:.3f}, epilogue {t_epi:.3f}, unconverged "
        f"{t_bad:.3f}, ladder ({bad.numel()} queries) {t_lad:.3f}")
    busy_ms, wall_ms, top = device_busy_ms(
        lambda: tree.query_device(queries, k=KNN_K))
    idle = 1 - busy_ms / wall_ms
    if not 0.0 <= idle <= 1.0:
        fail(f"kNN-3: idle share {idle} outside [0, 1] (busy {busy_ms} ms, "
             f"wall {wall_ms} ms)")
    log(f"kNN-3: profiled query_device: device busy {busy_ms:.3f} ms of its "
        f"wall {wall_ms:.3f} ms, idle share {idle:.3f}; by kernel (ms): "
        f"{top}")
    del tree, cl, plan, st, pts, queries, d, idx, d2s, slot, cv
    torch.cuda.empty_cache()

    # ---- kNN-4: the k > 128 route end to end -------------------------------
    kc.knn_topk.launches = kc.knn_dist.launches = 0
    (d4, i4), k4_ms = synced(lambda: tree2.query_device(queries2, k=k2))
    b4_launches = kc.knn_dist.launches
    ladder4 = kd.query_blocks_device.ladder_queries
    if b4_launches == 0:
        fail("kNN-4: B4 was not launched on the k > 128 route")
    if ladder4 >= q2 // 2:
        fail(f"kNN-4: {ladder4} of {q2} queries finished on the ladder; the "
             f"kernel route certified too few")
    # the sample: queries the kernel route certified, so B4's answers (not
    # the ladder's) are held to brute force
    d2c, slotc = kd.candidate_topk(cl2, plan2, st2, k2)
    _, _, cv2 = kd._epilogue(cl2, plan2, d2c, slotc, st2.qs, st2.qcs)
    cert = st2.orig[cv2]
    if cert.numel() != q2 - ladder4:
        fail(f"kNN-4: {cert.numel()} certified rows, {q2 - ladder4} expected")
    rows = cert[torch.randperm(cert.numel(), generator=gen,
                               device=dev)[:1024]]
    tied4 = check_sample("kNN-4", cl2, queries2[rows], d4[rows], i4[rows],
                         k2)
    log(f"kNN-4: query_device {q2} queries k={k2} on {n2} points (cells of "
        f"{n2 / cl2.ncells:.1f} points): {k4_ms:.3f} ms; B4 launches "
        f"{b4_launches}; {ladder4} queries on the ladder; 1024 of the "
        f"kernel-certified queries equal brute force ({tied4} rows with ties)")

    return [
        {"name": "knn_topk", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/knn_topk.cu",
         "replaces": "nbodyhpc_tpu/ops/knn_pallas.py:204",
         "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms},
        {"name": "knn_dist", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/knn_dist.cu",
         "replaces": "nbodyhpc_tpu/ops/knn_pallas.py:185",
         "launches": b4_launches, "max_abs_err": b4_err,
         "ms": b4_ms, "plain_ms": b4_plain_ms},
    ]


def main() -> int:
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
    align_ms = cuda_ms(lambda: sc.align(*args), 20)
    align_plain_ms = cuda_ms(lambda: sc.align_reference(*args), 20)
    log(f"phase 2: align kernel bit-equal to plain on the G8 stream "
        f"({r1 - r0} rows, {ntiles_used} tiles, {nrows} aligned rows); "
        f"kernel {align_ms:.3f} ms, plain {align_plain_ms:.3f} ms")
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
    dep_ms = dep_plain_ms = 0.0
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
        tk = cuda_ms(lambda: sc.deposit(attrs, k, vol_k, geom), 3)
        tr = cuda_ms(lambda: sc.deposit_reference(attrs, k, vol_r, geom), 1)
        dep_ms += tk
        dep_plain_ms += tr
        log(f"phase 3: deposit G{geom.F} full-size stream, first {k} of {nch} "
            f"chunks: kernel {tk:.3f} ms, plain {tr:.3f} ms, "
            f"max abs err {e:.3e}")
    del vol_k, vol_r, attrs, stream
    torch.cuda.empty_cache()

    # ---- phase 4: main path, moderate size, against the CPU -------------
    n4, g4 = 50_000, 128
    gen.manual_seed(SEED + 4)
    p4, w4, r4 = lognormal_workload(n4, g4, gen)
    sc.align.launches = sc.deposit.launches = 0
    vol4 = render_points_volume(p4, w4, r4, float(g4), g4, periodic=True)
    launches4 = (sc.align.launches, sc.deposit.launches)
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
    sc.align.launches = sc.deposit.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = render()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = {"align": sc.align.launches, "deposit": sc.deposit.launches}
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
    # the card (no ghosts, no sort, no copy to the host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dvol = sc.splat_volume(part, None, None, float(g_full), (g_full,) * 3)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
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

    del pos, w, r, part
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    kernels = [
        {"name": "splat_align", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/splat_align.cu",
         "replaces": "nbodyhpc_tpu/ops/splat_pallas.py:518",
         "launches": launches["align"], "max_abs_err": 0.0,
         "ms": align_ms, "plain_ms": align_plain_ms},
        {"name": "splat_deposit", "route": "cuda",
         "source": "nbodyhpc_tpu_torch/csrc/splat_deposit.cu",
         "replaces": "nbodyhpc_tpu/ops/splat_pallas.py:201",
         "launches": launches["deposit"], "max_abs_err": max(err3, err_full),
         "ms": dep_ms, "plain_ms": dep_plain_ms},
    ]
    kernels += knn_phases(dev, gen)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
