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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
