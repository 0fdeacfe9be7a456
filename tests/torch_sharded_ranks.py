"""Rank bodies of ``tests/test_torch_sharded.py``: the inputs of every case,
and what each rank of a spawned gloo group computes for it.

Imports torch and numpy only: ``torch.multiprocessing.spawn`` children
import this module to find :func:`run`. Every rank runs every case on the
CPU (``device="cpu"``, so the kernels' plain versions) and saves its
answers to ``<out>/rank<r>.npz``; the test functions compare them in the
parent, against the JAX package.
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def particles(n, seed, box=1.0):
    rng = np.random.Generator(np.random.Philox(seed))
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = (rng.random(n) * 0.08 + 0.01).astype(np.float32)
    return pos, w, r


#: k-NN cases: (points, queries, k, boxsize); cubic boxes only, see
#: ROADMAP's note on boxes with Ly == 1.0 and Lx != 1.0
KNN_CASES = {
    "knn_periodic": (particles(3000, 5)[0], particles(513, 6)[0], 6, 1.0),
    "knn_open": (particles(5000, 3)[0], particles(999, 4)[0], 8, None),
}

#: kNN-CDF cases: (points, boxsize, k, radii, n_queries, seed)
CDF_CASES = {
    "cdf_periodic": (particles(4000, 9)[0], 1.0, (1, 4),
                     np.linspace(0.0, 0.2, 16), 2048, 3),
    "cdf_open": (particles(2500, 10)[0], None, (1, 2, 8),
                 np.linspace(0.0, 0.25, 12), 1000, 4),
}


def _straddlers():
    """Particles centred exactly on z = 4, 8, ..., 28 px of a 32^3 grid:
    slab faces at 2, 4 and 8 ranks."""
    zb = np.arange(1, 8) * 4 / 32.0
    pos = np.stack([np.full(7, 0.5), np.linspace(0.2, 0.8, 7), zb],
                   axis=1).astype(np.float32)
    return pos, np.ones(7, np.float32), np.full(7, 0.07, np.float32)


def _two_slabs():
    """A 16^3 grid with radii up to 2.9 px: at 4 ranks a slab is 4 px
    deep, so a footprint reaches two slabs (hops = 2)."""
    rng = np.random.Generator(np.random.Philox(41))
    pos = rng.random((600, 3)).astype(np.float32)
    w = rng.random(600).astype(np.float32) + 0.5
    r = ((0.3 + rng.random(600) * 2.6) / 16.0).astype(np.float32)
    return pos, w, r


def _dense():
    """Radii below 3 px and three above 15 px (the dense tail) on 32^3."""
    rng = np.random.Generator(np.random.Philox(43))
    pos = rng.random((203, 3)).astype(np.float32)
    w = rng.random(203).astype(np.float32) + 0.5
    r = np.concatenate([(0.3 + rng.random(200) * 2.5) / 32.0,
                        (15.5 + rng.random(3) * 2.0) / 32.0]
                       ).astype(np.float32)
    return pos, w, r


def dryrun_inputs(nd):
    """``__graft_entry__.dryrun_multichip``'s render inputs at ``nd``
    devices: (positions, weights, radii, ppu, grid), periodic."""
    rng = np.random.Generator(np.random.Philox(7))
    n, gz = 2048, 8 * nd
    pos = (rng.random((n, 3)).astype(np.float32)
           * np.array([16.0 / gz, 16.0 / gz, 1.0], np.float32))
    w = np.ones(n, np.float32)
    r = ((rng.random(n) * 2.4 + 0.4) / gz).astype(np.float32)
    return pos, w, r, float(gz), (16, 16, gz)


#: render cases: (positions, weights, radii, ppu, grid, periodic, batch)
RENDER_CASES = {
    "render_periodic": (*particles(1000, 2), 24.0, (24, 24, 24), True, None),
    "render_open": (*particles(2000, 1), 32.0, (32, 32, 32), False, None),
    "render_straddlers": (*_straddlers(), 32.0, (32, 32, 32), False, None),
    "render_two_slabs": (*_two_slabs(), 16.0, (16, 16, 16), True, None),
    "render_dense": (*_dense(), 32.0, (32, 32, 32), False, None),
    "render_batched": (*particles(1500, 21), 32.0, (32, 32, 32), True, 128),
    "render_dryrun": (*dryrun_inputs(2), True, None),
}


def run(rank, nd, out, init_file, backend="gloo", device="cpu"):
    """Rank ``rank`` of ``nd``: join the ``backend`` group, run every case
    on ``device``, save this rank's answers."""
    from nbodyhpc_tpu_torch.kdtree import KDTree
    from nbodyhpc_tpu_torch.parallel.mesh import make_slab_mesh
    from nbodyhpc_tpu_torch.parallel.sharded import (
        knn_query_sharded,
        render_points_volume_sharded,
    )
    from nbodyhpc_tpu_torch.parallel.stats import knn_cdf_sharded

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=nd, rank=rank)
    try:
        mesh = make_slab_mesh(device=device)
        res = {}
        for name, (pts, q, k, box) in KNN_CASES.items():
            tree = KDTree(pts, boxsize=box, device=device)
            res[name + "_d"], res[name + "_i"] = knn_query_sharded(
                tree._tree, q, k, mesh=mesh)
            res[name + "_wd"], res[name + "_wi"] = tree.query(q, k=k,
                                                             workers=-1)
            res[name + "_1d"], res[name + "_1i"] = tree.query(q, k=k)
        for name, (pts, box, k, radii, nq, seed) in CDF_CASES.items():
            tree = KDTree(pts, boxsize=box, device=device)
            res[name + "_r"], res[name] = knn_cdf_sharded(
                tree._tree, k, radii, n_queries=nq, mesh=mesh, seed=seed)
        for name, (p, w, r, ppu, grid, per, batch) in RENDER_CASES.items():
            res[name], res[name + "_overflow"] = render_points_volume_sharded(
                p, w, r, ppu, grid, periodic=per, mesh=mesh, batch=batch)
            res[name + "_hops"] = render_points_volume_sharded.stats["hops"]
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def spawn(out, nd, backend="gloo", device="cpu", timeout=300):
    """Run :func:`run` on ``nd`` spawned ranks writing to ``out`` (a
    ``pathlib.Path``) and return every rank's answers, in rank order.
    Raises when a rank fails, or when the ranks do not all finish within
    ``timeout`` seconds (a hung collective)."""
    ctx = mp.start_processes(
        run, args=(nd, str(out), str(out / "init"), backend, device),
        nprocs=nd, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{nd} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    answers = []
    for r in range(nd):
        with np.load(out / f"rank{r}.npz") as z:
            answers.append(dict(z))
    return answers
