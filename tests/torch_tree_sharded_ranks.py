"""Rank bodies of ``tests/test_torch_tree_sharded.py``: the inputs of every
case, and what each rank of a spawned gloo group computes for it.

Imports torch and numpy only: ``torch_sharded_ranks.spawn(..., fn=run)``
starts the ranks, and its spawn children import this module to find
:func:`run`. Every rank builds the slab-sharded tree of each case
(``device="cpu"`` in the CPU tests), queries it and saves its answers to
``<out>/rank<r>.npz``; the test functions compare them in the parent,
against the JAX package and the single-process ``KDTree``.
"""
import os

import numpy as np
import torch
import torch.distributed as dist


def points(n, seed, scale=1.0, shift=0.0):
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)) * scale + shift).astype(np.float32)


def _face_hugging(n, seed):
    """Queries with a fifth of them within 0.004 of z = 0 and a fifth within
    0.004 of z = 1: the single slab's periodic z bins."""
    q = points(n, seed)
    rng = np.random.Generator(np.random.Philox(seed + 1))
    f = n // 5
    q[:f, 2] = rng.uniform(0.0, 0.004, f)
    q[f:2 * f, 2] = rng.uniform(0.996, 1.0, f)
    return q


def _slab_faces():
    """x = y = 0.5 on the slab faces of 2, 4 and 8 ranks."""
    zb = np.arange(1, 8) / 8.0
    return np.stack([np.full(7, 0.5), np.full(7, 0.5), zb],
                    axis=1).astype(np.float32)


def _straddling_z0(n, seed):
    q = points(n, seed)
    rng = np.random.Generator(np.random.Philox(seed + 1))
    q[:, 2] = (rng.random(n) * 0.02 - 0.01) % 1.0
    return q.astype(np.float32)


#: cases held to the JAX function on a JAX mesh of the same size:
#: (points, queries, k, boxsize, hops, cap, world size). "jax_capped" runs
#: on "jax_periodic"'s JAX tree, carried across with sharded_tree_from_jax.
JAX_CASES = {
    "jax_one": (points(4000, 11), _face_hugging(700, 12), 8, 1.0, None,
                None, 1),
    "jax_open": (points(5000, 13), points(999, 14, 1.2, -0.1), 6, None, None,
                 None, 2),
    "jax_periodic": (points(4000, 15), points(800, 16), 8, 1.0, None, None,
                     4),
    "jax_capped": (points(4000, 15), points(800, 16), 8, 1.0, 1, 8, 4),
}

#: cases held to the single-process KDTree at 2 and 4 ranks:
#: (points, queries, k, boxsize)
TREE_CASES = {
    "faces": (points(3000, 46), _slab_faces(), 32, None),
    "wrap": (points(2500, 47), _straddling_z0(64, 48), 16, 1.0),
    "deep": (points(400, 51), points(64, 52), 128, None),
    "deep_periodic": (points(400, 57), points(64, 58), 100, 1.0),
    "outside": (points(2000, 53), points(64, 54, 2.0, -0.5), 5, None),
    "k_over_n": (points(100, 55), points(16, 56), 128, None),
    "uniform": (points(6000, 42), points(777, 43), 8, 1.0),
}

#: hops=0 and 1 on an open box: every answer is exact or counted in
#: overflow
LIMITED = (points(3000, 49), points(256, 50), 4, None)

#: queries and points as tensors: (points, queries, k, boxsize)
TENSOR = (points(3000, 61), points(300, 62), 8, 1.0)


def _on_slab_faces(n, seed):
    """Points with a quarter of them on the slab faces of 2 and 4 ranks in
    the unit box (z = 1/4, 1/2, 3/4)."""
    p = points(n, seed)
    p[:n // 4, 2] = np.resize(np.float32([0.25, 0.5, 0.75]), n // 4)
    return p


#: points built as an array and as a tensor: (points, boxsize)
BUILDS = {
    "build_periodic": (_on_slab_faces(3000, 63), 1.0),
    "build_open": (_on_slab_faces(3000, 64), None),
}

#: the JAX tree fields sharded_tree_from_jax takes, by name
JAX_TREE_FIELDS = ("xyz", "index", "offsets", "counts", "dims_loc", "lo",
                   "cell_size", "slab_depth", "periodic", "boxsize", "n",
                   "max_cell_count")


def assert_close_to_single(d, dref, pts, q):
    """Equal infinities; finite distances within one ulp plus 2^-22 Z, Z
    the largest |coordinate| of the inputs: a slab-local z carries one
    rounding of size up to 2^-24 Z for a point and two for a query (its
    localization and wrap), the single tree's ``q - p`` one; the root
    rounds once more. The JAX function differs from the single tree by as
    much (its test allows rtol 1e-5, atol 1e-7)."""
    fin = np.isfinite(dref)
    assert np.array_equal(np.isfinite(d), fin)
    z = max(float(np.abs(pts).max()), float(np.abs(q).max()), 1.0)
    tol = np.spacing(dref[fin]) + 2.0 ** -22 * z
    assert np.all(np.abs(d[fin] - dref[fin]) <= tol)


def _query(res, name, stree, q, k, **kw):
    from nbodyhpc_tpu_torch.parallel.tree_sharded import (
        knn_query_tree_sharded,
    )

    d, i, ov = knn_query_tree_sharded(stree, q, k, **kw)
    res[name + "_d"], res[name + "_i"], res[name + "_ov"] = d, i, ov
    st = knn_query_tree_sharded.stats
    res[name + "_escalated"], res[name + "_brute"] = (st["escalated"],
                                                      st["brute"])
    res[name + "_sent"] = sum(r["sent"] for r in st["rounds"])


def run(rank, nd, out, init_file, backend="gloo", device="cpu"):
    """Rank ``rank`` of ``nd``: join the ``backend`` group, run every case
    of this world size on ``device``, save this rank's answers."""
    from nbodyhpc_tpu_torch.interop import sharded_tree_from_jax
    from nbodyhpc_tpu_torch.parallel.mesh import make_slab_mesh
    from nbodyhpc_tpu_torch.parallel.tree_sharded import build_tree_sharded

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=nd, rank=rank)
    try:
        mesh = make_slab_mesh(device=device)
        res = {}
        for name, (pts, q, k, box, hops, cap, world) in JAX_CASES.items():
            if world != nd:
                continue
            if name == "jax_capped":
                with np.load(os.path.join(out, "jax_tree.npz")) as z:
                    f = {key: z[key] for key in JAX_TREE_FIELDS}
                for key in ("xyz", "index", "offsets"):
                    f[key] = f[key][rank]
                f["boxsize"] = f["boxsize"] if f["periodic"] else None
                stree = sharded_tree_from_jax(**f, mesh=mesh)
            else:
                stree = build_tree_sharded(pts, boxsize=box, mesh=mesh)
                for key in ("xyz", "index", "offsets", "counts",
                            "max_cell_count"):
                    val = getattr(stree, key)
                    res[f"{name}_{key}"] = (val.cpu().numpy()
                                            if torch.is_tensor(val) else val)
            _query(res, name, stree, q, k, hops=hops, cap=cap)
        for name, (pts, q, k, box) in TREE_CASES.items():
            stree = build_tree_sharded(pts, boxsize=box, mesh=mesh)
            _query(res, name, stree, q, k)
        pts, q, k, box = LIMITED
        stree = build_tree_sharded(pts, boxsize=box, mesh=mesh)
        for hops in (0, 1):
            _query(res, f"limited{hops}", stree, q, k, hops=hops)
        # points and queries as tensors on the rank's device
        pts, q, k, box = TENSOR
        stree = build_tree_sharded(torch.from_numpy(pts).to(device),
                                   boxsize=box, mesh=mesh)
        _query(res, "tensor", stree, torch.from_numpy(q).to(device), k)
        d, i = res["tensor_d"], res["tensor_i"]
        res["tensor_types"] = np.array([str(d.dtype), str(i.dtype),
                                        str(d.device), str(i.device)])
        res["tensor_d"], res["tensor_i"] = d.cpu().numpy(), i.cpu().numpy()
        # the slab partition on the host (by the division) and on the
        # device (by the multiplication)
        for name, (pts, box) in BUILDS.items():
            for kind, p in (("array", pts),
                            ("tensor", torch.from_numpy(pts).to(device))):
                stree = build_tree_sharded(p, boxsize=box, mesh=mesh)
                for key in ("xyz", "index", "offsets"):
                    res[f"{name}_{kind}_{key}"] = (
                        getattr(stree, key).cpu().numpy())
                res[f"{name}_{kind}_counts"] = stree.counts
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
