"""The k-NN slice of the PyTorch port against the JAX package (CPU).

The same numpy-made inputs go through both packages. Distances are held
bit-equal (both sides evaluate the same float32 expressions and select
exactly) and indices equal (tie-free random data, plus deliberate ties for
the lowest-position rule). Where the JAX function reaches a Pallas kernel it
runs in interpret mode, at the sizes of the JAX package's own CPU tests.
The candidate kernels' wrappers take their plain versions here, because
every tensor lies on the CPU.
"""
from fractions import Fraction

import numpy as np
import pytest
import scipy.spatial
import torch

import jax.numpy as jnp
from nbodyhpc_tpu.core import cells as jcells
from nbodyhpc_tpu.kdtree import KDTree as JKDTree
from nbodyhpc_tpu.ops import knn as jknn
from nbodyhpc_tpu.ops.metrics import wrap_min_image as jwrap
from nbodyhpc_tpu.utils.stats import knn_cdf as jknn_cdf

from nbodyhpc_tpu_torch import interop
from nbodyhpc_tpu_torch.core import cells as tcells
from nbodyhpc_tpu_torch.kdtree import KDTree as TKDTree
from nbodyhpc_tpu_torch.ops import knn as tknn
from nbodyhpc_tpu_torch.ops import knn_device as tkd
from nbodyhpc_tpu_torch.ops.metrics import fma_f32
from nbodyhpc_tpu_torch.ops.metrics import wrap_min_image as twrap
from nbodyhpc_tpu_torch.utils.stats import knn_cdf as tknn_cdf

CPU = torch.device("cpu")


def _points(n, seed, box=1.0):
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)) * box).astype(np.float32)


def _clustered(seed):
    rng = np.random.Generator(np.random.Philox(seed))
    cluster = rng.normal(scale=0.001, size=(3000, 3)).astype(np.float32) + 0.5
    sparse = rng.random((50, 3)).astype(np.float32)
    return np.clip(np.concatenate([cluster, sparse]), 0.0, 0.999999
                   ).astype(np.float32)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.int32)


def assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def port_tree(jt: JKDTree):
    """The port's cell list carrying the JAX tree's exact sorted state."""
    t = jt._tree
    return interop.cell_list_from_jax(
        t.xyz, t.index, t.offsets_host(), t.dims, t.lo, t.cell_size,
        t.inv_cell_size, t.n, t.periodic, t.boxsize, t.max_cell_count)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1.0, 1.3, 2.0, 0.0, -1.0])
def test_wrap_min_image_matches_jax(L):
    rng = np.random.Generator(np.random.Philox(3))
    d = (rng.random(4000) * 4.0 - 2.0).astype(np.float32) * np.float32(
        abs(L) or 1.0)
    Lf = np.float32(L)
    half = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.0, -0.0],
                    np.float32) * Lf
    d = np.concatenate([d, half]).astype(np.float32)
    want = np.asarray(jwrap(jnp.asarray(d), float(L)))
    got = twrap(torch.from_numpy(d), float(L)).numpy()
    assert_bit_equal(got, want)
    if L > 0:
        # half way rounds to even: +-L/2 stays, +-3L/2 maps to -+L/2
        np.testing.assert_array_equal(got[-8:-2], half[:6] - Lf * np.round(
            half[:6] / Lf))


def _round_f32(x: Fraction) -> np.float32:
    """Nearest float32 to an exact rational, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_f32_is_correctly_rounded():
    rng = np.random.Generator(np.random.Philox(9))
    a = (rng.random(600) * 2 - 1).astype(np.float32)
    b = (rng.random(600) * 2 - 1).astype(np.float32)
    c = (rng.random(600) * 2 - 1).astype(np.float32) * np.float32(1e-3)
    # a case where rounding the float64 sum first rounds the wrong way:
    # exact 1 + 2^-23 + 2^-24 - 2^-70 lies just below a float32 midpoint
    a = np.append(a, np.float32(1 + 2.0**-23))
    b = np.append(b, np.float32(2.0**-24 * (1 - 2.0**-23)))
    c = np.append(c, np.float32(1 + 2.0**-23))
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert_bit_equal(got, want)
    assert got[-1] == np.float32(1 + 2.0**-23)


# ---------------------------------------------------------------------------
# cell-list build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "periodic", "clustered", "empty"])
def test_cell_list_build_matches_jax(case):
    box = None
    if case == "clustered":
        pts = _clustered(5)
    elif case == "empty":
        pts = np.zeros((0, 3), np.float32)
    else:
        pts = _points(6000, 91, box=2.0)
        box = 2.0 if case == "periodic" else None
    got = tcells.build_cell_list(pts, boxsize=box, occupancy=6.0)
    builds = [jcells.build_cell_list(pts, boxsize=box, occupancy=6.0,
                                     device=False)]
    if len(pts):
        # the jitted _sort_build_core (the JAX device build) on the CPU
        builds.append(jcells.build_cell_list(pts, boxsize=box,
                                             occupancy=6.0, device=True))
    for want in builds:
        np.testing.assert_array_equal(got.dims, want.dims)
        for f in ("lo", "cell_size", "inv_cell_size"):
            assert_bit_equal(getattr(got, f), getattr(want, f))
        assert (got.n, got.periodic, got.max_cell_count) == (
            want.n, want.periodic, want.max_cell_count)
        assert_bit_equal(got.xyz.numpy(), np.asarray(want.xyz))
        np.testing.assert_array_equal(got.index.numpy(),
                                      np.asarray(want.index).astype(np.int32))
        np.testing.assert_array_equal(got.offsets.numpy(), want.offsets_host())
        if box is not None:
            assert_bit_equal(got.boxsize, want.boxsize)


def test_cell_list_from_jax_round_trip():
    jt = JKDTree(_points(3000, 4), boxsize=1.0)
    tree = port_tree(jt)
    own = TKDTree(_points(3000, 4), boxsize=1.0, device="cpu")._tree
    assert tree.index.dtype == torch.int32 and tree.device == CPU
    assert torch.equal(tree.xyz, own.xyz) and torch.equal(tree.index,
                                                          own.index)
    assert torch.equal(tree.offsets, own.offsets)
    assert tree.ncells == own.ncells and tree.npad == own.npad


# ---------------------------------------------------------------------------
# brute force and the streaming pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("box", [None, (1.0, 1.0, 1.0), (1.5, 1.0, 2.0)])
def test_brute_force_matches_jax(box):
    scale = np.float32(2.0) if box is None else np.asarray(box, np.float32)
    pts = _points(3000, 17) * scale
    q = _points(200, 18) * scale
    dj, ij = jknn.brute_force_knn(pts, q, 12, box)
    dt, it = tknn.brute_force_knn(pts, q, 12, box)
    assert_bit_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("periodic", [False, True])
def test_streaming_pass_matches_jax_and_masks_padding(periodic):
    """k beyond n: the tail must stay inf. Periodic, the min-image wrap maps
    a pad sentinel's displacement to exactly 0, so only the slot mask keeps
    the padding out."""
    pts = _points(700, 23)
    jt = JKDTree(pts, boxsize=1.0 if periodic else None)
    tree = port_tree(jt)
    q = _points(64, 24)
    box = (1.0, 1.0, 1.0) if periodic else None
    k = 705
    d2j, sj = jknn._streaming_brute_pass(jnp.asarray(jt._tree.xyz), 700,
                                         jnp.asarray(q), k, box, block=256)
    d2t, st = tknn._streaming_brute_pass(tree.xyz, 700, torch.from_numpy(q),
                                         k, box, block=256)
    assert_bit_equal(d2t.numpy(), d2j)
    fin = np.isfinite(np.asarray(d2j))
    assert fin.sum(1).tolist() == [700] * 64
    np.testing.assert_array_equal(st.numpy()[fin], np.asarray(sj)[fin])
    if periodic:
        # unmasked, a sentinel slot would sit at distance 0
        pad = tree.xyz[:, 700:].T[:, :3]
        assert float(tknn.sq_dist([torch.tensor([[0.5]])] * 3, *pad[:4].T,
                                  box).min()) == 0.0


# ---------------------------------------------------------------------------
# the exact ladder
# ---------------------------------------------------------------------------


def _ladder_case(name):
    """(points, queries, boxsize, k) for each ladder case."""
    if name == "plain":
        return _points(8000, 31), _points(300, 32), None, 8
    if name == "periodic":
        return (_points(8000, 33, 2.0), _points(300, 34, 2.0) * 1.5 - 0.5,
                2.0, 8)
    if name == "clustered":
        return _clustered(5), _points(200, 35), None, 6
    if name == "k_gt_n":
        return _points(40, 36), _points(20, 37), None, 50
    if name == "far":
        rng = np.random.Generator(np.random.Philox(38))
        pts = (rng.random((20000, 3)) * 3.0).astype(np.float32)
        return pts, (rng.random((8, 3)) * 3.0 + 100.0).astype(np.float32), \
            None, 3
    raise ValueError(name)


@pytest.mark.parametrize("case", ["plain", "periodic", "clustered", "k_gt_n",
                                  "far"])
def test_ladder_matches_jax(case):
    pts, q, box, k = _ladder_case(case)
    jt = JKDTree(pts, boxsize=box)
    want = jknn.cell_knn_query(jt._tree, jt._dev, q, k, with_stats=True)
    for tree in (port_tree(jt), TKDTree(pts, boxsize=box, device="cpu")._tree):
        got = tknn.cell_knn_query(tree, q, k, with_stats=True,
                                  use_kernel="never")
        assert_bit_equal(got.distances.numpy(), want.distances)
        np.testing.assert_array_equal(got.indices.numpy().astype(np.uint32),
                                      want.indices)
        for g, w in zip(got.stats, want.stats):
            np.testing.assert_array_equal(g.numpy(), w)


def test_ladder_ties_take_the_lowest_position():
    """Points placed symmetrically about every query tie exactly; both
    packages keep the candidate found first (cube-offset order, then slot),
    and the brute pass keeps [best, new] order."""
    g = np.arange(8, dtype=np.float32) / np.float32(8.0) + np.float32(1 / 16)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    # lattice cell corners: 8 equal distances each
    q = pts[(pts < 0.8).all(1)][::7] + np.float32(1 / 16)
    for box in (None, 1.0):
        jt = JKDTree(pts, boxsize=box, leafsize=32)
        want_d, want_i = jt.query(q, k=8)
        assert (want_d[:, 0] == want_d[:, -1]).all()  # a tie across all 8
        got_d, got_i = tknn.cell_knn_query(port_tree(jt), q, 8,
                                           use_kernel="never")[:2]
        assert_bit_equal(got_d.numpy(), want_d)
        np.testing.assert_array_equal(got_i.numpy().astype(np.uint32),
                                      want_i)
        bd, bi = jknn.brute_force_knn(pts, q, 8, None if box is None
                                      else (box,) * 3)
        td, ti = tknn.brute_force_knn(pts, q, 8, None if box is None
                                      else (box,) * 3)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(bi))


# ---------------------------------------------------------------------------
# the whole slice through the public API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 16, 130])
def test_kdtree_matches_jax(periodic, k):
    box = 1.0 if periodic else None
    pts = _points(20000, 41)
    q = _points(2048, 42)
    # k > 128: cells of ~64 points, so the r = 1 bound certifies the k-th
    # neighbour and the kernel route's own answers (B4's plain version and
    # the stable-sort selection) reach the result
    leafsize = 1024 if k > 128 else 128
    want_d, want_i = JKDTree(pts, boxsize=box, leafsize=leafsize).query(q, k=k)
    tree = TKDTree(pts, boxsize=box, device="cpu", leafsize=leafsize)
    for engine in ("kernel", "auto"):
        d, i = tree.query_device(torch.from_numpy(q), k=k, engine=engine)
        if engine == "kernel":
            assert tkd.query_blocks_device.ladder_queries < len(q) // 2
        assert i.dtype == torch.int32
        assert_bit_equal(d.numpy(), want_d)
        np.testing.assert_array_equal(i.numpy().astype(np.uint32), want_i)
    d, i = tree.query(q, k=k)
    assert d.dtype == np.float32 and i.dtype == np.uint32
    assert_bit_equal(d, want_d)
    np.testing.assert_array_equal(i, want_i)


@pytest.mark.parametrize("periodic", [False, True])
def test_query_radius_count_matches_jax(periodic):
    box = 1.0 if periodic else None
    pts = _points(4000, 51)
    q = _points(256, 52)
    r = np.linspace(0.01, 0.12, 256).astype(np.float32)
    jt = JKDTree(pts, boxsize=box)
    tt = TKDTree(pts, boxsize=box, device="cpu")
    for engine in ("cells", "dense", "auto"):
        want = jknn_ball(jt, q, r, engine)
        got = tt.query_radius_count(q, r, engine=engine)
        np.testing.assert_array_equal(got, want)
    ref = scipy.spatial.KDTree(pts, boxsize=box)
    expect = np.array([len(v) for v in ref.query_ball_point(q, r)])
    assert np.abs(got - expect).max() <= 1  # float32 vs float64 boundary


def jknn_ball(jt, q, r, engine):
    from nbodyhpc_tpu.ops.ball import ball_count

    return ball_count(jt._tree, jt._dev, q, r, engine=engine)


def test_knn_cdf_matches_jax():
    pts = _points(5000, 61)
    for box in (1.0, None):
        rj, cj = jknn_cdf(pts, k=(1, 4), n_queries=2000, boxsize=box, seed=2)
        rt, ct = tknn_cdf(pts, k=(1, 4), n_queries=2000, boxsize=box, seed=2,
                          device="cpu")
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(ct, cj)


# --- API edge cases of tests/test_kdtree.py, on the port -------------------


def test_api_reshape_kwargs_and_invalid_inputs():
    points = _points(500, 11)
    tree = TKDTree(points, device="cpu")
    queries = _points(24, 12).reshape(2, 3, 4, 3)
    dist, idx = tree.query(queries, k=2)
    assert dist.shape == idx.shape == (2, 3, 4, 2)
    _, i2 = tree.query(queries.reshape(-1, 3), k=2)
    np.testing.assert_array_equal(idx.reshape(-1, 2), i2)
    with pytest.warns(UserWarning):
        TKDTree(points, bogus_arg=1, device="cpu")
    with pytest.warns(UserWarning):
        tree.query(points[:4], k=1, bogus=2)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tree.query(points[:4], k=bad)
        with pytest.raises(ValueError):
            tree.query_device(torch.from_numpy(points[:4]), k=bad)
    with pytest.raises(ValueError):
        tree.query_device(torch.from_numpy(points[:4]), k=1, engine="fast")
    with pytest.raises(ValueError):
        TKDTree(np.zeros((4, 2)), device="cpu")
    with pytest.raises(ValueError):
        TKDTree(points * 10.0, boxsize=1.0, device="cpu")
    with pytest.raises(ValueError):
        TKDTree(torch.from_numpy(points) * 10.0, boxsize=1.0)


def test_api_k_larger_than_n_properties_and_workers():
    pts = _points(5, 21)
    tree = TKDTree(pts, device="cpu")
    dist, idx = tree.query(pts[:3], k=8, workers=4)
    assert np.isfinite(dist[:, :5]).all() and np.isinf(dist[:, 5:]).all()
    assert (idx[:, 5:] == 5).all()
    jd, ji = JKDTree(pts).query(pts[:3], k=8)
    assert_bit_equal(dist, jd)
    np.testing.assert_array_equal(idx, ji)
    p2 = _points(300, 33, box=2.0)
    t2 = TKDTree(p2, boxsize=2.0)
    assert (t2.n, t2.size, t2.periodic, t2.boxsize) == (300, 300, True, 2.0)
    assert t2.device == CPU  # numpy in, no card: the CPU
    t3 = TKDTree(torch.from_numpy(p2), boxsize=(2.0, 2.0, 3.0))
    assert t3.boxsize == (2.0, 2.0, 3.0) and t3.device == CPU
    assert TKDTree(p2).boxsize is None


def test_self_query_and_scipy_periodic():
    pts = _points(10000, 7, box=2.0)
    q = _points(200, 8, box=2.0)
    tree = TKDTree(pts, boxsize=2.0, device="cpu")
    d, i = tree.query(q, k=4)
    rd, ri = scipy.spatial.KDTree(pts, boxsize=2.0).query(q, k=4)
    np.testing.assert_array_equal(i, ri.astype(np.uint32))
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-6)
    ds, _ = tree.query(pts[:300], k=1)
    assert (ds[:, 0] == 0).all()


def test_kdtree_bench_cli(capsys):
    from nbodyhpc_tpu_torch.cli.kdtree_bench import main

    rc = main(["--num-points", "2000", "--num-queries", "500", "-k", "4",
               "--device", "cpu", "--periodic"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "self-query exact: True" in out and "on cpu" in out
    assert "% points visited" in out


def test_philox_matches_jax():
    from nbodyhpc_tpu.utils import philox as jph
    from nbodyhpc_tpu_torch.utils import philox as tph

    np.testing.assert_array_equal(tph.random_points(100, 7, 2.0),
                                  jph.random_points(100, 7, 2.0))
    for a, b in zip(tph.random_particles(50, 3), jph.random_particles(50, 3)):
        np.testing.assert_array_equal(a, b)
