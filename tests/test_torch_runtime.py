"""The host runtime and profiling helpers of the PyTorch port against the JAX
package (CPU).

The cases of ``tests/test_runtime.py`` run through both packages
(parametrized on ``rt``); then files written by one package are read by the
other byte for byte, the port's reads and streams are held to the JAX
package's, and the port's error contract (ragged files, files that shrink,
empty files, streams closed half-way) is pinned.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import nbodyhpc_tpu.runtime as jrt
import nbodyhpc_tpu_torch.runtime as trt
from nbodyhpc_tpu_torch.utils import profiling


@pytest.fixture(params=["jax", "torch"])
def rt(request):
    return jrt if request.param == "jax" else trt


def _particles(n, seed):
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)).astype(np.float32),
            rng.random(n).astype(np.float32),
            rng.random(n).astype(np.float32))


def _thread_alive(name):
    return any(t.name.startswith(name) for t in threading.enumerate())


# ---- the cases of tests/test_runtime.py, through both packages -----------

def test_generate_uniform_deterministic(rt):
    a = rt.generate_uniform(1000, seed=5)
    b = rt.generate_uniform(1000, seed=5)
    np.testing.assert_array_equal(a, b)
    c = rt.generate_uniform(1000, seed=6)
    assert not np.array_equal(a, c)
    assert a.dtype == np.float32 and a.shape == (1000, 3)
    assert a.min() >= 0.0 and a.max() < 1.0


def test_particle_io_roundtrip(rt, tmp_path):
    pos, w, r = _particles(100, 3)
    path = str(tmp_path / "p.bin")
    rt.save_particles(path, pos, w, r)
    p2, w2, r2 = rt.load_particles(path)
    np.testing.assert_array_equal(pos, p2)
    np.testing.assert_array_equal(w, w2)
    np.testing.assert_array_equal(r, r2)


def test_load_points(rt, tmp_path):
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    path = str(tmp_path / "pts.bin")
    pts.tofile(path)
    np.testing.assert_array_equal(rt.load_points(path), pts)


def test_generate_uniform_format(rt):
    a = rt.generate_uniform(64, seed=1, boxsize=2.0)
    assert a.shape == (64, 3) and a.dtype == np.float32
    assert a.min() >= 0.0 and a.max() < 2.0


def test_field_save_load_roundtrip(rt, tmp_path):
    rng = np.random.Generator(np.random.Philox(8))
    field = rng.random((8, 12, 16)).astype(np.float32)
    path = str(tmp_path / "field.bin")
    rt.save_field(path, field)
    np.testing.assert_array_equal(rt.load_field(path), field)


def test_profiling_timer():
    out = []
    with profiling.timer("x", sink=out.append) as box:
        pass
    assert "seconds" in box and out and out[0].startswith("x:")


def test_stream_particles_matches_bulk_load(rt, tmp_path):
    """The double-buffered stream reproduces the bulk read, with ragged
    final batches and two interleaved streams."""
    n = 10_000
    pos, w, r = _particles(n, 23)
    path = str(tmp_path / "parts.bin")
    rt.save_particles(path, pos, w, r)
    for batch in (n, 4096, 1000, 3):  # exact, pow2, ragged tail, tiny
        chunks = list(rt.stream_particles(path, batch_rows=batch))
        for i, want in enumerate((pos, w, r)):
            np.testing.assert_array_equal(
                np.concatenate([c[i] for c in chunks]), want)
    s1 = rt.stream_particles(path, batch_rows=2048)
    s2 = rt.stream_particles(path, batch_rows=1500)
    a1 = [next(s1)[1], next(s2)[1], next(s1)[1], next(s2)[1]]
    assert a1[0].shape == (2048,) and a1[1].shape == (1500,)
    np.testing.assert_array_equal(a1[2], w[2048:4096])
    np.testing.assert_array_equal(a1[3], w[1500:3000])
    s1.close()
    s2.close()


# ---- the port against the JAX package -------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_particle_files_cross_read(writer, tmp_path):
    """A particle file written by either package has the same bytes and
    reads back the same in both."""
    pos, w, r = _particles(257, 31)
    paths = {}
    for name, mod in (("jax", jrt), ("torch", trt)):
        paths[name] = str(tmp_path / f"{name}.bin")
        mod.save_particles(paths[name], pos, w, r)
    assert (tmp_path / "jax.bin").read_bytes() == \
        (tmp_path / "torch.bin").read_bytes()
    for mod in (jrt, trt):
        got = mod.load_particles(paths[writer])
        for g, want in zip(got, (pos, w, r)):
            np.testing.assert_array_equal(g, want)
    pts = np.ascontiguousarray(pos)
    pts.tofile(paths[writer])
    np.testing.assert_array_equal(trt.load_points(paths[writer]),
                                  jrt.load_points(paths[writer]))


@pytest.mark.parametrize("shape", [(8, 12, 16), (5, 7)])
def test_field_files_cross_read(shape, tmp_path):
    """Fields and their ``.shape`` sidecars are byte-equal between the
    packages, and each reads the other's."""
    field = np.random.Generator(np.random.Philox(4)).random(shape).astype(
        np.float32)
    field = np.asfortranarray(field)  # a rendered field's order
    jp, tp = str(tmp_path / "jax.f"), str(tmp_path / "torch.f")
    jrt.save_field(jp, field)
    trt.save_field(tp, field)
    for suffix in ("", ".shape"):
        assert (tmp_path / f"jax.f{suffix}").read_bytes() == \
            (tmp_path / f"torch.f{suffix}").read_bytes()
    np.testing.assert_array_equal(trt.load_field(jp), field)
    np.testing.assert_array_equal(jrt.load_field(tp), field)


@pytest.mark.parametrize("seed", [0, 42])
def test_generate_uniform_matches_jax(seed):
    if jrt.HAVE_NATIVE:
        pytest.skip("the JAX package's native Philox stream keys differently "
                    "from numpy's; the port equals its numpy path")
    assert trt.HAVE_NATIVE is False
    a = trt.generate_uniform(1000, seed=seed, boxsize=3.0)
    np.testing.assert_array_equal(a, jrt.generate_uniform(1000, seed=seed,
                                                          boxsize=3.0))


def test_stream_matches_jax_stream(tmp_path):
    pos, w, r = _particles(5000, 12)
    path = str(tmp_path / "p.bin")
    trt.save_particles(path, pos, w, r)
    got = list(trt.stream_particles(path, batch_rows=1234))
    want = list(jrt.stream_particles(path, batch_rows=1234))
    assert len(got) == len(want) == 5
    for g, j in zip(got, want):
        for a, b in zip(g, j):
            assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(a, b)


# ---- the error contract ---------------------------------------------------

@pytest.mark.parametrize("reader", ["load_points", "load_particles",
                                    "stream_particles"])
@pytest.mark.parametrize("nbytes", [7 * 4, 22])
def test_ragged_file_raises(reader, nbytes, tmp_path):
    """A size that is not a whole number of records (7 floats, or 22 bytes
    that are not even whole floats) raises ``ValueError`` before any data
    comes back."""
    path = tmp_path / "ragged.bin"
    path.write_bytes(bytes(range(nbytes)))
    with pytest.raises(ValueError, match="multiple"):
        if reader == "stream_particles":
            next(trt.stream_particles(str(path), batch_rows=2))
        else:
            getattr(trt, reader)(str(path))


def test_stream_of_shrinking_file_raises(tmp_path):
    """A file cut short after the first batch raises ``OSError``, and
    every row that came back before it is the file's own."""
    pos, w, r = _particles(4000, 5)
    path = str(tmp_path / "p.bin")
    trt.save_particles(path, pos, w, r)
    got = []
    with pytest.raises(OSError, match="shrank"):
        stream = trt.stream_particles(path, batch_rows=1000)
        got.append(next(stream)[1])
        os.truncate(path, 1000 * 20)
        for _, wb, _ in stream:
            got.append(wb)
    assert 1 <= len(got) <= 2  # the second batch may be read already
    np.testing.assert_array_equal(np.concatenate(got), w[:1000 * len(got)])
    assert not _thread_alive("particle-reader")


def test_empty_file_streams_nothing(tmp_path):
    path = tmp_path / "empty.bin"
    path.write_bytes(b"")
    assert list(trt.stream_particles(str(path))) == []
    p, w, r = trt.load_particles(str(path))
    assert p.shape == (0, 3) and w.shape == (0,) and r.shape == (0,)


def test_stream_closed_half_way_joins_its_reader(tmp_path):
    pos, w, r = _particles(10_000, 6)
    path = str(tmp_path / "p.bin")
    trt.save_particles(path, pos, w, r)
    before = threading.active_count()
    stream = trt.stream_particles(path, batch_rows=1000)
    next(stream)
    assert _thread_alive("particle-reader")
    stream.close()
    assert threading.active_count() == before
    assert not _thread_alive("particle-reader")


def test_bad_batch_rows_raises(tmp_path):
    path = tmp_path / "p.bin"
    path.write_bytes(bytes(20))
    with pytest.raises(ValueError, match="positive"):
        next(trt.stream_particles(str(path), batch_rows=0))


def test_profiling_trace_cpu(tmp_path):
    """A CPU trace writes a Chrome trace that names the aten ops run."""
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as got:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert got == str(logdir)
    trace = json.loads((logdir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
