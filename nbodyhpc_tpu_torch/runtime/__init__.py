"""Host runtime: particle and field file I/O, and a prefetching stream.

PyTorch port of :mod:`nbodyhpc_tpu.runtime`, with the same names and file
formats: packed float32 ``(x, y, z)`` triples (reference: kdtree/src/cpp/
main.cpp:103-114), packed ``(x, y, z, weight, radius)`` records
(rasterization/src/cpp/main.cpp:86-101), and a raw float32 field with a
``.shape`` sidecar. Files written by either package read back in the other.

There is no C extension here (``HAVE_NATIVE`` is False): reads go through
``readinto`` into preallocated numpy buffers, which releases the GIL, and
:func:`stream_particles` prefetches the next batch on one reader thread
per open stream, as the JAX package's native loader does. Errors follow
that loader: a file whose size is not a whole number of records raises
``ValueError`` before anything is returned, and a file that shrinks while
it is read raises ``OSError`` instead of returning fabricated rows.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HAVE_NATIVE = False

_POINT_FLOATS, _PARTICLE_FLOATS = 3, 5


def _record_count(f, width: int, path: str) -> int:
    """Records of ``width`` float32 in the open file ``f``; raises
    ``ValueError`` when its size is not a whole number of them."""
    size = os.fstat(f.fileno()).st_size
    if size % (4 * width):
        raise ValueError(f"{path}: size {size} is not a multiple of the "
                         f"{width}-float record width")
    return size // (4 * width)


def _read_into(f, rec: np.ndarray, path: str) -> None:
    """Fill ``rec`` from the file's current position; raises ``OSError``
    at an end of file before it is full (the file shrank)."""
    view = memoryview(rec.reshape(-1).view(np.uint8))
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise OSError(f"{path}: file ended after {got} of {len(view)} "
                          f"bytes; it shrank while it was read")
        got += n


def _load_records(path: str, width: int) -> np.ndarray:
    with open(path, "rb", buffering=0) as f:
        rec = np.empty((_record_count(f, width, path), width), np.float32)
        _read_into(f, rec, path)
    return rec


def _split(rec: np.ndarray):
    return rec[:, :3].copy(), rec[:, 3].copy(), rec[:, 4].copy()


def load_points(path: str) -> np.ndarray:
    """(N, 3) float32 positions from a packed float3 file."""
    return _load_records(path, _POINT_FLOATS)


def load_particles(path: str):
    """(positions, weights, radii) from packed (x, y, z, w, r) records."""
    return _split(_load_records(path, _PARTICLE_FLOATS))


def save_particles(path: str, positions, weights, radii) -> None:
    rec = np.empty((len(weights), _PARTICLE_FLOATS), np.float32)
    rec[:, :3] = positions
    rec[:, 3] = weights
    rec[:, 4] = radii
    rec.tofile(path)


def save_field(path: str, density: np.ndarray) -> None:
    """Persist a density field (float32 raw + .shape sidecar) — the analog of
    the reference demo's golden binary dumps (rasterization/src/cpp/
    main.cpp:74-83)."""
    arr = np.ascontiguousarray(np.asarray(density), np.float32)
    arr.tofile(path)
    with open(path + ".shape", "w") as f:
        f.write(" ".join(str(s) for s in arr.shape))


def load_field(path: str) -> np.ndarray:
    with open(path + ".shape") as f:
        shape = tuple(int(v) for v in f.read().split())
    return np.fromfile(path, dtype=np.float32).reshape(shape)


def stream_particles(path: str, batch_rows: int = 4_000_000):
    """Yield (positions (B, 3), weights (B,), radii (B,)) batches, copies,
    from packed (x, y, z, w, r) records, double-buffered: a reader thread
    fills one buffer with batch i+1 while the caller works on batch i — the
    host analog of the reference's dedicated transfer queue overlapping
    uploads with compute (rasterization/src/cpp/vulkan_support.cpp:204-237).

    Close the generator when leaving it early (``contextlib.closing``): that
    joins the reader thread and closes the file. An exception that leaves a
    ``for`` loop keeps the generator alive in its traceback until it is
    cleared."""
    batch_rows = int(batch_rows)
    if batch_rows <= 0:
        raise ValueError(f"batch_rows must be positive, got {batch_rows}")
    with open(path, "rb", buffering=0) as f:
        nrec = _record_count(f, _PARTICLE_FLOATS, path)
        if nrec == 0:
            return
        rows = min(batch_rows, nrec)
        bufs = [np.empty((rows, _PARTICLE_FLOATS), np.float32)
                for _ in range(2)]
        reader = ThreadPoolExecutor(1, thread_name_prefix="particle-reader")
        try:
            def submit(i):
                b = min(rows, nrec - i * rows)
                rec = bufs[i % 2][:b]
                return rec, reader.submit(_read_into, f, rec, path)

            pending = submit(0)
            for i in range(-(-nrec // rows)):
                rec, fut = pending
                fut.result()
                if (i + 1) * rows < nrec:
                    pending = submit(i + 1)
                yield _split(rec)
        finally:
            reader.shutdown(wait=True, cancel_futures=True)


def generate_uniform(n: int, seed: int = 42, boxsize: float = 1.0,
                     nthreads: int = 0) -> np.ndarray:
    """(n, 3) float32 uniform positions in ``[0, boxsize)`` from
    ``np.random.Philox(seed)``: the JAX package's values wherever its
    native module is not built (that module's threaded Philox stream keys
    differently). ``nthreads`` is accepted for the same signature."""
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)) * boxsize).astype(np.float32)
