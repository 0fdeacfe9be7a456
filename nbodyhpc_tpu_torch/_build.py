"""Build and load the package's CUDA kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package (one
process per source, all started together) and links the objects into one
shared library with a plain C interface, under ``_kernels/`` beside this
file, named by a hash of the sources and flags; later loads of the same
sources reuse it. The library is loaded with ``ctypes``: every pointer and the stream
are ``c_void_p``, every C entry point returns ``cudaGetLastError()`` after its
launch.

There is no fallback: a missing ``nvcc`` or a failed build raises a
``RuntimeError`` naming the command. The build needs ``nvcc`` with the
``sm_90a`` target (an NVIDIA Hopper GPU); it is found on ``PATH`` or under
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_DIR = Path(__file__).resolve().parent / "_kernels"

# --fmad=false: no multiply-add contraction, so the deposit kernel's subcell
# compares round exactly like the plain PyTorch version's.
# -Xptxas -v: registers, shared memory and spills per kernel, kept in the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    # starts cnts aoff srcf dstf ntiles src_stride dst_stride ch stream
    "splat_align": (_P, _P, _P, _P, _P, _I, _LL, _LL, _I, _P),
    # attrs stride nchunks ch F S vol gx gy gz stream
    "splat_deposit": (_P, _LL, _I, _I, _I, _I, _P, _I, _I, _I, _P),
    # gx gy gz (returns the tile count; no launch)
    "splat_dense_tiles": (_I, _I, _I),
    # pos rad val n gx gy gz cnt off stream
    "splat_dense_count": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # pos rad val n gx gy gz off cursor list stream
    "splat_dense_fill": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # pos rad val off list S vol gx gy gz counts stream
    "splat_dense": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P),
    # q qstride piece_q0 piece_qn piece_pid npieces run_start run_len
    # run_cell run_ncell nruns offsets xyz xstride periodic L0 L1 L2 iL0 iL1
    # iL2 C0 C1 C2 lo0 lo1 lo2 h0 h1 h2 ih0 ih1 ih2 m0 m1 m2 out_d2 out_slot
    # k row_base nrows counts stream
    "knn_topk": (_P, _LL, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _LL,
                 _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _F, _F, _F, _F, _F,
                 _F, _F, _F, _F, _F, _F, _F, _P, _P, _I, _I, _I, _P, _P),
    # ... out ncand row_base stream
    "knn_dist": (_P, _LL, _P, _P, _P, _I, _P, _P, _I, _P, _LL, _I, _F, _F,
                 _F, _F, _F, _F, _P, _I, _I, _P),
    # ... out_d2 out_slot k row_base stream
    "knn_select": (_P, _LL, _P, _P, _P, _I, _P, _P, _I, _P, _LL, _I, _F, _F,
                   _F, _F, _F, _F, _P, _P, _I, _I, _P),
    # queries nq offsets xyz npad periodic L0 L1 L2 iL0 iL1 iL2 C0 C1 C2 lo0
    # lo1 lo2 h0 h1 h2 ih0 ih1 ih2 nrungs r0 cap0 r1 cap1 r2 cap2 r3 cap3 k
    # out_d2 out_slot out_conv out_stats stream
    "knn_ladder": (_P, _I, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I,
                   _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
}


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    log: str              # nvcc's output (ptxas resource usage)


def find_nvcc() -> str | None:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.h"))


def source_tag() -> str:
    """Hash of the kernel sources and build flags (the library's name)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, hs = _sources()
    for p in cus + hs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(out_dir: Path = KERNEL_DIR) -> Library:
    """Compile (unless already built) and load the kernel library."""
    cus, _ = _sources()
    out = Path(out_dir) / f"libnbodyhpc_kernels_{source_tag()}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        nvcc = find_nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in cus]
        cmds = [[nvcc or "nvcc", *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                for p, o in zip(cus, objs)]
        link = [nvcc or "nvcc", *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        if nvcc is None:
            raise RuntimeError(
                "building the CUDA kernels needs nvcc, found neither on PATH "
                f"nor under $CUDA_HOME/bin; command: {' '.join(cmds[0])}"
            )
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        try:
            log = _run_all(cmds) + _run_all([link])
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        # atomic: a concurrent build never sees half a file
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.nbodyhpc_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.nbodyhpc_cuda_error_string.restype = ctypes.c_char_p
    return Library(lib, out, seconds, log)


def _run_all(cmds) -> str:
    """Run the commands in parallel; their joined output, or a RuntimeError
    naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"kernel build failed (exit {p.returncode}): "
                f"{' '.join(c)}\n{o}"
            )
    return "".join(outs)


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """The process-wide kernel library, built on first use."""
    return build()


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = load().lib.nbodyhpc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
