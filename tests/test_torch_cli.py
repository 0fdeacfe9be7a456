"""The CLIs of the PyTorch port against the JAX package's (CPU).

The rasterizer demo's file options (``--file``, ``--pixels-per-unit``,
``--periodic``, ``--stream``) print the same mass ratio as the JAX demo on
the same file, a streamed render the same as a whole one, and refuse what
the JAX demo refuses; the k-NN harness reads ``--file`` through the
runtime's validated reader. Every port run names ``--device cpu``.
"""
import re

import numpy as np
import pytest

from nbodyhpc_tpu.cli import rasterizer_demo as jdemo
from nbodyhpc_tpu_torch.cli import kdtree_bench as tbench
from nbodyhpc_tpu_torch.cli import rasterizer_demo as tdemo

RATIO = re.compile(r"mass conservation rendered/input: ([0-9.]+)")


@pytest.fixture
def particle_file(tmp_path):
    """tests/test_utils_cli.py's 200-particle file."""
    rng = np.random.Generator(np.random.Philox(9))
    n = 200
    rec = np.zeros((n, 5), np.float32)
    rec[:, :3] = rng.random((n, 3)) * 0.8 + 0.1
    rec[:, 3] = 1.0
    rec[:, 4] = 0.02
    f = tmp_path / "parts.bin"
    rec.tofile(f)
    return str(f)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    ratios = RATIO.findall(out)
    assert len(ratios) == 1, out
    return rc, float(ratios[0]), out


BASE = ["--grid", "32", "--pixels-per-unit", "32"]


def test_rasterizer_demo_cli_file(particle_file, capsys):
    rc, _, out = _run(tdemo.main, ["--file", particle_file, *BASE,
                                   "--device", "cpu"], capsys)
    assert rc == 0
    assert "loaded 200 particles" in out and "render: " in out


@pytest.mark.parametrize("periodic", [False, True])
def test_demo_file_ratio_matches_jax(particle_file, periodic, capsys):
    flags = ["--periodic"] if periodic else []
    argv = ["--file", particle_file, *BASE, *flags]
    rc_j, want, _ = _run(jdemo.main, argv, capsys)
    rc_t, got, _ = _run(tdemo.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert abs(got - want) <= 1e-5


def test_demo_stream_matches_bulk(particle_file, tmp_path, capsys):
    """Four prefetched batches of 64, 64, 64 and 8 rows sum to the whole
    render; the PNG is written from the one host copy."""
    _, bulk, _ = _run(tdemo.main, ["--file", particle_file, *BASE,
                                   "--device", "cpu"], capsys)
    png = str(tmp_path / "slice.png")
    rc, streamed, out = _run(tdemo.main, ["--file", particle_file, *BASE,
                                          "--stream", "64", "--png", png,
                                          "--device", "cpu"], capsys)
    assert rc == 0
    assert "streamed 200 particles" in out and "batches of 64" in out
    assert abs(streamed - bulk) <= 1e-5
    assert (tmp_path / "slice.png").read_bytes()[:4] == b"\x89PNG"


def test_demo_stream_refuses_periodic(particle_file):
    with pytest.raises(SystemExit) as e:
        tdemo.main(["--file", particle_file, *BASE, "--stream", "64",
                    "--periodic", "--device", "cpu"])
    assert e.value.code not in (0, None)


def test_demo_stream_refuses_empty_file(tmp_path):
    f = tmp_path / "empty.bin"
    f.write_bytes(b"")
    with pytest.raises(SystemExit) as e:
        tdemo.main(["--file", str(f), *BASE, "--stream", "64",
                    "--device", "cpu"])
    assert e.value.code not in (0, None)


def test_kdtree_bench_reads_file(tmp_path, capsys):
    pts = np.random.Generator(np.random.Philox(2)).random((1500, 3))
    f = tmp_path / "pts.bin"
    pts.astype(np.float32).tofile(f)
    rc = tbench.main(["--file", str(f), "--num-queries", "300", "-k", "4",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "points: 1500" in out and "self-query exact: True" in out


def test_kdtree_bench_refuses_ragged_file(tmp_path):
    f = tmp_path / "pts.bin"
    f.write_bytes(bytes(4 * 3 * 10 + 4))
    with pytest.raises(ValueError, match="multiple"):
        tbench.main(["--file", str(f), "--device", "cpu"])
