"""The benchmark's files: every one the cells name exists and parses, and
every name, unit and text keeps to the benchmark contract's characters."""
from __future__ import annotations

import json
import re

import pytest

from portbench import harness
from portbench.roofline import HBM_BYTES_PER_S, b3_bytes, least_ms, render_bytes

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _text_ok(word) and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"])
        assert _text_ok(c["why"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _text_ok(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    """Each cell's configuration, traffic, step kind, generator, limits and
    metric readers exist, and it reports setup_s, another end-to-end
    metric and a per-layer one."""
    c = harness.Cell(cell, BENCH)
    assert c.config["reduced"] == next(
        e["reduced"] for e in BENCH["configs"] if e["name"] == c.spec["config"])
    assert hasattr(c.kind, "Step") and hasattr(c.generator, "make")
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e, layer = harness.cell_metrics(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert hasattr(harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py"), "read")


def test_every_config_used_and_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])
        json.loads((harness.ROOT / f).read_text())


def test_byte_arithmetic():
    assert render_bytes(256 ** 3, 1024 ** 3) == 20 * 256 ** 3 + 4 * 1024 ** 3
    assert b3_bytes(10_000_000, 500_000, 16) == (
        12 * 10_000_000 + 12 * 500_000 + 8 * 16 * 500_000)
    assert least_ms(HBM_BYTES_PER_S) == pytest.approx(1e3)
    # the uniform render's least time: 4.63 GB at 3.35 TB/s
    assert least_ms(render_bytes(256 ** 3, 1024 ** 3)) == pytest.approx(
        1.3822, rel=1e-4)
