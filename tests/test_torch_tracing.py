"""The port's spans and counters (``nbodyhpc_tpu_torch.utils.profiling``).

On the CPU: with no profiler recording a span does nothing but counters
count; under ``torch.profiler`` a tiny periodic render (the tile engine's
plain versions) and a tiny k-NN query through the kernel route, with
queries left to the ladder and its brute pass, open every span at its layer
with the listed nesting; the counters equal counts made apart from the
program; the benchmark's six span readers give per-call means on a store
filled against a stand-in card clock. On the card (marker ``cuda``): every
span has device milliseconds, and no parent has fewer than its children.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.ops import knn_device as kd
from nbodyhpc_tpu_torch.ops import splat_cuda as sc
from nbodyhpc_tpu_torch.rasterizer import Container, PointRenderer
from nbodyhpc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
GRID, PPU, K = 32, 32.0, 16
CPU = [torch.profiler.ProfilerActivity.CPU]

#: every span of the render and k-NN paths, and the span it opens inside
#: (None: the outermost span of a public call)
PARENT = {
    "nbodyhpc.render": None,
    "nbodyhpc.render.inputs": "nbodyhpc.render",
    "nbodyhpc.render.ghosts": "nbodyhpc.render",
    "nbodyhpc.render.partition": "nbodyhpc.render",
    "nbodyhpc.render.buckets": "nbodyhpc.render",
    "nbodyhpc.render.dense": "nbodyhpc.render",
    "nbodyhpc.render.to_host": "nbodyhpc.render",
    "nbodyhpc.knn.build": None,
    "nbodyhpc.knn.query": None,
    "nbodyhpc.knn.plan": "nbodyhpc.knn.query",
    "nbodyhpc.knn.stage_sort": "nbodyhpc.knn.query",
    "nbodyhpc.knn.candidates": "nbodyhpc.knn.query",
    "nbodyhpc.knn.epilogue": "nbodyhpc.knn.query",
    "nbodyhpc.knn.ladder": "nbodyhpc.knn.query",
    "nbodyhpc.knn.rung": "nbodyhpc.knn.ladder",
    "nbodyhpc.knn.brute": "nbodyhpc.knn.ladder",
}

#: the benchmark's span readers: (span, public call)
READERS = {
    "render.partition_ms": ("nbodyhpc.render.partition", "nbodyhpc.render"),
    "render.deposit_ms": ("nbodyhpc.render.buckets", "nbodyhpc.render"),
    "render.dense_ms": ("nbodyhpc.render.dense", "nbodyhpc.render"),
    "knn.plan_ms": ("nbodyhpc.knn.plan", "nbodyhpc.knn.query"),
    "knn.stage_sort_ms": ("nbodyhpc.knn.stage_sort", "nbodyhpc.knn.query"),
    "knn.ladder_ms": ("nbodyhpc.knn.ladder", "nbodyhpc.knn.query"),
}


def _render_inputs():
    """Particles in the unit box at 32 px a unit: radii up to ~9 px, some
    across the faces, and two of 15.5 px inside every face (the dense
    pass's rows, with no clones)."""
    rng = np.random.Generator(np.random.Philox(3))
    n = 200
    pos = rng.random((n, 3)).astype(np.float32)
    r = np.clip(np.exp(0.5 * rng.standard_normal(n)) * 3.0, 0.2, 9.0)
    r = (r / PPU).astype(np.float32)
    pos[:2] = [[0.5, 0.5, 0.5], [0.51, 0.49, 0.5]]
    r[:2] = 15.5 / PPU
    return pos, np.ones(n, np.float32), r


def _knn_inputs():
    """Uniform points and a tight cluster at the box's centre; the queries
    are uniform points and three points 1.5-1.6 cells off the cluster,
    which the r = 1 bound cannot certify and whose cubes hold cells fuller
    than every rung's slice cap (so the brute pass runs)."""
    rng = np.random.Generator(np.random.Philox(5))
    uni = rng.random((4000, 3)).astype(np.float32)
    clu = (0.5 + 1e-3 * rng.standard_normal((3000, 3))).astype(np.float32)
    pts = np.concatenate([uni, clu])
    h = 0.1  # the cell of this tree (10 cells a side)
    near = 0.5 + np.array([[1.6 * h, 0, 0], [0, 1.6 * h, 0],
                           [-1.5 * h, 0.2 * h, 0]], np.float32)
    return pts, np.concatenate([uni[:300], near]).astype(np.float32)


def _ghosts(pos, r, box=1.0):
    """The periodic clones, counted from the face masks in numpy."""
    for dim in range(3):
        hi = pos[:, dim] + r > box
        lo = pos[:, dim] - r < 0.0
        shifted = []
        for mask, shift in ((hi, -box), (lo, box)):
            p = pos[mask].copy()
            p[:, dim] += shift
            shifted.append(p)
        pos = np.concatenate([pos] + shifted)
        r = np.concatenate([r, r[hi], r[lo]])
    return pos, r


def _calls(device="cpu"):
    """One periodic render and one k-NN build and query on ``device``
    (the tile engine and the kernel route); returns the k-NN's queries."""
    pos, w, r = _render_inputs()
    renderer = PointRenderer(Container(device=device), GRID, GRID,
                             engine="cuda")
    renderer.render_points_volume(pos, w, r, GRID, PPU, (1.0, 1.0, 1.0))
    pts, q = _knn_inputs()
    tree = KDTree(torch.from_numpy(pts).to(device), boxsize=1.0)
    tree.query_device(torch.from_numpy(q).to(device), K, engine="kernel")
    return q


def _enclosing(event):
    """The name of the innermost ``nbodyhpc.`` range around a profiler
    event, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("nbodyhpc."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.fixture(scope="module")
def traced():
    profiling.reset()
    with torch.profiler.profile(activities=CPU) as prof:
        q = _calls()
    seen: dict = {}
    for e in prof.events():
        if e.name.startswith("nbodyhpc."):
            seen.setdefault(e.name, set()).add(_enclosing(e))
    return {"seen": seen, "records": profiling.records(),
            "counters": profiling.counters(), "queries": q,
            "ladder": kd.query_blocks_device.ladder_queries}


def test_spans_off_without_a_profiler(monkeypatch):
    """No profiler: no ``record_function``, no event, nothing stored; the
    counters count all the same."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered the profiler or made an event")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.reset()
    q = _calls()
    assert profiling.records() == [] and profiling.span_totals() == {}
    c = profiling.counters()
    assert c["knn.queries"] == len(q) and c["knn.plan_builds"] == 1
    assert c["render.particles"] > 0 and c["render.chunks"] > 0
    assert "profiling.dropped" not in c


@pytest.mark.parametrize("name", sorted(PARENT))
def test_profiler_shows_each_span_in_its_parent(traced, name):
    assert traced["seen"].get(name) == {PARENT[name]}


def test_store_parents_and_call_ids(traced):
    recs = traced["records"]
    assert {r.name for r in recs} == set(PARENT)
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        assert (parent and parent.name) == PARENT[r.name], r.name
        if parent is not None:
            assert parent.call == r.call
        assert r.host_end_ns >= r.host_start_ns and r.events is None
    calls: dict = {}
    for r in recs:
        root = r
        while root.parent is not None:
            root = recs[root.parent]
        calls.setdefault(root.name, set()).add(r.call)
    # one call id for each public call: the render, the build, the query
    assert set(calls) == {"nbodyhpc.render", "nbodyhpc.knn.build",
                          "nbodyhpc.knn.query"}
    assert all(len(ids) == 1 for ids in calls.values())
    assert len(set.union(*calls.values())) == 3


def test_render_counters_equal_counts_made_apart(traced):
    pos, w, r = _render_inputs()
    gpos, gr = _ghosts(pos, r)
    c = traced["counters"]
    assert c["render.ghost_rows"] == len(gpos) - len(pos) > 0
    assert c["render.particles"] == len(gpos)
    assert c["render.dense_rows"] == int((gr * np.float32(PPU) > 15).sum())
    assert c["render.dense_rows"] == 2
    part = sc.prepartition(torch.from_numpy(gpos), torch.ones(len(gpos)),
                           torch.from_numpy(gr), PPU, (GRID,) * 3)
    streams = [sc.bucket_stream(part, bi) for bi in range(len(sc.BUCKETS))]
    assert c["render.chunks"] == sum(s[2] for s in streams if s is not None)


def test_knn_counters_equal_counts_made_apart(traced):
    c, recs = traced["counters"], traced["records"]
    assert c["knn.queries"] == len(traced["queries"])
    assert c["knn.ladder_queries"] == traced["ladder"] >= 1
    assert c["knn.plan_builds"] == 1
    assert c["knn.rungs"] == sum(r.name == "nbodyhpc.knn.rung" for r in recs)
    assert 1 <= c["knn.brute_rows"] <= c["knn.ladder_queries"]
    pts, q = _knn_inputs()
    tree = KDTree(torch.from_numpy(pts), boxsize=1.0, device="cpu")._tree
    st = kd._stage_sort(tree, kd.tree_plan(tree), torch.from_numpy(q))
    assert c["knn.pieces"] == st.piece_q0.shape[0]


class _Clock:
    """A stand-in card: ``torch.cuda.Event`` reads a clock the test moves."""

    now = 0.0
    stream = types.SimpleNamespace(device="cuda")

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = _Clock.now

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def card_clock(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Clock)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Clock.stream)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    _Clock.now = 0.0
    profiling.reset()
    yield
    profiling.reset()


def _timed(name, ms, device=None, inside=()):
    """Open ``name`` for ``ms`` of the stand-in clock, ``inside`` (spans and
    their ms) after its first half."""
    with profiling.span(name, device):
        _Clock.now += ms / 2
        for child in inside:
            _timed(*child)
        _Clock.now += ms / 2


def _fill(calls: int = 2):
    """``calls`` renders and k-NN queries against the stand-in clock."""
    with torch.profiler.profile(activities=CPU):
        for _ in range(calls):
            _timed("nbodyhpc.render", 1.0, "cuda", [
                ("nbodyhpc.render.partition", 2.0),
                ("nbodyhpc.render.buckets", 3.0),
                ("nbodyhpc.render.dense", 4.0)])
            _timed("nbodyhpc.knn.query", 0.5, "cuda", [
                ("nbodyhpc.knn.plan", 1.5),
                ("nbodyhpc.knn.stage_sort", 2.5),
                ("nbodyhpc.knn.ladder", 3.5, None, [
                    ("nbodyhpc.knn.rung", 1.0)])])


def test_span_totals_device_and_self_time(card_clock):
    _fill(calls=2)
    t = profiling.span_totals()
    assert t["nbodyhpc.render"].count == 2
    assert t["nbodyhpc.render"].device_ms == pytest.approx(2 * 10.0)
    assert t["nbodyhpc.render"].device_self_ms == pytest.approx(2 * 1.0)
    assert t["nbodyhpc.knn.ladder"].device_ms == pytest.approx(2 * 4.5)
    assert t["nbodyhpc.knn.ladder"].device_self_ms == pytest.approx(2 * 3.5)
    assert t["nbodyhpc.knn.rung"].device_self_ms == pytest.approx(2 * 1.0)
    assert all(v.host_ms >= 0 for v in t.values())


def test_store_keeps_at_most_its_cap(card_clock, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    _fill(calls=1)
    assert [r.name for r in profiling.records()] == [
        "nbodyhpc.render", "nbodyhpc.render.partition",
        "nbodyhpc.render.buckets"]
    assert profiling.counters()["profiling.dropped"] == 6


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_per_call_mean(card_clock, monkeypatch, name):
    want = {"render.partition_ms": 2.0, "render.deposit_ms": 3.0,
            "render.dense_ms": 4.0, "knn.plan_ms": 1.5,
            "knn.stage_sort_ms": 2.5, "knn.ladder_ms": 4.5}
    read = _reader(name, monkeypatch)
    assert read(None) is None  # an empty store
    _fill(calls=3)
    assert read(None) == pytest.approx(want[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_without_a_public_call(card_clock, monkeypatch, name):
    span, _ = READERS[name]
    read = _reader(name, monkeypatch)
    with torch.profiler.profile(activities=CPU):
        _timed(span, 2.0, "cuda")
    assert read(None) is None


@pytest.mark.cuda
def test_device_ms_on_the_card():
    """On the card every span has device time, and each span's device time
    is at least its children's (event pairs on one stream nest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for sm_90a)")
    _calls("cuda")  # builds the kernels
    profiling.reset()
    with torch.profiler.profile(activities=CPU):
        _calls("cuda")
    totals = profiling.span_totals()
    assert set(totals) == set(PARENT)
    for name, t in totals.items():
        assert t.device_ms > 0, name
    recs = profiling.records()
    ms = [r.events[0].elapsed_time(r.events[1]) for r in recs]
    children = [0.0] * len(recs)
    for i, r in enumerate(recs):
        if r.parent is not None:
            children[r.parent] += ms[i]
    for i, r in enumerate(recs):
        # the event clock resolves about half a microsecond
        assert ms[i] >= children[i] - 1e-3, r.name
