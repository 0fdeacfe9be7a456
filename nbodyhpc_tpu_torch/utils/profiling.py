"""Profiling and observability helpers.

PyTorch port of :mod:`nbodyhpc_tpu.utils.profiling`. The reference's
observability is wall-clock printouts plus per-query statistics
(reference: kdtree CLI main.cpp:169-174; KDTreeQueryStatistics,
kdtree.hpp:124-131 — mirrored by :class:`nbodyhpc_tpu_torch.ops.knn.
QueryStatistics`). Added here: a ``torch.profiler`` trace (Chrome format,
viewable in Perfetto), the device's busy time of one call, and the spans
and counters the render and k-NN calls record at their layer boundaries.

**Spans** (:func:`span`) are named ``nbodyhpc.<layer>`` and nest: the
outermost span of a public call (``nbodyhpc.render``, ``nbodyhpc.knn.query``,
``nbodyhpc.knn.build``) gives its call id to every span inside it. A span is
off unless a ``torch.profiler`` session is recording (:func:`trace`, or any
``torch.profiler.profile``); off, it costs one check of the profiler's flag.
On, it is a ``record_function`` range in the profiler's own timeline, a pair
of CUDA timing events when its work is on a card (on the stream current when
the call's outermost span opened), and a record in memory (at most :data:`MAX_RECORDS`; the rest are counted under
``profiling.dropped``). :func:`span_totals` reads the records, :func:`reset`
clears them.

**Counters** (:func:`count`) are always on: each adds a number the host
already holds, so neither a counter nor a span adds a device sync.
:func:`counters` returns a snapshot. While a profiler records, a kernel
may also count on the card, into a tensor of :func:`device_counts`; only
:func:`counters` reads it back.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: spans kept in memory at most; later ones count under ``profiling.dropped``
MAX_RECORDS = 65_536

_OFF = contextlib.nullcontext()
_records: list = []
_counters: dict = {}
_device: dict = {}  # (names, device) -> [int64 tensor, written since read]
_lock = threading.Lock()
_open = threading.local()
_calls = itertools.count()


class SpanRecord(NamedTuple):
    """One stored span: ``parent`` is the index of the enclosing span in the
    same list (None for a call's outermost span, or a parent not stored);
    host times are ``time.perf_counter_ns``; ``events`` the CUDA timing
    event pair, or None for work off the card."""

    name: str
    call: int
    parent: int | None
    host_start_ns: int
    host_end_ns: int | None
    events: tuple | None


class SpanTotal(NamedTuple):
    """Sums over the stored spans of one name. ``device_ms`` is the event
    pairs' elapsed time, ``device_self_ms`` that less what their child spans
    cover; both None where no span of the name ran on a card."""

    count: int
    host_ms: float
    device_ms: float | None
    device_self_ms: float | None


class _Span:
    __slots__ = ("name", "call", "parent", "stream", "t0", "t1", "events",
                 "_range")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = device  # resolved to a CUDA stream or None on entry
        self.events = None
        self.t1 = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = self.parent = stack[-1] if stack else None
        self.call = next(_calls) if parent is None else parent.call
        # a stream is looked up once per call (7-10 us a lookup on an H100
        # host), and the call's inner spans time on it
        if self.stream is not None:
            self.stream = (torch.cuda.current_stream(self.stream)
                           if torch.device(self.stream).type == "cuda"
                           else None)
        elif parent is not None:
            self.stream = parent.stream
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter_ns()
        if len(_records) < MAX_RECORDS:
            _records.append(self)
        else:
            count("profiling.dropped")
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _open.stack.pop()
        self._range.__exit__(*exc)
        self._range = None
        return False


def span(name: str, device=None):
    """Context manager marking one layer of a call (see the module's
    docstring). ``device``: where the span's work runs; None takes the
    enclosing span's. Off unless a ``torch.profiler`` session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number, never a tensor) to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def device_counts(names, device):
    """While a ``torch.profiler`` session records: an int64 tensor on
    ``device``, one entry a name of ``names``, into which a kernel adds its
    counts; the same tensor for the same names and device. :func:`counters`
    adds what it holds to those counters and zeroes it. None when nothing
    records: the kernel then counts nothing, and no call reads the card."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    key = (tuple(names), torch.device(device))
    with _lock:
        slot = _device.get(key)
        if slot is None:
            slot = _device[key] = [
                torch.zeros(len(key[0]), dtype=torch.int64, device=device),
                False]
        slot[1] = True
        return slot[0]


def counters() -> dict:
    """A snapshot of every counter: {name: total}. Reads back the tensors of
    :func:`device_counts` written since the last read (waiting for the
    kernels that write them), and only those."""
    with _lock:
        due = [(key[0], slot[0]) for key, slot in _device.items() if slot[1]]
        for slot in _device.values():
            slot[1] = False
    for names, values in due:
        for name, v in zip(names, values.tolist()):
            count(name, v)
        values.zero_()
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear the stored spans and the counters."""
    with _lock:
        _records.clear()
        _counters.clear()
        _device.clear()


def records() -> list:
    """The stored spans as :class:`SpanRecord`, in the order they opened."""
    recs = list(_records)
    where = {id(r): i for i, r in enumerate(recs)}
    return [SpanRecord(r.name, r.call,
                       (None if r.parent is None
                        else where.get(id(r.parent))),
                       r.t0, r.t1, r.events) for r in recs]


def span_totals() -> dict:
    """{name: :class:`SpanTotal`} over the closed spans stored. Waits once
    for each card that holds a span's events."""
    recs = [r for r in _records if r.t1 is not None]
    for dev in {r.stream.device for r in recs if r.events}:
        torch.cuda.synchronize(dev)
    dev_ms = {id(r): r.events[0].elapsed_time(r.events[1])
              for r in recs if r.events}
    child_ms: dict = {}
    for r in recs:
        if r.parent is not None and id(r) in dev_ms:
            key = id(r.parent)
            child_ms[key] = child_ms.get(key, 0.0) + dev_ms[id(r)]
    sums: dict = {}
    for r in recs:
        n, host, dev, own = sums.get(r.name, (0, 0.0, None, None))
        if id(r) in dev_ms:
            ms = dev_ms[id(r)]
            dev = (dev or 0.0) + ms
            own = (own or 0.0) + ms - child_ms.get(id(r), 0.0)
        sums[r.name] = (n + 1, host + (r.t1 - r.t0) / 1e6, dev, own)
    return {name: SpanTotal(*v) for name, v in sums.items()}


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the scope with ``torch.profiler``: CPU activity, and CUDA
    activity when a card is present. On exit writes the Chrome trace
    ``trace.json`` into ``logdir`` (created if missing; ``None``: a new
    directory under the temporary directory). Yields ``logdir``."""
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="nbodyhpc_trace_")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield logdir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def synced(fn):
    """(fn(), wall ms) with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_busy_ms(fn, top: int = 6):
    """(device busy ms, wall ms, the ``top`` device activities by ms) of one
    ``fn()`` under ``torch.profiler``. Busy time is the union of the
    intervals of the device's kernels, copies and fills; wall time is the
    same call's, the device drained before and after. The profiler also
    reports each operator's span on the device as an annotation around its
    kernels; those would count the kernels twice and are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_ms = synced(fn)
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e3
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    rows = sorted(((ms, name) for name, ms in by_name.items()), reverse=True)
    return (busy_us / 1e3, wall_ms,
            {name[:48]: round(ms, 3) for ms, name in rows[:top]})
