"""Profiling and observability helpers.

PyTorch port of :mod:`nbodyhpc_tpu.utils.profiling`. The reference's
observability is wall-clock printouts plus per-query statistics
(reference: kdtree CLI main.cpp:169-174; KDTreeQueryStatistics,
kdtree.hpp:124-131 — mirrored by :class:`nbodyhpc_tpu_torch.ops.knn.
QueryStatistics`). Added here: a ``torch.profiler`` trace (Chrome format,
viewable in Perfetto) and the device's busy time of one call.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


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


@contextlib.contextmanager
def timer(label: str = "", sink=print):
    """Wall-clock scope (the reference CLIs' timing printouts)."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0
        if label:
            sink(f"{label}: {box['seconds']:.3f} s")


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
