"""The traced run's records, read from ``torch.profiler``'s device trace.

The harness wraps its window in ``portbench.window`` and each public call in
a ``portbench.<layer>`` range (``torch.profiler.record_function``), each
closed by a synchronize, so a device activity belongs to the span whose
interval holds it. The per-layer readers in ``metrics/`` take a
:class:`Records` and nothing else.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"
TOP = 10


@dataclass
class Records:
    """What one run recorded: device activities and host spans (ns on the
    profiler's clock), the window, the steps' counters, and the cell's sizes.
    ``device`` holds (name, kind, start, end) with kind "kernel", "copy_h2d",
    "copy_d2h", "copy" or "memset", ``host`` the main thread's host ranges
    (start, end, name), the benchmark's own spans among them."""

    params: dict
    steps: list = field(default_factory=list)
    device: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    host: list = field(default_factory=list)
    window: tuple = (0, 0)

    def in_spans(self, span: str, kinds) -> list:
        """Seconds of device activity of ``kinds`` that started inside each
        ``span``, clipped to it."""
        starts = [e[2] for e in self.device]
        out = []
        for s0, s1 in self.spans.get(span, []):
            tot = 0
            for j in range(bisect.bisect_left(starts, s0),
                           bisect.bisect_left(starts, s1)):
                _, kind, t0, t1 = self.device[j]
                if kind in kinds:
                    tot += min(t1, s1) - t0
            out.append(tot / 1e9)
        return out

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return sum(b - a for a, b in _union(self.device, self.window)) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "copy_h2d"
        if "DtoH" in name:
            return "copy_d2h"
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(device, window):
    """Merged intervals of the device activities, clipped to the window."""
    w0, w1 = window
    out = []
    for _, _, t0, t1 in device:  # sorted by start
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


@contextlib.contextmanager
def profiled(records: Records):
    """Profile the scope (host and device activity) and fill ``records``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host, main = [], None
    for e in events:
        name, t0, t1 = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                records.device.append((name, _kind(name), t0, t1))
            continue
        host.append((t0, t1, name, e.start_thread_id()))
        if name == WINDOW:
            records.window, main = (t0, t1), e.start_thread_id()
        elif name.startswith("portbench."):
            records.spans.setdefault(name[len("portbench."):], []).append(
                (t0, t1))
    records.host = sorted(h[:3] for h in host if h[3] == main)
    records.device.sort(key=lambda e: e[2])
    for v in records.spans.values():
        v.sort()


def breakdown(records: Records) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the window by the innermost host operation running across them."""
    by_op: dict = {}
    for name, _, t0, t1 in records.device:
        by_op[name] = by_op.get(name, 0) + (t1 - t0)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    busy = _union(records.device, records.window)
    edges = [records.window[0]] + [t for iv in busy for t in iv] + [
        records.window[1]]
    # each gap goes to the innermost host operation open at its middle: a
    # sweep over the main thread's nested ranges, gaps in order of middle
    by_host: dict = {}
    host, j, stack = records.host, 0, []
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        what = stack[-1][2] if stack else "(no host operation)"
        by_host[what] = by_host.get(what, 0) + (g1 - g0)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:96], t / 1e9] for n, t in ops],
            "idle_gaps": [[n[:96], t / 1e9] for n, t in idle]}
