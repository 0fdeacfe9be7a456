"""Run one cell of ``BENCHMARK.json`` once, and judge what its window made.

A cell names a configuration (its ``file``, ``configs/<config>.json``:
sizes, source and its input generator ``inputs/<generator>.py``) and a traffic mix
(``traffic/<mix>.json``: the step kind ``steps/<step>.py`` and its
parameters). Its limits for the output check are in
``workloads/<cell>.json``. The metrics are ``metrics/<metric>.py``, each a
``read(records)`` that returns a number or ``None``. All are found by the
names in ``BENCHMARK.json``; nothing here names a cell.

A run: set-up (inputs made from the seed, each input set's shapes warmed
up), then whole steps until ``seconds`` have passed (a traced run:
``TRACE_SECONDS`` at most), each step alternating between the two input
sets, then (after the peak memory is read and the device's cached memory
freed) the check of what the window returned against the plain reference
in ``reference/``. A step kind (``steps/<kind>.py``) is a class ``Step``
with ``warm()``, ``run(i)`` (returns the work done: particles or
queries), ``counters()``, ``params()`` and ``check(limits, control)``;
the module also has ``plant_fault(kind)`` for the check's tests.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nbodyhpc_tpu")
# faults that a step kind's ``plant_fault(kind)`` plants in the call it
# drives: an answer altered where it is produced, half of the batch left out
FAULTS = ("altered", "half")
# the traced window's length at most: reading a trace costs about twice the
# traced time (a k=16 window of 15 s holds 2.1M host and device events)
TRACE_SECONDS = 15.0


def load_module(path: Path):
    """Import a file of the benchmark by its path (its name may hold dots
    and dashes)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries this cell reports: those that
    list it under ``workloads``, or without that key every cell (end to
    end) and every cell that reports the metric it moves (per layer)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def step_seed(seed: int, i: int) -> int:
    """A seed for step ``i`` of a run seeded ``seed`` (any whole number)."""
    return (int(seed) * 1_000_003 + i) % (1 << 62)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Cell:
    """One cell's configuration, traffic, step kind and limits."""

    def __init__(self, name: str, bench: dict | None = None,
                 config: dict | None = None, traffic: dict | None = None,
                 limits: dict | None = None):
        self.bench = bench if bench is not None else benchmark()
        self.spec = cell_spec(self.bench, name)
        self.name = name
        entry = next(c for c in self.bench["configs"]
                     if c["name"] == self.spec["config"])
        self.config = config if config is not None else read_json(
            ROOT / entry["file"])
        self.traffic = traffic if traffic is not None else read_json(
            HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = limits if limits is not None else read_json(
            HERE / "workloads" / f"{name}.json")["limits"]
        self.generator = load_module(
            HERE / "inputs" / f"{self.config['generator']}.py")
        self.kind = load_module(HERE / "steps" / f"{self.traffic['step']}.py")

    def step(self, seed: int, device):
        """The cell's step object, its inputs made from ``seed``."""
        return self.kind.Step(self.config, self.traffic, self.generator,
                              seed, torch.device(device))


def window(step, seconds: float, device, records=None) -> dict:
    """Whole steps until ``seconds`` have passed; their host-clock times."""
    times, work = [], 0
    ctx = torch.profiler.record_function(trace.WINDOW)
    sync(device)
    with ctx:
        t_start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            work += step.run(i)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if records is not None:
                records.steps.append(step.counters())
            i += 1
            if t1 - t_start >= seconds:
                break
        t_end = time.perf_counter()
    return {"steps": len(times), "work": work, "times": times,
            "window_s": t_end - t_start}


def loaded_forbidden(modules=None) -> list:
    """The top-level names of ``modules`` (default: every loaded module)
    that are JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> dict:
    """Set up, measure, check. Returns the result's fields and the list of
    (name, value, limit) compared."""
    step = cell.step(seed, device)
    step.warm()
    sync(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    records = trace.Records(params=step.params()) if traced else None
    if traced:
        with trace.profiled(records):
            host = window(step, min(seconds, TRACE_SECONDS), device, records)
    else:
        host = window(step, seconds, device)
    host["setup_s"] = setup_s
    host["unit"] = step.unit
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    # per-layer readers see the records; end-to-end readers the host clock
    e2e, layer = cell_metrics(cell.bench, cell.name)
    metrics = {}
    for m in (layer if traced else e2e):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        v = reader.read(records if traced else host)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra = {}
    if traced:
        extra = {"busy_s": records.busy_s(), "window_s": records.window_s(),
                 "breakdown": trace.breakdown(records)}
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = step.check(cell.limits)
    host["phases"] = {"setup": setup_s, "window": host["window_s"],
                      "metrics": t_check - t_window - host["window_s"],
                      "check": time.perf_counter() - t_check}
    return {"host": host, "metrics": metrics, "peak": peak, "extra": extra,
            "checks": checks, "failed": failed, "attempted": host["steps"]}
