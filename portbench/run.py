"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` the trace's
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without the cards, or
without the port beside this folder, it exits with an error and no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _num(v):
    return v if math.isfinite(v) else repr(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    bench = harness.benchmark()
    chips = harness.cell_spec(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload, bench)
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROCESS)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    correct = res["failed"] == 0 and all(
        v <= lim for _, v, lim in res["checks"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device["busy_s"] = res["extra"]["busy_s"]
        device["window_s"] = res["extra"]["window_s"]
        line["breakdown"] = res["extra"]["breakdown"]
    line["checks"] = {name: {"value": _num(v), "limit": lim}
                      for name, v, lim in res["checks"]}
    print("seconds: " + ", ".join(f"{k} {v!r}" for k, v in
                                  res["host"]["phases"].items()),
          file=sys.stderr)
    times = sorted(res["host"]["times"])
    print(f"steps {len(times)} in {res['host']['window_s']!r} s: step "
          f"seconds min {times[0]!r} median {times[len(times) // 2]!r} "
          f"max {times[-1]!r}", file=sys.stderr)
    for name, v, lim in res["checks"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
