"""Readings that the output check's limits are set from, at a cell's size.

    python3 portbench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 10 --first-seed <n> [--fault <kind>]

For each of ``--seeds`` seeds the program runs a window of ``--seconds``
as a benchmark run does and its numbers are checked; for each of
``--control-seeds`` seeds the plain reference, computed in bfloat16 (the
precision below the configurations' float32), stands in for the program.
With ``--fault``, the program runs with that fault (``harness.FAULTS``)
planted by the step kind's ``plant_fault``. One JSON line per seed, then the largest and the smallest reading
of the program and the smallest of the control for each number. Needs the
cell's card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31)
    ap.add_argument("--fault", choices=("altered", "half"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    if args.fault:
        cell.kind.plant_fault(args.fault)
    program, control = {}, {}
    seeds = [args.first_seed + j for j in range(args.seeds
                                                + args.control_seeds)]
    for j, seed in enumerate(seeds):
        side = "program" if j < args.seeds else "control"
        label = f"fault {args.fault}" if args.fault and j < args.seeds else side
        t0 = time.perf_counter()
        step = cell.step(seed, "cuda")
        steps = 0
        if side == "program":
            step.warm()
            steps = harness.window(step, args.seconds, "cuda")["steps"]
            checks, failed = step.check(cell.limits)
        else:
            checks, failed = step.check(cell.limits, control=torch.bfloat16)
        del step
        torch.cuda.empty_cache()
        out = program if side == "program" else control
        for name, v, _ in checks:
            out.setdefault(name, []).append(v)
        print(json.dumps({"seed": seed, "side": label, "steps": steps,
                          "failed": failed,
                          "checks": {n: v for n, v, _ in checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "program_max": {n: max(v) for n, v in program.items()},
                      "program_min": {n: min(v) for n, v in program.items()},
                      "control_min": {n: min(v) for n, v in control.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
