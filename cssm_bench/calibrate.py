"""Readings from which the limits of a cell's check are set.

    python3 -m cssm_bench.calibrate --workload <name> --seeds 101 102 ... \
        --control 3 [--faults [name ...]] [--fault-seeds 3] [--seconds 25] \
        --out <file.json>

runs the cell once a seed in one process, as its runs do, and records the
numbers its check compares: the system's on every seed (the lower
readings), the control's, the reference in bfloat16 in the system's
place, on the first ``--control`` seeds (the upper readings), and with
``--faults`` the numbers under the planted faults named, or under every
fault of the cell's driver (its ``FAULTS``), on the first
``--fault-seeds`` seeds (as many as ``--control`` unless given).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import faults
from .run import Run, _window, choose_device, log


def reading(workload: str, seed: int, seconds: float, control: bool,
            fault: str = None, need_devices: bool = True) -> dict:
    import torch
    run = Run(workload, seed, seconds, False)
    choose_device(run, need_devices)
    t = time.perf_counter()
    if fault is None:
        run.driver.setup(run)
        _window(run)
    else:
        with faults.planted(run, fault):
            run.driver.setup(run)
            _window(run)
    run.driver.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "fault": fault, "units": len(run.units),
           "numbers": run.driver.check(run)}
    if control:
        out["control"] = run.driver.control(run)
    out["seconds"] = time.perf_counter() - t
    log(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--fault-seeds", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        from .cell import benchmark
        seconds = float(benchmark()["run_seconds"])
    rows = [reading(args.workload, s, seconds, k < args.control)
            for k, s in enumerate(args.seeds)]
    if args.faults is not None:
        every = Run(args.workload, 0, seconds, False).driver.FAULTS
        rows += [reading(args.workload, s, seconds, False, f)
                 for f in args.faults or every
                 for s in args.seeds[:args.control if args.fault_seeds is None
                                     else args.fault_seeds]]
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
