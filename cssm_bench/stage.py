"""A cell that ``BENCHMARK.json`` does not list yet, run as a listed one.

    python3 -m cssm_bench.stage <stage> run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> [--set key=value ...]
    python3 -m cssm_bench.stage <stage> calibrate --workload <name> \
        --seeds 101 102 ... [--control 3] [--faults [name ...]] \
        [--fault-seeds 3] [--fault-seconds <s>] --seconds <s> \
        [--set key=value ...] --out <file>

``staged/<stage>.json`` holds what the cell will add to ``BENCHMARK.json``:
its ``configs``, ``workloads`` and ``per_layer`` entries, and under
``end_to_end_cells`` the cells to add to each end-to-end metric's
``workloads``.  :func:`merged` is ``BENCHMARK.json`` with them added;
``run`` writes it to a fresh directory under ``TMPDIR`` and runs the cell
there exactly as ``run.py`` runs a listed one, with the caches inside the
checkout.  ``calibrate`` records, in one process, the numbers the cell's
check compares, as ``calibrate.py`` does for a listed cell: on every seed,
the control's on the first ``--control`` seeds, each fault's on the first
``--fault-seeds`` with a window of ``--fault-seconds``.  In both modes
``--set`` overrides traffic keys (values as JSON).  A driver whose set-up
starts other ranks keeps them for every reading.
"""

from __future__ import annotations

from . import run as _run  # noqa: I001  (the set-up clock starts here)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

from . import cell  # noqa: E402

STAGED = cell.HERE / "staged"


def merged(stage: str, bench: dict = None) -> dict:
    """``BENCHMARK.json`` (or ``bench``) with the staged entries added."""
    bench = json.loads(json.dumps(bench or cell.benchmark()))
    with open(STAGED / f"{stage}.json") as f:
        extra = json.load(f)
    for key in ("configs", "workloads", "per_layer"):
        bench[key] = bench[key] + extra.get(key, [])
    for name, cells in extra.get("end_to_end_cells", {}).items():
        for m in bench["end_to_end"]:
            if m["name"] == name:
                m["workloads"] = m["workloads"] + cells
    return bench


def write_root(stage: str, where: Path) -> Path:
    """A directory holding the merged ``BENCHMARK.json``."""
    where.mkdir(parents=True, exist_ok=True)
    with open(where / "BENCHMARK.json", "w") as f:
        json.dump(merged(stage), f, indent=1)
    return where


def _reading(root: Path, workload: str, seed: int, seconds: float,
             control: bool, fault, over: dict, ranks,
             need_devices: bool = True) -> dict:
    import torch
    from . import faults
    run = _run.Run(workload, seed, seconds, False, root=root)
    run.traffic.update(over)
    _run.choose_device(run, need_devices)
    if ranks is not None:
        run.state["ranks"] = ranks
    t = time.perf_counter()
    with (faults.planted(run, fault) if fault else contextlib.nullcontext()):
        run.driver.setup(run)
        _run._window(run)
        ranks = run.state.get("ranks")
        run.state["keep_ranks"] = True
        run.driver.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "fault": fault, "units": len(run.units),
           "numbers": run.driver.check(run)}
    if control:
        out["control"] = run.driver.control(run)
    out["readings"] = run.state.get("ring_readings")
    out["seconds"] = time.perf_counter() - t
    _run.log(json.dumps(out))
    return out, ranks


def _overrides(args) -> dict:
    return {k: json.loads(v) for k, v in
            (s.split("=", 1) for s in args.set or [])}


def calibrate(root: Path, args) -> int:
    over = _overrides(args)
    fault_s = args.seconds if args.fault_seconds is None else args.fault_seconds
    plan = [(s, k < args.control, None, args.seconds)
            for k, s in enumerate(args.seeds)]
    if args.faults is not None:
        every = cell.driver(cell.load_json("traffic", cell.workload(
            cell.benchmark(root), args.workload)["traffic"])["driver"]).FAULTS
        n = args.control if args.fault_seeds is None else args.fault_seeds
        plan += [(s, False, f, fault_s) for f in args.faults or every
                 for s in args.seeds[:n]]
    rows, ranks = [], None
    try:
        for seed, control, fault, seconds in plan:
            row, ranks = _reading(root, args.workload, seed, seconds,
                                  control, fault, over, ranks, not args.cpu)
            rows.append(row)
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    finally:
        if ranks is not None:
            _run.log(f"ranks' exit codes {ranks.stop(60.0)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage")
    ap.add_argument("mode", choices=("run", "calibrate"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seeds", type=int, nargs="+")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--fault-seeds", type=int, default=None)
    ap.add_argument("--fault-seconds", type=float, default=None)
    ap.add_argument("--set", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--cpu", action="store_true",
                    help="calibrate on the CPU (a rehearsal at small sizes)")
    args = ap.parse_args(argv)
    _run._cache_dirs(_run.ROOT)
    root = write_root(args.stage, Path(tempfile.mkdtemp(prefix="cssm-stage-")))
    try:
        if args.mode == "calibrate":
            return calibrate(root, args)
        run = _run.Run(args.workload, args.seed, args.seconds,
                       bool(args.trace), root=root)
        run.traffic.update(_overrides(args))
        return _run.execute(run)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
