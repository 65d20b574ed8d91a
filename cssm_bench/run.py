"""Run one cell of the benchmark of composablestatespacemodels_torch.

    python3 -m cssm_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The run:

1. finds the cell's configuration, traffic mix and driver by name
   (:mod:`cssm_bench.cell`) and refuses to run without enough cards;
2. set-up: the driver builds the model through the port's public API,
   simulates the cell's series from ``--seed``, and warms up every shape
   the traffic uses (the port compiles its kernels at the first call, into
   its ``_build/`` inside the checkout); ``setup_s`` runs from the start
   of this module to the first timed unit;
3. the window: closed-loop units (a call, an observation, a fit of MH
   iterations), each ending in a host read, until ``--seconds`` have
   passed; with ``--trace 1`` the traffic's ``trace_units`` units run
   under ``torch.profiler`` first, and the untraced window follows;
4. reads the memory peak, frees the program's state, and decides
   ``correct`` by the driver's comparison with the plain reference
   (``reference/``), each number against the limit in the traffic file;
   it refuses to report if JAX or the JAX package were loaded;
5. prints the end-to-end metrics (``--trace 0``) or the per-layer metrics
   (``--trace 1``), each read by ``metrics/<name>.py``, as one JSON line,
   the last line of standard output; the numbers compared, each beside
   its limit, are the last lines of standard error and the last key of
   that line.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "composablestatespacemodels_tpu")


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def log(msg: str) -> None:
    print(f"[cssm_bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run of one cell: what the driver, the metrics and the check
    share.  ``units`` holds one record per unit of the window: ``t0``,
    ``t1`` (host clock), ``traced`` and the driver's payload."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, root: Path = ROOT, traffic: dict = None):
        from . import cell
        self.bench = cell.benchmark(root)
        self.cell = cell.workload(self.bench, workload)
        self.name = workload
        self.seed, self.seconds, self.traced = int(seed), seconds, trace
        self.config = cell.load_json("configs", self.cell["config"])
        self.traffic = (traffic if traffic is not None
                        else cell.load_json("traffic", self.cell["traffic"]))
        self.driver = cell.driver(self.traffic["driver"])
        self.state: dict = {}
        self.units: list = []
        self.probes: dict = {}
        self.trace = None
        self.setup_s = None
        self.device = None
        self.kind = None
        self.log = log

    def phase(self, what: str) -> None:
        """Log a phase of set-up that has just ended, with the seconds
        since the start of this module."""
        log(f"set-up {time.perf_counter() - _T0:8.3f} s: {what}")

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def untraced(self) -> list:
        return [u for u in self.units if not u["traced"]]

    def window_s(self, units=None) -> float:
        units = self.untraced() if units is None else units
        return units[-1]["t1"] - units[0]["t0"] if units else 0.0


def _window(run: Run):
    """The measured window; returns the profiler of the traced units."""
    drv, prof = run.driver, None
    gc.collect()      # set-up's garbage, before the window
    run.setup_s = time.perf_counter() - _T0
    i = 0

    def unit(traced):
        nonlocal i
        t0 = time.perf_counter()
        payload = drv.unit(run, i)
        t1 = time.perf_counter()
        run.units.append({"t0": t0, "t1": t1, "traced": traced,
                          **(payload or {})})
        i += 1
        return t1

    if run.traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(int(run.traffic["trace_units"])):
                    unit(True)
    t_first = time.perf_counter()
    while True:
        if unit(False) - t_first >= run.seconds:
            break
    return prof


def _metrics(run: Run, entries: list) -> dict:
    from . import cell
    out = {}
    for m in entries:
        value = cell.metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def choose_device(run: Run, need_devices: bool) -> bool:
    """The run's device: card 0 where the cell's cards are there (False
    where they are not), the CPU where ``need_devices`` is off."""
    import torch
    if not need_devices:
        run.device, run.kind = torch.device("cpu"), "cpu"
        return True
    chips = int(run.cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        log(f"needs {chips} CUDA device(s); found {found}")
        return False
    run.device = torch.device("cuda", 0)
    run.kind = torch.cuda.get_device_name(0)
    torch.cuda.reset_peak_memory_stats(run.device)
    run.phase(f"card ready: {run.kind}")
    return True


def execute(run: Run, need_devices: bool = True) -> int:
    """The run, up to and including the result line; returns the exit
    code.  ``need_devices=False`` skips the look for cards (the tests run
    the rest on the CPU)."""
    import torch

    from . import cell
    run.phase("torch imported, files read")
    chips = int(run.cell["chips"])
    if not choose_device(run, need_devices):
        return 2
    log(f"workload {run.name} seed {run.seed} on {run.kind}; "
        f"config {run.cell['config']}, traffic {run.cell['traffic']}, "
        f"driver {run.traffic['driver']}")
    run.driver.setup(run)
    prof = _window(run)
    untraced = run.untraced()
    log(f"window: {len(run.units)} units in "
        f"{run.units[-1]['t1'] - run.units[0]['t0']:.3f} s "
        f"({len(untraced)} untraced); setup {run.setup_s:.3f} s")
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    per_layer = cell.metrics_of(run.bench, run.cell, per_layer=True)
    if run.traced:
        for m in per_layer:
            probe = getattr(cell.metric(m["name"]), "probe", None)
            if probe is not None:
                probe(run)
    run.driver.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = run.driver.check(run)
    limits = run.traffic["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    result = {"correct": correct, "attempted": len(run.units), "failed": 0}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": run.kind, "count": chips, "memory_peak_bytes": peak}
    if run.traced:
        from .trace import breakdown, from_profiler
        run.trace = from_profiler(prof)
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["metrics"] = _metrics(run, per_layer)
        result["device"] = device
        result["breakdown"] = breakdown(run.trace)
    else:
        result["metrics"] = _metrics(
            run, cell.metrics_of(run.bench, run.cell, per_layer=False))
        result["device"] = device
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log(f"refusing to report: loaded {', '.join(found)}")
        return 3
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(ROOT)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace))
    return execute(run)


if __name__ == "__main__":
    sys.exit(main())
